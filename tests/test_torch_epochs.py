"""One fit, clone re-fit and projection epoch of the port on the CPU,
through the centered path (the kernels' plain twins, with the epoch's
sorts of the batch, the covector target and the boundary batch) against
the dense path in float64, which never sorts, and against the centered
path on the batch handed in already sorted. A sort that moved a batch but
not what belongs to it would show here. Losses and gradients within 1e-5
of the largest reference entry. The card runs the same check through the
CUDA kernels (tests/test_torch_cuda.py)."""

import pytest
import torch

from torch_parity import EPOCH_KINDS, assert_epochs_agree, one_epoch_runs


@pytest.mark.parametrize("kind", EPOCH_KINDS)
def test_epoch_sorts_keep_batches_aligned(monkeypatch, kind):
    unsorted, presorted, dense = one_epoch_runs(
        kind, torch.device("cpu"), monkeypatch,
        [("centered", False), ("centered", True), ("dense64", False)])
    assert_epochs_agree(unsorted, dense, 1e-5)
    assert_epochs_agree(unsorted, presorted, 1e-5)
