"""On the card only: each CUDA kernel of the port against its plain
PyTorch version at Leapfrog-2D shapes, the wrapper's refusals, the field
through the kernels, and one fit, clone and projection epoch through the
kernels against the dense path in float64. Skips without a GPU. Imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest reference entry for a kernel against its
plain version (f32 on the card: FMA contraction and another summation
order), 1e-5 for an epoch's losses and gradients, as stated at each
check."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.utils.seeded_state import leapfrog_state
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_centered as tk

from torch_parity import (EPOCH_KINDS, assert_epochs_agree,  # noqa: F401
                          cuda_device, one_epoch_runs)

pytestmark = pytest.mark.cuda


def _state(device):
    return leapfrog_state(device, seed=81)


def _inputs(device):
    mix, spec, x = _state(device)
    x_p, _, _, mu_p, pp_p, v_p, tmask = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=False)
    rng = np.random.RandomState(83)
    douts = [torch.as_tensor(rng.randn(512, 6).astype(np.float32),
                             device=device) for _ in range(2)]
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), douts, spec.clamp_threshold


def _close(got, want):
    """1e-4 of each output's largest reference entry."""
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("njac", [0, 2])
def test_fwd_matches_plain(cuda_device, njac):
    args, _, clamp = _inputs(cuda_device)
    _close([tk.gsr_fwd(*args, clamp, njac)],
           [tk.fwd_plain(*args, clamp, njac)])


@pytest.mark.parametrize("njac", [0, 2])
def test_bwd_dn_matches_plain(cuda_device, njac):
    args, douts, clamp = _inputs(cuda_device)
    dout = douts[0][:, :(1 + njac) * 2].contiguous()
    _close(tk.gsr_bwd_dn(*args, dout, clamp, njac),
           tk.bwd_dn_plain(*args, dout, clamp, njac))


@pytest.mark.parametrize("use_val", [True, False])
def test_bwd_dn2_matches_plain(cuda_device, use_val):
    args, douts, clamp = _inputs(cuda_device)
    got = tk.gsr_bwd_dn2(*args, *douts, clamp, 2, use_val=use_val)
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 2, use_val=use_val)
    _close(got[0] + got[1], want[0] + want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    (tmask, x, muT, ppT, v), _, clamp = _inputs(cuda_device)
    with pytest.raises(ValueError):          # not contiguous
        tk.gsr_fwd(tmask, x, muT, ppT, torch.cat([v, v], 1)[:, ::2], clamp,
                   2)
    with pytest.raises(ValueError):          # operands on two devices
        tk.gsr_fwd(tmask, x, muT.cpu(), ppT, v, clamp, 2)
    with pytest.raises(ValueError):          # mask built for other tiles
        tk.gsr_fwd(tmask[::2].contiguous(), x, muT, ppT, v, clamp, 2)
    with pytest.raises(ValueError):          # wrong dtype
        tk.gsr_fwd(tmask.float(), x, muT, ppT, v, clamp, 2)


def test_field_through_kernels_matches_dense(cuda_device):
    mix, spec, x = _state(cuda_device)
    tk.reset_launches()
    with torch.no_grad():
        v, j = tf.value_and_jac(mix, spec, x)
        vd, jd = tf.value_and_jac_dense(mix, spec, x)
    assert tk.launches["gsr_fwd"] == 1
    # the dense form's expanded quadratic cancels ~1e-5 of the largest
    # entry at these scales (docs/KERNELS.md)
    for g, w in ((v, vd), (j, jd)):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


KERNELS_OF_EPOCH = {
    "fit": ("gsr_fwd", "gsr_bwd_dn"),
    "clone": ("gsr_fwd", "gsr_bwd_dn"),
    "project": ("gsr_fwd", "gsr_bwd_dn", "gsr_bwd_dn2"),
    "project_ref": ("gsr_fwd", "gsr_bwd_dn", "gsr_bwd_dn2"),
}


@pytest.mark.parametrize("kind", EPOCH_KINDS)
def test_epoch_through_kernels_matches_dense_f64(cuda_device, monkeypatch,
                                                 kind):
    """One epoch on an unsorted batch through the kernels (with the
    epoch's sorts of the batch, its targets and the boundary batch) against
    the same epoch through the dense path in float64, which never sorts,
    and against the kernels on the batch handed in sorted. Losses and
    gradients within 1e-5 of the largest reference entry."""
    kern, kern_sorted, dense = one_epoch_runs(
        kind, cuda_device, monkeypatch,
        [("centered", False), ("centered", True), ("dense64", False)])
    assert all(kern[2][k] > 0 for k in KERNELS_OF_EPOCH[kind]), kern[2]
    assert not any(dense[2].values()), dense[2]
    assert_epochs_agree(kern, dense, 1e-5)
    assert_epochs_agree(kern, kern_sorted, 1e-5)
