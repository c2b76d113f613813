"""The mesh launcher raises the failing rank's own error, not a peer's.

A rank that raises leaves its process group, which breaks the collective
its peer waits in; the peer then fails too, and
``torch.multiprocessing`` reports whichever failed process it reads
first. ``parallel.mesh.launch`` raises the earliest-caught error of the
ranks' records instead. Each case launches a (1, 2) gloo CPU mesh five
times and requires the failing rank's message and traceback every time.
"""

import pytest
import torch.multiprocessing as tmp

from gaussian_fluids_torch.parallel.mesh import launch

import torch_mesh_ranks as ranks

LAUNCHES = 5


def _launch(fn):
    return launch(fn, (1, 2), device="cpu", timeout=300, threads=1)


@pytest.mark.parametrize("fn, message, kind", [
    (ranks.failing_rank, "rank 1 failed", "RuntimeError"),
    (ranks.failing_rank_0, "rank 0 failed", "FloatingPointError"),
], ids=["rank1_raises", "rank0_raises"])
def test_launch_raises_the_failing_ranks_error(fn, message, kind):
    for _ in range(LAUNCHES):
        with pytest.raises(tmp.ProcessRaisedException) as info:
            _launch(fn)
        text = str(info.value)
        assert message in text and kind in text, text
        # the traceback is the rank's own: it names the raising function
        assert fn.__name__ in text, text
        assert "Connection reset" not in text, text
