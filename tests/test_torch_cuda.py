"""On the card only: each CUDA kernel of the port against its plain
PyTorch version — the centered kernels at Leapfrog-2D shapes and at d = 3,
the work-list (cells) kernels at Ring-Collide shapes (B = 8192, N =
75,776), with their overflow branch — the wrappers' refusals, the field
through the kernels, and one fit, clone and projection epoch, 2D and 3D,
through the kernels against the dense path in float64. Skips without a
GPU. Imports neither JAX nor the JAX package, so it runs on the card's
machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest reference entry for a kernel against its
plain version (f32 on the card: FMA contraction and another summation
order), 1e-5 for an epoch's losses and gradients, as stated at each
check."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.utils.seeded_state import (leapfrog_state,
                                                      ring_collide_state)
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_cells as tc
from gaussian_fluids_torch.ops import gsr_centered as tk

from torch_parity import (EPOCH_KINDS, EPOCH_KINDS_3D,  # noqa: F401
                          assert_epochs_agree, cuda_device, one_epoch_runs,
                          one_epoch_runs_3d)

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


# ---- d = 3 and the cells kernels, at Ring-Collide shapes ----

def _inputs_3d(device):
    mix, spec, x = ring_collide_state(device, seed=84)
    x_p, _, tmask, lists = tf._cells_prep(mix, spec, x)
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tc.TN)
    rng = np.random.RandomState(85)
    douts = [torch.as_tensor(rng.randn(x_p.shape[0], 12).astype(np.float32)
                             / 8192, device=device) for _ in range(2)]
    return (lists, (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
                    v_p.contiguous()), douts, spec.clamp_threshold)


@pytest.mark.parametrize("njac", [0, 3])
def test_fwd_kernels_d3_match_plain(cuda_device, njac):
    (rows, cols, _, _, ok), args, _, clamp = _inputs_3d(cuda_device)
    assert int(ok) == 1
    want = [tk.fwd_plain(*args, clamp, njac)]
    _close([tk.gsr_fwd(*args, clamp, njac)], want)
    _close([tc.cells_fwd(rows, cols, ok, *args, clamp, njac)], want)


@pytest.mark.parametrize("njac", [0, 3])
def test_bwd_dn_kernels_d3_match_plain(cuda_device, njac):
    (_, _, gt, qt, ok), args, douts, clamp = _inputs_3d(cuda_device)
    dout = douts[0][:, :(1 + njac) * 3].contiguous()
    want = tk.bwd_dn_plain(*args, dout, clamp, njac)
    _close(tk.gsr_bwd_dn(*args, dout, clamp, njac), want)
    _close(tc.cells_bwd_dn(gt, qt, ok, *args, dout, clamp, njac), want)


@pytest.mark.parametrize("use_val", [True, False])
def test_bwd_dn2_kernels_d3_match_plain(cuda_device, use_val):
    (_, _, gt, qt, ok), args, douts, clamp = _inputs_3d(cuda_device)
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 3, use_val=use_val)
    got = tk.gsr_bwd_dn2(*args, *douts, clamp, 3, use_val=use_val)
    _close(got[0] + got[1], want[0] + want[1])
    got = tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, clamp, 3,
                           use_val=use_val)
    _close(got[0] + got[1], want[0] + want[1])


def test_cells_overflow_branch_sweeps_the_mask(cuda_device):
    """Flagged as overflowed, every cells kernel ignores its (here
    truncated) list and sweeps the whole fine mask: the same result, and
    the device counter sees each such launch."""
    (rows, cols, gt, qt, ok), args, douts, clamp = _inputs_3d(cuda_device)
    bad = torch.zeros_like(ok)
    rows, cols, gt, qt = (a[:5].contiguous() for a in (rows, cols, gt, qt))
    tc.reset_launches()
    _close([tc.cells_fwd(rows, cols, bad, *args, clamp, 3)],
           [tk.fwd_plain(*args, clamp, 3)])
    _close(tc.cells_bwd_dn(gt, qt, bad, *args, douts[0], clamp, 3),
           tk.bwd_dn_plain(*args, douts[0], clamp, 3))
    got = tc.cells_bwd_dn2(gt, qt, bad, *args, *douts, clamp, 3)
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 3)
    _close(got[0] + got[1], want[0] + want[1])
    assert tc.overflows() == {k: 1 for k in tc.NAMES}
    assert tc.launches == {k: 1 for k in tc.NAMES}


def test_cells_field_dispatch_at_ring_collide(cuda_device):
    """At Ring-Collide width the need_dx=False evaluations take the cells
    kernels, the others the centered ones; both agree with the dense path
    in float64."""
    mix, spec, x = ring_collide_state(cuda_device, seed=86, n_queries=8192)
    m64 = tf.mixture_of({k: p.double() for k, p in mix.params().items()},
                        mix.alive)
    tk.reset_launches()
    tc.reset_launches()
    with torch.no_grad():
        vc, jc = tf.value_and_jac(mix, spec, x, need_dx=False)
        vk, jk = tf.value_and_jac(mix, spec, x)
        vd, jd = tf.value_and_jac_dense(m64, spec, x[:2048].double())
    assert tc.launches["cells_fwd"] == 1 and tk.launches["gsr_fwd"] == 1
    for got in ((vc, jc), (vk, jk)):
        for g, w in zip(got, (vd, jd)):
            assert float((g[:2048].double() - w).abs().max()) \
                <= 1e-4 * float(w.abs().max())


KERNELS_OF_EPOCH_3D = {
    "fit": ("cells_fwd", "cells_bwd_dn"),
    "clone": ("cells_fwd", "cells_bwd_dn"),
    "project": ("cells_fwd", "cells_bwd_dn", "cells_bwd_dn2"),
    "project_ref": ("cells_fwd", "cells_bwd_dn", "cells_bwd_dn2"),
}


@pytest.mark.parametrize("kind", EPOCH_KINDS_3D)
def test_epoch_3d_through_kernels_matches_dense_f64(cuda_device, monkeypatch,
                                                    kind):
    """One 3D epoch on an unsorted batch through the cells kernels and
    through the centered kernels at d = 3 (with the epoch's sorts)
    against the same epoch through the dense path in float64, which never
    sorts, and the cells kernels on the batch handed in sorted. Losses and
    gradients within 1e-5 of the largest reference entry."""
    cells, cells_sorted, centered, dense = one_epoch_runs_3d(
        kind, cuda_device, monkeypatch,
        [("cells", False), ("cells", True), ("centered", False),
         ("dense64", False)])
    assert all(cells[2][k] > 0 for k in KERNELS_OF_EPOCH_3D[kind]), cells[2]
    assert all(centered[2][k.replace("cells", "gsr")] > 0
               for k in KERNELS_OF_EPOCH_3D[kind]), centered[2]
    assert not any(dense[2].values()), dense[2]
    assert_epochs_agree(cells, dense, 1e-5)
    assert_epochs_agree(centered, dense, 1e-5)
    assert_epochs_agree(cells, cells_sorted, 1e-5)
