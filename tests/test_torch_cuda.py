"""On the card only: each CUDA kernel of the port against its plain
PyTorch version — the centered kernels at Leapfrog-2D shapes and at d = 3,
the work-list (cells) kernels at Ring-Collide shapes (B = 8192, N =
75,776), with their overflow branch, and the banded value kernel of the
density replay at its production chunk (262,144 grid nodes), with its
guard's full sweep — the wrappers' refusals, the field through the
kernels, one fit, clone and projection epoch, 2D and 3D, through the
kernels against the dense path in float64, and the replay's RK4 backtrace
through the banded kernel against the dense one in float64. Skips without a
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
from gaussian_fluids_torch.ops import gsr_banded as tb
from gaussian_fluids_torch.ops import gsr_cells as tc
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.solver import simulate3d as tsim
from gaussian_fluids_torch.utils.grids import axis_nodes

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


# ---- the banded value kernel of the density replay ----

def _plane(device, x0, n=512):
    """The n^2 nodes of one x-plane of the n^3 grid over [0, 1]^3: one
    production chunk of the replay at n = 512."""
    g = torch.as_tensor(axis_nodes(0.0, 1.0, n), device=device)
    Y, Z = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([torch.full_like(Y, x0), Y, Z], -1).reshape(-1, 3)


def _banded(device, seed=87):
    mix, spec, _ = ring_collide_state(device, seed=seed)
    mix = mix.x_sorted()
    return mix, spec, tf.banded_prep(mix, spec), \
        tsim._suggest_band(mix, spec, 0.02)


def _banded_call(prep, x, band, kernel=True):
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    f = tb.gsr_value_banded if kernel else tb.value_banded_plain
    return f(jlo, ok, x, prep["muT"], prep["ppT"], prep["v"],
             prep["clamp"], band), int(ok)


@pytest.mark.parametrize("where", ["plane", "stage"])
def test_banded_kernel_matches_plain(cuda_device, where):
    """A 262,144-node chunk at Ring-Collide width, on the grid plane and
    moved as an RK4 stage moves it (x + dt/2 u, no longer one plane, not
    re-sorted): kernel and plain twin within 1e-4 of the largest entry."""
    mix, spec, prep, band = _banded(cuda_device)
    x = _plane(cuda_device, 0.4985)
    if where == "stage":
        u = tf.value_banded_prepped(prep, x, band, presorted=True)
        x = (x - 0.01 * u).contiguous()
    got, ok = _banded_call(prep, x, band)
    want, _ = _banded_call(prep, x, band, kernel=False)
    assert ok == 1
    assert float(want.abs().max()) > 0
    _close([got], [want])


def test_banded_guard_sweep_is_bitwise(cuda_device):
    """Band 1 fails the device guard: the kernel sweeps the whole axis,
    bitwise equal to the sufficient band's output, and counts it."""
    mix, spec, prep, band = _banded(cuda_device, seed=88)
    x = _plane(cuda_device, 0.25)
    tb.reset_launches()
    want, ok = _banded_call(prep, x, band)
    got, ok1 = _banded_call(prep, x, 1)
    assert (ok, ok1) == (1, 0)
    assert torch.equal(got, want)
    assert tb.guard_failures() == 1 and tb.launches["gsr_value_banded"] == 2


def test_banded_wrapper_refuses(cuda_device):
    mix, spec, prep, band = _banded(cuda_device)
    x = _plane(cuda_device, 0.5, n=64)
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    args = (prep["muT"], prep["ppT"], prep["v"], prep["clamp"])
    with pytest.raises(ValueError):          # starts for other tiles
        tb.gsr_value_banded(jlo[::2].contiguous(), ok, x, *args, band)
    with pytest.raises(ValueError):          # wrong dtype
        tb.gsr_value_banded(jlo.long(), ok, x, *args, band)
    with pytest.raises(ValueError):          # band wider than the axis
        tb.gsr_value_banded(jlo, ok, x, *args, prep["nlo"].shape[0] + 1)
    with pytest.raises(ValueError):          # not contiguous
        tb.gsr_value_banded(jlo, ok, torch.cat([x, x], 1)[:, ::2], *args,
                            band)


def test_density_backtrace_through_kernel_matches_dense_f64(cuda_device):
    """The replay's RK4 stage function on the card (the banded kernel)
    against the dense field in float64 on 4096 x-sorted points of a
    Leapfrog-3D-sized state: endpoints within 1e-5 in domain units."""
    mix, spec, _ = ring_collide_state(cuda_device, seed=89, side=10)
    mix = mix.x_sorted()
    x = torch.as_tensor(np.sort(np.random.RandomState(90).uniform(
        0, 1, (4096, 3)).astype(np.float32), axis=0), device=cuda_device)
    band = tsim._suggest_band(mix, spec, 0.02, chunk=4096)
    tb.reset_launches()
    with torch.no_grad():
        got = tsim.rk4_pos_stages(tsim._stage_velocity(mix, spec, band), x,
                                  -0.02)
        m64 = tf.mixture_of({k: p.double() for k, p in
                             mix.params().items()}, mix.alive)
        want = tsim.rk4_pos_stages(
            lambda q: tf.value_dense(m64, spec, q), x.double(), -0.02)
    assert tb.launches["gsr_value_banded"] == 4
    assert float((got.double() - want).abs().max()) <= 1e-5
    assert float((want - x.double()).abs().max()) > 1e-4   # it moved
