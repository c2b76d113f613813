"""On the card only: each CUDA kernel of the port against its plain
PyTorch version — the centered kernels at Leapfrog-2D shapes and at d = 3,
the centered forward at every split and every shape its paths run it at,
and the cells parameter backward at every split, with its overflow
branch and a support edge,
the work-list (cells) kernels at Ring-Collide shapes (B = 8192, N =
75,776), with their overflow branch and the cells forward's support
edge (pairs within a few 1e-6 of the clamp), and the banded value kernel
of the density replay at its production chunk (262,144 grid nodes), on
the slab-major and the x-sorted order, with its guard's full sweep and a
batch that is not a whole number of query tiles, the dL/dx kernel at
d = 2 and 3 at every split S, the triple-cotangent backward at every
split (W, S) and the fused RK4 backtrace at Karman-2D shapes (B = 512,
N = 24,576), each bitwise repeatable — the wrappers' refusals, the
field through the kernels, query gradients (also through
``fused_gsr_centered`` itself) and the fused projection
heads through the kernels, one fit, clone and projection epoch, 2D and
3D, through the kernels against the dense path in float64, the
replay's RK4 backtrace through the banded kernel against the dense one
in float64, and the replay's chunk as four stage launches of the banded
kernel (each query tile on its own window) against the eager chain,
bitwise. Skips without a GPU. Imports neither JAX nor the JAX package, so it runs on the card's
machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: 1e-4 of the largest reference entry for a kernel against its
plain version (f32 on the card: FMA contraction and another summation
order), 1e-5 for an epoch's losses and gradients, as stated at each
check."""

import functools

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                      leapfrog_state,
                                                      ring_collide_state)
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_banded as tb
from gaussian_fluids_torch.ops import gsr_cells as tc
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.ops import rk4_fused as tr
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
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=False)
    rng = np.random.RandomState(83)
    douts = [torch.as_tensor(rng.randn(512, 6).astype(np.float32),
                             device=device) for _ in range(2)]
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), douts, spec.clamp_threshold, rad


def _close(got, want):
    """1e-4 of each output's largest reference entry."""
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("njac", [0, 2])
def test_fwd_matches_plain(cuda_device, njac):
    args, _, clamp, rad = _inputs(cuda_device)
    _close([tk.gsr_fwd(*args, clamp, njac, rad)],
           [tk.fwd_plain(*args, clamp, njac)])


@pytest.mark.parametrize("njac", [0, 2])
def test_bwd_dn_matches_plain(cuda_device, njac):
    args, douts, clamp, _ = _inputs(cuda_device)
    dout = douts[0][:, :(1 + njac) * 2].contiguous()
    _close(tk.gsr_bwd_dn(*args, dout, clamp, njac),
           tk.bwd_dn_plain(*args, dout, clamp, njac))


@pytest.mark.parametrize("use_val", [True, False])
def test_bwd_dn2_matches_plain(cuda_device, use_val):
    args, douts, clamp, _ = _inputs(cuda_device)
    got = tk.gsr_bwd_dn2(*args, *douts, clamp, 2, use_val=use_val)
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 2, use_val=use_val)
    _close(got[0] + got[1], want[0] + want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    (tmask, x, muT, ppT, v), _, clamp, rad = _inputs(cuda_device)
    with pytest.raises(ValueError):          # not contiguous
        tk.gsr_fwd(tmask, x, muT, ppT, torch.cat([v, v], 1)[:, ::2], clamp,
                   2, rad)
    with pytest.raises(ValueError):          # operands on two devices
        tk.gsr_fwd(tmask, x, muT.cpu(), ppT, v, clamp, 2, rad)
    with pytest.raises(ValueError):          # mask built for other tiles
        tk.gsr_fwd(tmask[::2].contiguous(), x, muT, ppT, v, clamp, 2, rad)
    with pytest.raises(ValueError):          # wrong dtype
        tk.gsr_fwd(tmask.float(), x, muT, ppT, v, clamp, 2, rad)


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
    x_p, _, tmask, lists, rad = tf._cells_prep(mix, spec, x)
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tc.TN)
    rng = np.random.RandomState(85)
    douts = [torch.as_tensor(rng.randn(x_p.shape[0], 12).astype(np.float32)
                             / 8192, device=device) for _ in range(2)]
    return (lists, (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
                    v_p.contiguous()), douts, spec.clamp_threshold, rad)


@pytest.mark.parametrize("njac", [0, 3])
def test_fwd_kernels_d3_match_plain(cuda_device, njac):
    (rows, cols, _, _, ok), args, _, clamp, rad = _inputs_3d(cuda_device)
    assert int(ok) == 1
    want = [tk.fwd_plain(*args, clamp, njac)]
    _close([tk.gsr_fwd(*args, clamp, njac, rad)], want)
    _close([tc.cells_fwd(rows, cols, ok, *args, clamp, njac, rad)], want)


# the split the rule picks, and every split the centered backwards take
SPLITS = [None] + [(w, s) for w in tk.SPLIT_W for s in tk.SPLIT_S]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("njac", [0, 3])
def test_bwd_dn_kernels_d3_match_plain(cuda_device, njac, split):
    """Rows 2 and 7 at the Ring-Collide shape, each at the split."""
    (_, _, gt, qt, ok), args, douts, clamp, rad = _inputs_3d(cuda_device)
    dout = douts[0][:, :(1 + njac) * 3].contiguous()
    want = tk.bwd_dn_plain(*args, dout, clamp, njac)
    _close(tk.gsr_bwd_dn(*args, dout, clamp, njac, split=split), want)
    _close(tc.cells_bwd_dn(gt, qt, ok, *args, dout, clamp, njac, rad,
                           split=split), want)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("use_val", [True, False])
def test_bwd_dn2_kernels_d3_match_plain(cuda_device, use_val, split):
    """Rows 3 and 6 at the Ring-Collide shape, each at the split; row 6's
    two launches bitwise equal."""
    (_, _, gt, qt, ok), args, douts, clamp, rad = _inputs_3d(cuda_device)
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 3, use_val=use_val)
    got = tk.gsr_bwd_dn2(*args, *douts, clamp, 3, use_val=use_val,
                         split=split)
    _close(got[0] + got[1], want[0] + want[1])
    got, again = (tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, clamp, 3, rad,
                                   use_val=use_val, split=split)
                  for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                  again[0] + again[1]))
    _close(got[0] + got[1], want[0] + want[1])


# ---- the centered backwards' split along the query axis ----

def _split_inputs(device, d, n_queries=8192, seed=87):
    """Kernel-layout inputs at the main paths' centered shapes: d = 3 the
    Leapfrog-3D grid (N = 1024, B = 8192 by default), d = 2 Leapfrog-2D
    (N = 6144, B = 512), on seeded states sorted as the solver keeps them,
    with cotangents of the full (val, jac) width."""
    if d == 3:
        mix, spec, x = ring_collide_state(device, seed=seed, side=10,
                                          n_queries=n_queries)
    else:
        mix, spec, x = leapfrog_state(device, seed=seed)
    x_p, _, _, mu_p, pp_p, v_p, tmask, _ = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=True)
    rng = np.random.RandomState(seed + 1)
    cols = (1 + d) * d
    douts = [torch.as_tensor(rng.randn(x_p.shape[0], cols).astype(np.float32)
                             / x_p.shape[0], device=device) for _ in range(2)]
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), douts, spec.clamp_threshold


def _bwd(ncot, args, douts, clamp, njac, use_val, **kw):
    """Row 2 (ncot 1) or row 3 (ncot 2) through the kernel (with ``kw``)
    or, without ``kw``, the plain twin; the outputs flattened."""
    d = args[1].shape[1]
    dd = [t[:, :(1 + njac) * d].contiguous() for t in douts]
    if ncot == 1:
        f = tk.gsr_bwd_dn if kw else tk.bwd_dn_plain
        return list(f(*args, dd[0], clamp, njac, use_val, **kw))
    f = tk.gsr_bwd_dn2 if kw else tk.bwd_dn2_plain
    return [t for blk in f(*args, *dd, clamp, njac, use_val, **kw)
            for t in blk]


MODES = [(0, True), (1, True), (1, False)]   # (njac = d or 0, use_val)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ncot", [1, 2])
@pytest.mark.parametrize("d", [2, 3])
def test_bwd_split_matches_plain(cuda_device, d, ncot, mode):
    """Rows 2 and 3 at every split the kernel takes against the plain
    twin: 1e-4 of the largest reference entry."""
    args, douts, clamp = _split_inputs(cuda_device, d)
    njac, use_val = mode[0] * d, mode[1]
    want = _bwd(ncot, args, douts, clamp, njac, use_val)
    for split in SPLITS:
        _close(_bwd(ncot, args, douts, clamp, njac, use_val, split=split),
               want)


@pytest.mark.parametrize("ncot", [1, 2])
def test_bwd_split_edge_columns_match_plain(cuda_device, ncot):
    """A tile mask with an empty Gaussian column, a fully live one, and
    columns with fewer live query tiles (3, 1) than most splits have
    workers: every split against the plain twin on the same mask."""
    (tmask, *rest), douts, clamp = _split_inputs(cuda_device, 3)
    tmask = tmask.clone()
    tmask[:, 0] = 0
    tmask[:, 1] = 1
    tmask[:, 2] = 0
    tmask[[5, 400, 1000], 2] = 1
    tmask[:, 3] = 0
    tmask[700, 3] = 1
    args = (tmask, *rest)
    for njac, use_val in ((3, True), (3, False), (0, True)):
        want = _bwd(ncot, args, douts, clamp, njac, use_val)
        for split in SPLITS:
            _close(_bwd(ncot, args, douts, clamp, njac, use_val,
                        split=split), want)


@pytest.mark.parametrize("ncot", [1, 2])
def test_bwd_split_spans_two_list_windows(cuda_device, ncot):
    """More query tiles than the kernel compacts at once (LIST_CAP): the
    second window's shares are walked too."""
    args, douts, clamp = _split_inputs(
        cuda_device, 3, n_queries=tk.TB * (tk.LIST_CAP + 700))
    assert args[0].shape[0] > tk.LIST_CAP
    want = _bwd(ncot, args, douts, clamp, 3, True)
    for split in (None, (1, 1), (2, 4), (8, 8)):
        _close(_bwd(ncot, args, douts, clamp, 3, True, split=split), want)


@pytest.mark.parametrize("ncot", [1, 2])
@pytest.mark.parametrize("d", [2, 3])
def test_bwd_split_is_bitwise_repeatable(cuda_device, d, ncot):
    """One fixed summation order per output element: two launches at the
    same split give the same bits."""
    args, douts, clamp = _split_inputs(cuda_device, d)
    for split in SPLITS:
        a, b = (_bwd(ncot, args, douts, clamp, d, True, split=split)
                for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), split


def test_bwd_split_refused_before_launch(cuda_device):
    args, douts, clamp = _split_inputs(cuda_device, 3)
    tk.reset_launches()
    for bad in ((3, 1), (1, 16), (16, 1), (0, 0)):
        with pytest.raises(ValueError, match="split"):
            tk.gsr_bwd_dn(*args, douts[0], clamp, 3, split=bad)
        with pytest.raises(ValueError, match="split"):
            tk.gsr_bwd_dn2(*args, *douts, clamp, 3, split=bad)
    assert not any(tk.launches.values())


# ---- the centered forward (row 1): staged, box-tested, split ----

# every shape the main paths run the forward at: d = 2 Leapfrog-2D (B =
# 512, and 4096, the 2D test grid's chunk) and Karman-2D (B = 512); d = 3
# Leapfrog-3D (N = 1024; B = 8192, and 32,768, the 3D test grid's chunk)
# and Ring-Collide (N = 75,776) at the batches of the epochs and the test
# grids (4096, 8192, 32,768)
FWD_SHAPES = ["leapfrog_2d", "leapfrog_2d_4096", "karman_2d", "leapfrog_3d",
              "leapfrog_3d_32768", "ring_collide_4096", "ring_collide_8192",
              "ring_collide_32768"]
FWD_SPLITS = [None] + list(tk.SPLIT_S)


def _fwd_inputs(device, shape, seed=111):
    """Row 1's inputs at one of FWD_SHAPES on a seeded state, sorted as
    the solver keeps its batches, with the rows' radii."""
    scene, n = shape.rsplit("_", 1) if shape[-1].isdigit() else (shape, "")
    if scene == "leapfrog_2d":
        mix, spec, x = leapfrog_state(device, seed=seed)
        if n:
            q = np.random.RandomState(seed).uniform(-5, 5, (int(n), 2))
            x = torch.as_tensor(q[np.argsort(q[:, 0])].astype(np.float32),
                                device=device)
    elif scene == "karman_2d":
        mix, spec, x = karman_state(device, seed=seed)
    elif scene == "leapfrog_3d":
        mix, spec, x = ring_collide_state(device, seed=seed, side=10,
                                          n_queries=int(n or 8192))
    else:   # ring_collide_<B>
        mix, spec, x = ring_collide_state(device, seed=seed,
                                          n_queries=int(n))
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=True)
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), rad, spec.clamp_threshold


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_fwd_split_matches_plain(cuda_device, shape):
    """Row 1 at every split (the chosen one first) against the plain twin,
    with and without the Jacobian: 1e-4 of the largest reference entry,
    and two launches at one split bitwise equal; launches counted by
    shape."""
    args, rad, clamp = _fwd_inputs(cuda_device, shape)
    d, B, N = args[1].shape[1], args[1].shape[0], args[2].shape[1]
    tk.reset_launches()
    for njac in (d, 0):
        want = tk.fwd_plain(*args, clamp, njac)
        assert float(want.abs().max()) > 0
        for split in FWD_SPLITS:
            a, b = (tk.gsr_fwd(*args, clamp, njac, rad, split=split)
                    for _ in range(2))
            assert torch.equal(a, b), (njac, split)
            _close([a], [want])
    assert tk.fwd_shapes == {(d, B, N): 4 * len(FWD_SPLITS)}


def test_fwd_support_edge_matches_plain(cuda_device):
    """Pairs with g within 1e-6 relative of the clamp, inside and outside,
    through row 1 at every split: its box test only skips, and its
    geometry rounds as the plain version's, so both put every such pair on
    the same side of the support."""
    mix, spec, _ = ring_collide_state(cuda_device, seed=108, side=10)
    x, rel = _support_edge_queries(mix, spec)
    edge = rel[np.abs(rel) <= 1e-6]
    assert (edge < 0).sum() >= 8 and (edge > 0).sum() >= 8
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=True)
    args = (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous())
    c = spec.clamp_threshold
    for nj in (0, 3):
        want = tk.fwd_plain(*args, c, nj)
        for split in FWD_SPLITS:
            _close([tk.gsr_fwd(*args, c, nj, rad, split=split)], [want])


def test_fwd_refuses_radii_and_splits_before_launch(cuda_device):
    args, rad, clamp = _fwd_inputs(cuda_device, "leapfrog_2d")
    tk.reset_launches()
    for bad in (rad[:-64], rad.cpu(), rad.double(),
                torch.cat([rad[:1], rad])[1:]):   # the last not 16-aligned
        with pytest.raises(ValueError, match="rad"):
            tk.gsr_fwd(*args, clamp, 2, bad)
    for bad in (0, 3, 16, (2, 1)):
        with pytest.raises(ValueError, match="split"):
            tk.gsr_fwd(*args, clamp, 2, rad, split=bad)
    assert not any(tk.launches.values()) and not tk.fwd_shapes


# ---- the cells parameter backward (row 7): split, box-tested ----

def _cells_bwd(args, lists, dout, clamp, njac, use_val, rad=None, **kw):
    """Row 7 through the kernel (with ``rad``) or, without, its plain
    twin; the outputs as a list."""
    gt, qt, ok = lists
    if rad is None:
        return list(tc.cells_bwd_dn_plain(gt, qt, ok, *args, dout, clamp,
                                          njac, use_val))
    return list(tc.cells_bwd_dn(gt, qt, ok, *args, dout, clamp, njac, rad,
                                use_val, **kw))


@pytest.mark.parametrize("mode", MODES)
def test_cells_bwd_split_matches_plain(cuda_device, mode):
    """Row 7 on the seeded Ring-Collide state at every split, with and
    without the Jacobian and the value cotangent, and on the overflow
    branch (the list flagged overflowed and cut short: the kernel sweeps
    the mask column): 1e-4 of the largest reference entry, two launches at
    one split bitwise equal."""
    (_, _, gt, qt, ok), args, douts, clamp, rad = _inputs_3d(cuda_device)
    njac, use_val = mode[0] * 3, mode[1]
    dout = douts[0][:, :(1 + njac) * 3].contiguous()
    bad = (gt[:5].contiguous(), qt[:5].contiguous(), torch.zeros_like(ok))
    want = _cells_bwd(args, (gt, qt, ok), dout, clamp, njac, use_val)
    tc.reset_launches()
    for lists in ((gt, qt, ok), bad):
        for split in SPLITS:
            a, b = (_cells_bwd(args, lists, dout, clamp, njac, use_val, rad,
                               split=split) for _ in range(2))
            assert all(torch.equal(p, q) for p, q in zip(a, b)), split
            _close(a, want)
    assert tc.overflows()["cells_bwd_dn"] == 2 * len(SPLITS)


def test_cells_bwd_support_edge_matches_plain(cuda_device):
    """Row 7 against queries whose pairs sit within 1e-6 relative of the
    clamp, at every split: the box test on the Gaussian's own radius only
    skips, and the kept pairs' geometry rounds as the plain twin's."""
    mix, spec, _ = ring_collide_state(cuda_device, seed=108, side=10)
    x, _ = _support_edge_queries(mix, spec)
    x_p, _, tmask, (_, _, gt, qt, ok), rad = tf._cells_prep(mix, spec, x)
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tc.TN)
    args = (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous())
    dout = torch.as_tensor(np.random.RandomState(112).randn(
        x_p.shape[0], 12).astype(np.float32), device=cuda_device)
    c = spec.clamp_threshold
    for njac, use_val in ((3, True), (3, False), (0, True)):
        d_ = dout[:, :(1 + njac) * 3].contiguous()
        want = _cells_bwd(args, (gt, qt, ok), d_, c, njac, use_val)
        for split in SPLITS:
            _close(_cells_bwd(args, (gt, qt, ok), d_, c, njac, use_val, rad,
                              split=split), want)


def test_cells_bwd_refuses_radii_and_splits_before_launch(cuda_device):
    (_, _, gt, qt, ok), args, douts, clamp, rad = _inputs_3d(cuda_device)
    tc.reset_launches()
    for bad in (rad[:-64], rad.cpu(), rad.double()):
        with pytest.raises(ValueError, match="rad"):
            tc.cells_bwd_dn(gt, qt, ok, *args, douts[0], clamp, 3, bad)
    for bad in ((3, 1), (1, 16), (0, 0)):
        with pytest.raises(ValueError, match="split"):
            tc.cells_bwd_dn(gt, qt, ok, *args, douts[0], clamp, 3, rad,
                            split=bad)
    for bad in (rad[:-64], rad.cpu(), rad.double()):
        with pytest.raises(ValueError, match="rad"):
            tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, clamp, 3, bad)
    for bad in ((3, 1), (1, 16)):
        with pytest.raises(ValueError, match="split"):
            tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, clamp, 3, rad,
                             split=bad)
    assert not any(tc.launches.values())


def test_cells_overflow_branch_sweeps_the_mask(cuda_device):
    """Flagged as overflowed, every cells kernel ignores its (here
    truncated) list and sweeps the whole fine mask: the same result, and
    the device counter sees each such launch (row 6 split over the
    blocks of a cluster)."""
    (rows, cols, gt, qt, ok), args, douts, clamp, rad = \
        _inputs_3d(cuda_device)
    bad = torch.zeros_like(ok)
    rows, cols, gt, qt = (a[:5].contiguous() for a in (rows, cols, gt, qt))
    tc.reset_launches()
    _close([tc.cells_fwd(rows, cols, bad, *args, clamp, 3, rad)],
           [tk.fwd_plain(*args, clamp, 3)])
    _close(tc.cells_bwd_dn(gt, qt, bad, *args, douts[0], clamp, 3, rad),
           tk.bwd_dn_plain(*args, douts[0], clamp, 3))
    got = tc.cells_bwd_dn2(gt, qt, bad, *args, *douts, clamp, 3, rad,
                           split=(2, 4))
    again = tc.cells_bwd_dn2(gt, qt, bad, *args, *douts, clamp, 3, rad,
                             split=(2, 4))
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                  again[0] + again[1]))
    want = tk.bwd_dn2_plain(*args, *douts, clamp, 3)
    _close(got[0] + got[1], want[0] + want[1])
    n = {"cells_fwd": 1, "cells_bwd_dn": 1, "cells_bwd_dn2": 2}
    assert tc.overflows() == n
    assert tc.launches == n


def _support_edge_queries(mix, spec, n_gauss=256, seed=107):
    """Queries at the support edge of ``n_gauss`` live Gaussians of
    ``mix``: x = mu + t e along a seeded direction e, with t set in float64
    so that g = c (1 + delta), delta spread over [-1e-6, 1e-6] (rounding x
    to f32 moves g by a few 1e-6 more). Returns (x sorted along x, the
    float64 g / c - 1 of each query's own pair at the f32 x)."""
    rng = np.random.RandomState(seed)
    live = np.flatnonzero(tf.in_domain_mask(mix, spec).cpu().numpy())
    pick = rng.choice(live, n_gauss, replace=False)
    P = mix.precisions()[pick].double().cpu().numpy()
    mu = mix.positions[pick].double().cpu().numpy()
    e = rng.randn(n_gauss, 3)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    delta = np.linspace(-1e-6, 1e-6, n_gauss)
    quad = -2.0 * np.log(spec.clamp_threshold * (1.0 + delta))
    t = np.sqrt(quad / np.einsum("ni,nij,nj->n", e, P, e))
    x = (mu + t[:, None] * e).astype(np.float32)
    dx = x.astype(np.float64) - mu
    g = np.exp(-0.5 * np.einsum("ni,nij,nj->n", dx, P, dx))
    order = np.argsort(x[:, 0], kind="stable")
    return (torch.as_tensor(x[order], device=mix.device),
            g[order] / spec.clamp_threshold - 1.0)


def test_cells_fwd_support_edge_matches_plain(cuda_device):
    """Pairs with g within 1e-6 relative of the clamp, inside and outside:
    the cells forward's box test only skips, and its geometry rounds as
    the plain version's, so both put every such pair on the same side of
    the support. A pair on two sides would differ by its whole Jacobian
    term g Pd v, far above the 1e-4 of the largest entry allowed."""
    mix, spec, _ = ring_collide_state(cuda_device, seed=108, side=10)
    x, rel = _support_edge_queries(mix, spec)
    edge = rel[np.abs(rel) <= 1e-6]
    assert (edge < 0).sum() >= 8 and (edge > 0).sum() >= 8
    x_p, _, tmask, (rows, cols, _, _, ok), rad = tf._cells_prep(mix, spec,
                                                                x)
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tc.TN)
    args = (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous())
    c = spec.clamp_threshold
    for nj in (0, 3):
        want = tk.fwd_plain(*args, c, nj)
        got = tc.cells_fwd(rows, cols, ok, *args, c, nj, rad)
        _close([got], [want])
        bad = torch.zeros_like(ok)
        _close([tc.cells_fwd(rows, cols, bad, *args, c, nj, rad)], [want])


def test_cells_fwd_refuses_radii_it_cannot_read(cuda_device):
    (rows, cols, _, _, ok), args, _, clamp, rad = _inputs_3d(cuda_device)
    with pytest.raises(ValueError):          # radii for other rows
        tc.cells_fwd(rows, cols, ok, *args, clamp, 3, rad[:-64])
    with pytest.raises(ValueError):          # on the host
        tc.cells_fwd(rows, cols, ok, *args, clamp, 3, rad.cpu())
    with pytest.raises(ValueError):          # not 16-byte aligned
        tc.cells_fwd(rows, cols, ok, *args, clamp, 3,
                     torch.cat([rad[:1], rad])[1:])


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


def _banded(device, seed=87, order="slab"):
    mix, spec, _ = ring_collide_state(device, seed=seed)
    mix = mix.slab_sorted(spec.clamp_threshold) if order == "slab" \
        else mix.x_sorted()
    return mix, spec, tf.banded_prep(mix, spec), \
        tsim._suggest_band(mix, spec, 0.02)


def _banded_call(prep, x, band, kernel=True):
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    args = (jlo, ok, x, prep["muT"], prep["ppT"], prep["v"])
    if kernel:
        out = tb.gsr_value_banded(*args, prep["rad"], prep["lo"], prep["hi"],
                                  prep["clamp"], band)
    else:
        out = tb.value_banded_plain(*args, prep["clamp"], band)
    return out, int(ok)


@pytest.mark.parametrize("order", ["slab", "x"])
@pytest.mark.parametrize("where", ["plane", "stage"])
def test_banded_kernel_matches_plain(cuda_device, where, order):
    """A 262,144-node chunk at Ring-Collide width, on the grid plane and
    moved as an RK4 stage moves it (x + dt/2 u, no longer one plane, not
    re-sorted), on the mixture slab-major (the replay's order) and
    x-sorted: kernel and plain twin within 1e-4 of the largest entry."""
    mix, spec, prep, band = _banded(cuda_device, order=order)
    x = _plane(cuda_device, 0.4985)
    if where == "stage":
        u = tf.value_banded_prepped(prep, x, band, presorted=True)
        x = (x - 0.01 * u).contiguous()
    got, ok = _banded_call(prep, x, band)
    want, _ = _banded_call(prep, x, band, kernel=False)
    assert ok == 1
    assert float(want.abs().max()) > 0
    _close([got], [want])


@pytest.mark.parametrize("order", ["slab", "x"])
def test_banded_guard_sweep_is_bitwise(cuda_device, order):
    """Band 1 fails the device guard: the kernel sweeps the whole axis,
    bitwise equal to the sufficient band's output, and counts it."""
    mix, spec, prep, band = _banded(cuda_device, seed=88, order=order)
    x = _plane(cuda_device, 0.25)
    tb.reset_launches()
    want, ok = _banded_call(prep, x, band)
    got, ok1 = _banded_call(prep, x, 1)
    assert (ok, ok1) == (1, 0)
    assert torch.equal(got, want)
    assert tb.guard_failures() == 1 and tb.launches["gsr_value_banded"] == 2


def test_banded_padded_queries_match_plain(cuda_device):
    """A batch that is not a whole number of query tiles: the padded rows
    stay out of the last tile's box (``nvalid``), and the real rows match
    the plain twin within 1e-4 of the largest entry."""
    mix, spec, prep, band = _banded(cuda_device, seed=109)
    x = _plane(cuda_device, 0.6, n=100)[:9950]
    tb.reset_launches()
    got = tf.value_banded_prepped(prep, x, band, presorted=True)
    assert tb.launches["gsr_value_banded"] == 1
    x_p = tf._pad_axis(x, tb.TB)
    jlo, ok = tf.band_window(x_p, x.shape[0], prep["nlo"], prep["nhi"],
                             band, tb.TB)
    want = tb.value_banded_plain(jlo, ok, x_p, prep["muT"], prep["ppT"],
                                 prep["v"], prep["clamp"], band)[:9950]
    _close([got], [want])


def test_banded_wrapper_refuses(cuda_device):
    mix, spec, prep, band = _banded(cuda_device)
    x = _plane(cuda_device, 0.5, n=64)
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    args = (prep["muT"], prep["ppT"], prep["v"], prep["rad"], prep["lo"],
            prep["hi"], prep["clamp"])
    with pytest.raises(ValueError):          # starts for other tiles
        tb.gsr_value_banded(jlo[::2].contiguous(), ok, x, *args, band)
    with pytest.raises(ValueError):          # wrong dtype
        tb.gsr_value_banded(jlo.long(), ok, x, *args, band)
    with pytest.raises(ValueError):          # band wider than the axis
        tb.gsr_value_banded(jlo, ok, x, *args, prep["nlo"].shape[0] + 1)
    with pytest.raises(ValueError):          # not contiguous
        tb.gsr_value_banded(jlo, ok, torch.cat([x, x], 1)[:, ::2], *args,
                            band)
    with pytest.raises(ValueError):          # boxes of other tiles
        tb.gsr_value_banded(jlo, ok, x, prep["muT"], prep["ppT"], prep["v"],
                            prep["rad"], prep["lo"][:, 1:].contiguous(),
                            prep["hi"], prep["clamp"], band)


def test_density_backtrace_through_kernel_matches_dense_f64(cuda_device):
    """The replay's RK4 stage function on the card (the banded kernel)
    against the dense field in float64 on 4096 x-sorted points of a
    Leapfrog-3D-sized state: endpoints within 1e-5 in domain units."""
    mix, spec, _ = ring_collide_state(cuda_device, seed=89, side=10)
    mix = mix.slab_sorted(spec.clamp_threshold)
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


def _eager_density(mix, spec, density, domain, dt, grid, chunk, band):
    """``advected_density``'s chunk loop as the eager chain the stage
    launches replace: the banded kernel on the host's window
    (``_stage_velocity``) through ``rk4_pos_stages``, the clamp and
    ``trilinear_interp``."""
    from gaussian_fluids_torch.ops import interp
    dev = density.device
    f = tsim._stage_velocity(mix, spec, band)
    lo = torch.tensor(domain[0::2], dtype=torch.float32, device=dev)
    hi = torch.tensor(domain[1::2], dtype=torch.float32, device=dev)
    xcs, n = tsim._grid_chunks_device(tuple(domain), tuple(grid), chunk, dev)
    return torch.cat([interp.trilinear_interp(density, torch.minimum(
        torch.maximum(tsim.rk4_pos_stages(f, xc, -dt), lo), hi), domain)
        for xc in xcs])[:n].reshape(grid)


@pytest.mark.parametrize("band", ["suggested", 1])
def test_density_step_stage_kernel_is_the_eager_chain(cuda_device, band):
    """``advected_density`` on the card (four stage launches a chunk, each
    query tile on its own window, the last launch clamping and sampling
    into the volume) against the eager chain on a 48^3 grid in chunks of
    16,384 (the last one padded) at Ring-Collide width: bitwise, with the
    suggested band and with band 1, where tiles sweep the whole axis
    (``banded_swept_tiles``) and the host's guard fails."""
    from gaussian_fluids_torch.utils import profiling
    mix, spec, _ = ring_collide_state(cuda_device, seed=93)
    mix = mix.slab_sorted(spec.clamp_threshold)
    grid, chunk, dt = (48, 48, 48), 16384, 0.1
    domain = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    band = tsim._suggest_band(mix, spec, dt, chunk=chunk) \
        if band == "suggested" else band
    dens = torch.rand(grid, generator=torch.Generator().manual_seed(94)) \
        .to(cuda_device)
    tb.reset_launches()
    with profiling.counting() as rec:
        got = tsim.advected_density(dens, mix, spec, domain, dt, grid,
                                    chunk=chunk, band=band)
    chunks = -(-48 ** 3 // chunk)
    assert tb.launches["gsr_value_banded"] == 4 * chunks
    assert rec.fallbacks["banded_guard_failures"] == 0
    swept, tiles, calls = rec.sums("banded_swept_tiles", "gf.replay.banded")
    assert (tiles, calls) == (4 * chunks * chunk // tb.TB, 4 * chunks)
    assert (swept == 0) == (band != 1)
    want = _eager_density(mix, spec, dens, domain, dt, grid, chunk, band)
    assert torch.equal(got, want)
    assert float((got - dens).abs().max()) > 1e-2   # it moved


def test_density_plane_chunk_stage_kernel_is_the_eager_chain(cuda_device):
    """One production chunk (the 262,144 nodes of a 512^2 plane) at
    Ring-Collide width through the four stage launches against the eager
    chain, bitwise; the stage launches' points are fresh tensors."""
    from gaussian_fluids_torch.ops import interp
    mix, spec, prep, band = _banded(cuda_device, seed=95)
    x = _plane(cuda_device, 0.4985)
    domain = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    dens = torch.rand((128,) * 3, generator=torch.Generator().manual_seed(
        96)).to(cuda_device)
    out = torch.full((x.shape[0],), float("nan"), device=cuda_device)
    seen = []
    real = tb.gsr_value_banded

    def spy(*args, **kwargs):
        seen.append(args[2])
        return real(*args, **kwargs)
    tb.gsr_value_banded = spy
    try:
        tb.reset_launches()
        tsim._banded_rk4_chunk(prep, x, -0.1, band, dens, domain, out, 0)
    finally:
        tb.gsr_value_banded = real
    assert tb.launches["gsr_value_banded"] == 4
    assert len({t.data_ptr() for t in seen}) == 4 and seen[0] is x
    bk = tsim.rk4_pos_stages(tsim._stage_velocity(mix, spec, band), x, -0.1)
    lo, hi = (torch.tensor(domain[i::2], device=cuda_device) for i in (0, 1))
    want = interp.trilinear_interp(dens, torch.minimum(torch.maximum(bk, lo),
                                                       hi), domain)
    assert torch.equal(out, want)


@pytest.mark.parametrize("band", ["suggested", 1])
def test_banded_own_window_is_bitwise(cuda_device, band):
    """The kernel's own window (``jlo`` None) on a production chunk moved
    as a stage moves it: bitwise the host window's sums, with the
    suggested band (every tile covered) and band 1 (the host sweeps every
    tile, the tiles sweep on their own)."""
    mix, spec, prep, sband = _banded(cuda_device, seed=97)
    band = sband if band == "suggested" else band
    x = _plane(cuda_device, 0.61)
    u = tf.value_banded_prepped(prep, x, sband, presorted=True)
    x = (x - 0.05 * u).contiguous()
    host, ok = _banded_call(prep, x, band)
    own = tb.gsr_value_banded(None, None, x, prep["muT"], prep["ppT"],
                              prep["v"], prep["rad"], prep["lo"], prep["hi"],
                              prep["clamp"], band)
    assert ok == (band != 1)
    assert float(host.abs().max()) > 0
    assert torch.equal(own, host)


# ---- the last three kernels: dL/dx, the triple backward, fused RK4 ----

@functools.lru_cache(maxsize=2)
def _inputs_dx(device, d):
    """Centered-kernel inputs, a cotangent and the rows' radii at d = 2
    (Karman-2D shapes) or d = 3 (Leapfrog-3D shapes: B = 8192,
    N = 1024)."""
    if d == 2:
        mix, spec, x = karman_state(device, seed=101)
    else:
        mix, spec, x = ring_collide_state(device, seed=102, side=10)
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=True)
    dout = torch.as_tensor(np.random.RandomState(103).randn(
        x_p.shape[0], (1 + d) * d).astype(np.float32), device=device)
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), dout, spec.clamp_threshold, rad


@pytest.mark.parametrize("split", FWD_SPLITS)
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("njac", [0, "d"])
def test_bwd_dx_matches_plain(cuda_device, d, njac, split):
    """Row 4 at the split S (the chosen one for None) against its plain
    twin, two launches bitwise equal."""
    njac = d if njac == "d" else 0
    args, dout, clamp, rad = _inputs_dx(cuda_device, d)
    dout = dout[:, :(1 + njac) * d].contiguous()
    want = tk.bwd_dx_plain(*args, dout, clamp, njac)
    assert float(want.abs().max()) > 0
    got, again = (tk.gsr_bwd_dx(*args, dout, clamp, njac, rad, split=split)
                  for _ in range(2))
    assert torch.equal(got, again)
    _close([got], [want])


@pytest.mark.parametrize("d", [2, 3])
def test_fused_query_gradient_matches_dense_f64(cuda_device, d):
    """dL/dx through ``fused_gsr_centered`` itself (x requires a gradient:
    the forward, then row 4 in its backward) against float64 dense
    autograd of the same weighted sum of value and Jacobian columns: 1e-4
    of the largest entry."""
    if d == 2:
        mix, spec, x = karman_state(cuda_device, seed=115)
    else:
        mix, spec, x = ring_collide_state(cuda_device, seed=116, side=10,
                                          n_queries=1024)
    x_p, b, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, x, tk.TB, tk.TN, presorted=True)
    w = torch.as_tensor(np.random.RandomState(117).randn(
        b, (1 + d) * d).astype(np.float32), device=cuda_device)
    tk.reset_launches()
    xg = x_p.clone().requires_grad_(True)
    out = tk.fused_gsr_centered(tmask, xg, mu_p.T.contiguous(),
                                pp_p.T.contiguous(), v_p.contiguous(),
                                spec.clamp_threshold, d, rad)
    (gx,) = torch.autograd.grad((out[:b] * w).sum(), [xg])
    assert tk.launches["gsr_bwd_dx"] == 1 and tk.launches["gsr_bwd_dn"] == 0
    m64 = tf.mixture_of({k: p.double() for k, p in mix.params().items()},
                        mix.alive)
    x64 = x.double().requires_grad_(True)
    val, jac = tf.value_and_jac_dense(m64, spec, x64)
    dense = torch.cat([val, jac.transpose(1, 2).reshape(b, d * d)], 1)
    (want,) = torch.autograd.grad((dense * w.double()).sum(), [x64])
    assert float(want.abs().max()) > 0
    _close([gx[:b].double()], [want])


@functools.lru_cache(maxsize=4)
def _karman_heads_inputs(device, n_bnd=3072):
    """The fused [data; boundary] geometry at Karman-2D width: 512 data
    rows, ``n_bnd`` sorted boundary rows along the domain's edges, and
    cotangents laid out as ``field.epoch_heads_grads`` lays them out."""
    mix, spec, x = karman_state(device, seed=104)
    rng = np.random.RandomState(105)
    lo, hi = np.float32(spec.lo), np.float32(spec.hi)
    xb = rng.uniform(lo, hi, (n_bnd, 2)).astype(np.float32)
    xb[: n_bnd // 2, 1] = lo[1]
    xb = torch.as_tensor(xb[np.argsort(xb[:, 0])], device=device)
    xc = torch.cat([tf._pad_axis(x, tk.TB), xb])
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = tf._centered_prep(
        mix, spec, xc, tk.TB, tk.TN, presorted=True)
    B = x_p.shape[0]
    douts = [torch.zeros((B, 6), device=device) for _ in range(2)]
    dout3 = torch.zeros((B, 2), device=device)
    for o in douts:
        o[:512] = torch.as_tensor(rng.randn(512, 6).astype(np.float32),
                                  device=device)
    dout3[512:512 + n_bnd] = torch.as_tensor(
        rng.randn(n_bnd, 2).astype(np.float32), device=device)
    return (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous()), douts, dout3, spec.clamp_threshold, rad


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("data_rows", [0, 512, "B"])
@pytest.mark.parametrize("use_val12", [True, False])
def test_bwd_dn3_matches_plain(cuda_device, data_rows, use_val12, split):
    """Data rows at 0 (every tile a boundary tile), at the data segment's
    end, and at B (no boundary tile), at the split (W, S) (the chosen one
    for None); two launches bitwise equal."""
    args, douts, dout3, clamp, _ = _karman_heads_inputs(cuda_device)
    rows = args[1].shape[0] if data_rows == "B" else data_rows
    got, again = (tk.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2, rows,
                                 use_val12=use_val12, split=split)
                  for _ in range(2))
    got, again = [t for blk in got for t in blk], \
        [t for blk in again for t in blk]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tk.bwd_dn3_plain(*args, *douts, dout3, clamp, 2, rows,
                            use_val12=use_val12)
    _close(got, [t for blk in want for t in blk])


def _rk4_queries(x, spec, kind):
    """The queries of the fused RK4 test: ``x`` padded to 64 rows, plus 5
    rows at 0 (B not a multiple of the query tile), sorted along x as the
    covector target sorts them, in a seeded random order, or with 96 of
    them moved onto and beyond the domain's faces and corners."""
    xq = tf._pad_axis(x, 64)
    xq = torch.cat([xq, torch.zeros((5, x.shape[1]), device=x.device)])
    if kind == "unsorted":
        perm = np.random.RandomState(113).permutation(xq.shape[0])
        xq = xq[torch.as_tensor(perm, device=x.device)]
    elif kind == "edge":
        rng = np.random.RandomState(114)
        lo, hi = np.float32(spec.lo), np.float32(spec.hi)
        ext = hi - lo
        e = rng.uniform(lo, hi, (96, x.shape[1])).astype(np.float32)
        axis = rng.randint(0, x.shape[1], 96)
        side = rng.randint(0, 2, 96)
        beyond = np.float32([0.0, 1e-3, 0.05, 0.5])[rng.randint(0, 4, 96)]
        for r in range(96):
            k = axis[r]
            e[r, k] = hi[k] + beyond[r] * ext[k] if side[r] \
                else lo[k] - beyond[r] * ext[k]
        e[:4] = [np.where([(c >> k) & 1 for k in range(x.shape[1])], hi, lo)
                 for c in range(4)]          # corners
        xq = xq.clone()
        xq[:96] = torch.as_tensor(e, device=x.device)
    return xq.contiguous()


RK4_SPLITS = [None, 1, 2, 4, 8]


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "edge"])
@pytest.mark.parametrize("d", [2, 3])
def test_rk4_fused_matches_plain(cuda_device, d, kind):
    """Karman-2D width (d = 2) or the Leapfrog-3D state (d = 3), with dead
    Gaussian rows (killed, and moved out of the domain) besides the
    capacity's padded tail, padded query rows and a batch that is not a
    whole number of query tiles: the kernel at every split S against its
    plain twin, forward and backward in time, two launches bitwise equal;
    sorted queries, unsorted, and queries at and beyond the domain's
    edge."""
    if d == 2:
        mix, spec, x = karman_state(cuda_device, seed=106)
    else:
        mix, spec, x = ring_collide_state(cuda_device, seed=111, side=10,
                                          n_queries=512)
    mix.alive[100:400] = False
    mix.positions[500:520] = 1e3
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tk.TN)
    rad = tf.row_radius(mix, spec, tk.TN)
    args = (mu_p.T.contiguous(), pp_p.T.contiguous(), v_p.contiguous())
    boxes = tr.tile_boxes(args[0], rad)
    xq = _rk4_queries(x, spec, kind)
    assert xq.shape[0] % tr.TB != 0
    tr.reset_launches()
    for dt in (-0.01, 0.02):
        for njac in (d, 0):
            want = tr.rk4_plain(xq, *args, dt, spec.clamp_threshold, njac)
            assert float((want[0] - xq).abs().max()) > 1e-3   # it moved
            for split in RK4_SPLITS:
                got, again = (tr.fused_rk4(xq, *args, dt,
                                           spec.clamp_threshold, njac, rad,
                                           *boxes, split=split)
                             for _ in range(2))
                assert all(torch.equal(a, b) for a, b in zip(got, again))
                _close(got, want)
    assert tr.launches["rk4_fused"] == 2 * 2 * 2 * len(RK4_SPLITS)


def test_rest_wrappers_refuse(cuda_device):
    args, douts, dout3, clamp, rad3 = _karman_heads_inputs(cuda_device, 512)
    with pytest.raises(ValueError):          # data_rows off the query tile
        tk.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2, 12)
    with pytest.raises(ValueError):          # data_rows beyond B
        tk.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2,
                       args[1].shape[0] + 8)
    tk.reset_launches()
    for bad in (rad3[:-64], rad3.cpu(), rad3.double()):
        with pytest.raises(ValueError, match="rad"):
            tk.gsr_bwd_dx(*args, douts[0], clamp, 2, bad)
    for bad in ((3, 1), (1, 16), 4):
        with pytest.raises(ValueError, match="split"):
            tk.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2, 512, split=bad)
    for bad in (3, 16, (2, 1)):
        with pytest.raises(ValueError, match="split"):
            tk.gsr_bwd_dx(*args, douts[0], clamp, 2, rad3, split=bad)
    assert tk.launches["gsr_bwd_dn3"] == tk.launches["gsr_bwd_dx"] == 0
    _, x, muT, ppT, v = args
    rad0 = torch.ones(muT.shape[1], device=x.device)
    boxes0 = tr.tile_boxes(muT, rad0)
    with pytest.raises(ValueError):          # not a velocity field
        tr.fused_rk4(x, muT, ppT, v[:, :1].contiguous(), -0.01, clamp, 2,
                     rad0, *boxes0)
    with pytest.raises(ValueError):          # operands on two devices
        tr.fused_rk4(x, muT.cpu(), ppT, v, -0.01, clamp, 2, rad0, *boxes0)
    rad = -torch.ones(muT.shape[1], device=x.device)
    lo, hi = tr.tile_boxes(muT, rad)
    with pytest.raises(ValueError):          # not contiguous
        tr.fused_rk4(x, muT, ppT, torch.cat([v, v], 1)[:, ::2], -0.01,
                     clamp, 2, rad, lo, hi)
    tr.reset_launches()
    for bad in (rad[:-64], rad.cpu(), rad.double()):
        with pytest.raises(ValueError, match="rad"):
            tr.fused_rk4(x, muT, ppT, v, -0.01, clamp, 2, bad, lo, hi)
    for bad in (3, 16, (2, 1)):
        with pytest.raises(ValueError, match="split"):
            tr.fused_rk4(x, muT, ppT, v, -0.01, clamp, 2, rad, lo, hi,
                         split=bad)
    for bad in ((lo, None), (lo.cpu(), hi), (lo[:, :-1], hi[:, :-1])):
        with pytest.raises(ValueError, match="box"):
            tr.fused_rk4(x, muT, ppT, v, -0.01, clamp, 2, rad, *bad)
    assert tr.launches["rk4_fused"] == 0


@pytest.mark.parametrize("d", [2, 3])
def test_query_gradient_through_kernels_matches_dense_f64(cuda_device, d):
    """dL/dx through field.value_and_jac (jac summed) and field.value on
    the card (the dL/dx kernel) against float64 dense autograd: 1e-4 of
    the largest entry."""
    if d == 2:
        mix, spec, x = karman_state(cuda_device, seed=107)
    else:
        mix, spec, x = ring_collide_state(cuda_device, seed=108, side=10,
                                          n_queries=1024)
    m64 = tf.mixture_of({k: p.double() for k, p in mix.params().items()},
                        mix.alive)
    for f, f64 in ((lambda m, q: tf.value_and_jac(m, spec, q)[1],
                    lambda m, q: tf.value_and_jac_dense(m, spec, q)[1]),
                   (lambda m, q: tf.value(m, spec, q),
                    lambda m, q: tf.value_dense(m, spec, q))):
        tk.reset_launches()
        xg = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(f(mix, xg).sum(), [xg])
        assert tk.launches["gsr_bwd_dx"] == 1
        assert tk.launches["gsr_bwd_dn"] == 0
        x64 = x.double().requires_grad_(True)
        (want,) = torch.autograd.grad(f64(m64, x64).sum(), [x64])
        _close([gx.double()], [want])


def test_epoch_heads_grads_through_kernels(cuda_device):
    """field.epoch_heads_grads on the card (one forward, one triple
    backward) against two_head_grads plus a separate boundary value
    backward on the same inputs: losses and gradients within 1e-4 of the
    largest entry."""
    mix, spec, x = karman_state(cuda_device, seed=109)
    params = mix.params()
    rng = np.random.RandomState(110)
    xb = torch.as_tensor(np.sort(rng.uniform(
        np.float32(spec.lo), np.float32(spec.hi), (1024, 2)).astype(
            np.float32), axis=0), device=cuda_device)
    ref = torch.as_tensor(rng.randn(512).astype(np.float32),
                          device=cuda_device)

    def head1(val, jac):
        return ((jac[:, 1, 0] - jac[:, 0, 1] - ref) ** 2).mean()

    def head2(val, jac):
        return ((jac[:, 0, 0] + jac[:, 1, 1]) ** 2).mean()

    def head_bnd(vb):
        return (vb ** 2).sum(-1).mean()

    tk.reset_launches()
    (l1, l2, lb), (g1, g2, gb) = tf.epoch_heads_grads(
        params, mix.alive, spec, x, xb, head1, head2, head_bnd)
    assert tk.launches["gsr_bwd_dn3"] == 1 and tk.launches["gsr_fwd"] == 1
    (w1, w2), (h1, h2) = tf.two_head_grads(params, mix.alive, spec, x,
                                           head1, head2)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    wb = head_bnd(tf.value(tf.mixture_of(leaves, mix.alive), spec, xb,
                           presorted=True))
    hb = dict(zip(leaves, torch.autograd.grad(
        wb, list(leaves.values()), allow_unused=True,
        materialize_grads=True)))
    _close([l1, l2, lb], [w1, w2, wb.detach()])
    for got, want in ((g1, h1), (g2, h2), (gb, hb)):
        _close([got[k] for k in want], [want[k] for k in want])
