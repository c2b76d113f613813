"""The centered forward's split along the Gaussian axis and the cells
parameter backwards' split of their runs (rows 7 and 6, one kernel), on
the CPU: the host rule
``fwd_split`` at the main paths' shapes and for other SM counts, its
limits (never more ranks than the Gaussian tiles allow, only the splits
the kernel takes, filling the card where the tiles allow); the wrappers'
refusal of a bad ``rad`` or split before any launch; any valid split on
a CPU tensor taking the plain twin, which reads no radius; and the cells
backward's worker shares of a run (``run_worker_tiles``, the kernel's
equal contiguous shares of each window) against a direct count. The
kernels themselves, at every split against their plain twins, are in
tests/test_torch_cuda.py, which runs on the card."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_cells as tc
from gaussian_fluids_torch.ops import gsr_centered as tk

H100_SMS = 132

# (nbt, nnt) of the forward's shapes on the main paths: B queries in tiles
# of 8, N Gaussian rows in tiles of 64.
LEAPFROG_2D = (64, 96)          # B = 512, N = 6144
KARMAN_2D = (64, 384)           # B = 512, N = 24,576
LEAPFROG_3D = (1024, 16)        # B = 8192, N = 1024
RING_COLLIDE_4096 = (512, 1184)
RING_COLLIDE_8192 = (1024, 1184)
RING_COLLIDE_32768 = (4096, 1184)


@pytest.mark.parametrize("sms, shape, want", [
    (H100_SMS, LEAPFROG_2D, 4),
    (H100_SMS, KARMAN_2D, 8),
    (H100_SMS, LEAPFROG_3D, 1),
    (H100_SMS, RING_COLLIDE_4096, 2),
    (H100_SMS, RING_COLLIDE_8192, 1),
    (H100_SMS, RING_COLLIDE_32768, 1),
    (H100_SMS, (512, 96), 2),           # Leapfrog-2D's 4096-point test chunk
    (16, LEAPFROG_2D, 1),
    (16, (8, 384), 8),
    (16, RING_COLLIDE_8192, 1),
    (264, LEAPFROG_2D, 4),
    (264, RING_COLLIDE_8192, 2),
    (264, RING_COLLIDE_32768, 1),
    (1, (1, 1), 1),
    (1000, (1, 4096), 8),
])
def test_fwd_split_at_the_main_shapes_and_other_cards(sms, shape, want):
    assert tk.fwd_split(*shape, sms) == want


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
def test_fwd_split_never_asks_for_more_ranks_than_tiles_allow(sms):
    for nbt in (0, 1, 2, 7, 64, 512, 1024, 4096):
        for nnt in list(range(0, 70)) + [96, 127, 128, 129, 384, 1184]:
            s = tk.fwd_split(nbt, nnt, sms)
            assert s in tk.SPLIT_S
            assert s == 1 or nnt >= 16 * s, (nbt, nnt, sms, s)


@pytest.mark.parametrize("sms", [16, 132])
def test_fwd_split_fills_the_card_where_the_tiles_allow(sms):
    """With Gaussian tiles to spare: FWD_FILL_WARPS warps an SM (a block
    is four warps) or the largest split, and the smallest split that
    does."""
    fill = tk.FWD_FILL_WARPS * sms
    for nbt in (1, 8, 64, 500, 1024, 1 << 14):
        s = tk.fwd_split(nbt, 1 << 20, sms)
        assert nbt * s * tk.FWD_WARPS >= fill or s == tk.SPLIT_S[-1]
        if s > 1:
            assert nbt * (s // 2) * tk.FWD_WARPS < fill


def _cpu_inputs(b=64, n=128, d=3, vdim=3, seed=5):
    rng = np.random.RandomState(seed)
    np_ = d * (d + 1) // 2 + 1
    x = torch.as_tensor(rng.rand(b, d).astype(np.float32))
    muT = torch.as_tensor(rng.rand(d, n).astype(np.float32))
    ppT = torch.as_tensor(np.concatenate(
        [np.full((d, n), 20.0), 0.5 * rng.randn(np_ - 1 - d, n),
         np.zeros((1, n))]).astype(np.float32))
    v = torch.as_tensor(rng.randn(n, vdim).astype(np.float32))
    tmask = torch.as_tensor(
        (rng.rand(b // tk.TB, n // tk.TN) < 0.7).astype(np.int32))
    douts = [torch.as_tensor(rng.randn(b, (1 + d) * vdim).astype(np.float32))
             for _ in range(2)]
    rad = torch.as_tensor(rng.rand(n).astype(np.float32))
    return (tmask, x, muT, ppT, v), douts, rad


def _lists(tmask, cap=None):
    """The transposed work list of ``tmask`` (``ok`` 0 when ``cap`` is too
    small to hold every live pair)."""
    _, _, gt, qt, ok = tf._cells_lists(
        tmask, cap or tf._cells_cap(*tmask.shape))
    return gt, qt, ok


BAD_FWD_SPLITS = [0, 3, 16, -1, (2, 1), "2", 2.0, True, [2]]


@pytest.mark.parametrize("bad", BAD_FWD_SPLITS)
def test_fwd_refuses_a_split_the_kernel_does_not_take(bad):
    args, _, rad = _cpu_inputs()
    tk.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tk.gsr_fwd(*args, 0.01, 3, rad, split=bad)
    assert not any(tk.launches.values()) and not tk.fwd_shapes


BAD_RADII = {"short": lambda r: r[:-1],
             "long": lambda r: torch.cat([r, r[:1]]),
             "2-D": lambda r: r[:, None], "none": lambda r: None,
             "array": lambda r: r.numpy()}


@pytest.mark.parametrize("bad", list(BAD_RADII))
def test_wrappers_refuse_radii_of_other_rows(bad):
    """Both wrappers that read radii refuse any but (N,) tensors before any
    launch, on a CPU tensor too, where the plain twin would not read
    them."""
    args, douts, rad = _cpu_inputs()
    r = BAD_RADII[bad](rad)
    gt, qt, ok = _lists(args[0])
    tk.reset_launches()
    tc.reset_launches()
    with pytest.raises(ValueError, match="rad"):
        tk.gsr_fwd(*args, 0.01, 3, r)
    with pytest.raises(ValueError, match="rad"):
        tc.cells_bwd_dn(gt, qt, ok, *args, douts[0], 0.01, 3, r)
    assert not any(tk.launches.values()) and not any(tc.launches.values())


@pytest.mark.parametrize("bad", [(3, 1), (1, 16), (0, 0), (2,), [2, 2],
                                 "2x2"])
def test_cells_bwd_refuses_a_split_the_kernel_does_not_take(bad):
    args, douts, rad = _cpu_inputs()
    gt, qt, ok = _lists(args[0])
    tc.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tc.cells_bwd_dn(gt, qt, ok, *args, douts[0], 0.01, 3, rad,
                        split=bad)
    assert not any(tc.launches.values())


@pytest.mark.parametrize("bad", list(BAD_RADII))
def test_cells_bwd_dn2_refuses_radii_of_other_rows(bad):
    """Row 6 reads the radii of row 7's box test, and refuses them alike."""
    args, douts, rad = _cpu_inputs()
    gt, qt, ok = _lists(args[0])
    tc.reset_launches()
    with pytest.raises(ValueError, match="rad"):
        tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, 0.01, 3,
                         BAD_RADII[bad](rad))
    assert not any(tc.launches.values())


@pytest.mark.parametrize("bad", [(3, 1), (1, 16), (0, 0), (2,), [2, 2],
                                 "2x2"])
def test_cells_bwd_dn2_refuses_a_split_the_kernel_does_not_take(bad):
    args, douts, rad = _cpu_inputs()
    gt, qt, ok = _lists(args[0])
    tc.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, 0.01, 3, rad,
                         split=bad)
    assert not any(tc.launches.values())


@pytest.fixture
def one_thread():
    """One CPU thread: the plain twins' matrix products then sum in one
    order from call to call (with several they need not), so a wrapper on
    a CPU tensor and its plain twin can be held bitwise equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("split", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("njac", [0, 3])
def test_fwd_split_on_the_cpu_is_the_plain_twin(one_thread, split, njac):
    """On a CPU tensor a valid split takes the plain version, which reads
    no radius (any radii of the right shape give the same field), and
    launches nothing."""
    args, _, rad = _cpu_inputs()
    tk.reset_launches()
    want = tk.fwd_plain(*args, 0.01, njac)
    assert float(want.abs().max()) > 0
    _same([tk.gsr_fwd(*args, 0.01, njac, rad, split=split)], [want])
    _same([tk.gsr_fwd(*args, 0.01, njac, -torch.ones_like(rad),
                      split=split)], [want])
    assert not any(tk.launches.values()) and not tk.fwd_shapes


@pytest.mark.parametrize("split", [None, (1, 1), (2, 1), (8, 8)])
@pytest.mark.parametrize("overflow", [False, True])
def test_cells_bwd_split_on_the_cpu_is_the_plain_twin(one_thread, split,
                                                     overflow):
    """The same for the cells backward, on its lists and, overflowed, on
    the mask; its plain twin reads no radius either."""
    args, douts, rad = _cpu_inputs()
    gt, qt, ok = _lists(args[0], 3 if overflow else None)
    assert int(ok) == (0 if overflow else 1)
    tc.reset_launches()
    want = tc.cells_bwd_dn_plain(gt, qt, ok, *args, douts[0], 0.01, 3)
    assert float(want[0].abs().max()) > 0
    for r in (rad, -torch.ones_like(rad)):
        _same(tc.cells_bwd_dn(gt, qt, ok, *args, douts[0], 0.01, 3, r,
                              split=split), want)
    assert not any(tc.launches.values())


def _run_shares_direct(gt, qt, ok, tmask, split):
    """Per Gaussian tile and worker, the live query tiles of the kernel's
    loop: the run's items (or, on overflow, the mask column) in windows of
    BWD_WINDOW candidates, each window's live tiles compacted in order,
    worker u taking [u L / U, (u + 1) L / U)."""
    u_all = split[0] * split[1]
    nbt, nnt = tmask.shape
    gt, qt, tm = gt.numpy(), qt.numpy(), tmask.numpy()
    out = np.zeros((nnt, u_all), np.int64)
    for j in range(nnt):
        if int(ok):
            items = qt[gt == j]
            cand = [items[b:b + tc.BWD_WINDOW]
                    for b in range(0, len(items), tc.BWD_WINDOW)]
            windows = []
            for c in cand:   # the run ends at its first dead item
                dead = np.flatnonzero(c < 0)
                windows.append(c[:dead[0]] if len(dead) else c)
                if len(dead):
                    break
        else:
            windows = [np.flatnonzero(tm[b:b + tc.BWD_WINDOW, j])
                       for b in range(0, nbt, tc.BWD_WINDOW)]
        for live in windows:
            for u in range(u_all):
                lo = u * len(live) // u_all
                hi = (u + 1) * len(live) // u_all
                out[j, u] += hi - lo
    return out


@pytest.mark.parametrize("nbt", [1, 7, 64, tc.BWD_WINDOW,
                                 tc.BWD_WINDOW + 900])
@pytest.mark.parametrize("split", [(1, 1), (2, 1), (4, 2), (8, 8)])
@pytest.mark.parametrize("overflow", [False, True])
def test_run_worker_tiles_are_the_kernels_equal_shares(nbt, split,
                                                       overflow):
    rng = np.random.RandomState(nbt)
    tmask = torch.as_tensor((rng.rand(nbt, 5) < 0.3).astype(np.int32))
    tmask[:, 0] = 0           # an empty column
    tmask[:, 1] = 1           # a fully live column
    gt, qt, ok = _lists(tmask, 2 if overflow else None)
    assert int(ok) == (0 if overflow else 1)
    got = tc.run_worker_tiles(gt, qt, ok, tmask, split)
    assert torch.equal(got, torch.as_tensor(
        _run_shares_direct(gt, qt, ok, tmask, split)))
    assert torch.equal(got.sum(1), tmask.sum(0).to(torch.int64))
    if nbt <= tc.BWD_WINDOW:  # one window: shares differ by at most one
        assert int((got.max(1).values - got.min(1).values).max()) <= 1


@pytest.mark.parametrize("split", [None, (1, 1), (2, 1), (8, 8)])
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("use_val", [True, False])
def test_cells_bwd_dn2_split_on_the_cpu_is_the_plain_twin(
        one_thread, split, overflow, use_val):
    """Row 6 on a CPU tensor: any valid split and any radii take its plain
    twin, on the lists and, overflowed, on the mask."""
    args, douts, rad = _cpu_inputs()
    gt, qt, ok = _lists(args[0], 3 if overflow else None)
    assert int(ok) == (0 if overflow else 1)
    tc.reset_launches()
    want = tc.cells_bwd_dn2_plain(gt, qt, ok, *args, *douts, 0.01, 3,
                                  use_val)
    assert float(want[1][0].abs().max()) > 0
    for r in (rad, -torch.ones_like(rad)):
        got = tc.cells_bwd_dn2(gt, qt, ok, *args, *douts, 0.01, 3, r,
                               use_val, split=split)
        _same(got[0] + got[1], want[0] + want[1])
    assert not any(tc.launches.values())
