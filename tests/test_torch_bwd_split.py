"""The centered parameter backwards' split along the query axis, on the
CPU: the host rule ``bwd_split`` at the main paths' shapes and for other
SM counts, its limits (never more workers than query tiles, only the
splits the kernel takes), the workers' shares of the live query tiles
(``worker_tiles``, the kernel's equal contiguous shares of each window's
compacted list) against a direct count, also on the triple backward's
fused [data; boundary] mask at Karman-2D, and the wrappers' refusal of a
forced split the kernel does not take, before any launch — for dL/dx
(split S along the Gaussian axis) and the triple backward too, with
dL/dx's refusal of bad radii. The kernels at every split against their
plain twins are in tests/test_torch_cuda.py, which runs on the card."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import gsr_centered as tk

from torch_parity import karman_heads_geometry

H100_SMS = 132

# (nbt, nnt) of the main paths: B = 8192 or 512 queries in tiles of 8,
# N = 1024, 6144 or 75,776 Gaussian rows in tiles of 64.
LEAPFROG_3D = (1024, 16)
LEAPFROG_2D = (64, 96)
RING_COLLIDE = (1024, 1184)


@pytest.mark.parametrize("shape, want", [
    (LEAPFROG_3D, (8, 8)),
    (LEAPFROG_2D, (4, 1)),
    (RING_COLLIDE, (2, 1)),
])
def test_bwd_split_at_the_main_shapes(shape, want):
    assert tk.bwd_split(*shape, H100_SMS) == want


@pytest.mark.parametrize("sms, shape, want", [
    (16, LEAPFROG_3D, (8, 2)),
    (16, LEAPFROG_2D, (4, 1)),
    (16, RING_COLLIDE, (1, 1)),
    (264, LEAPFROG_3D, (8, 8)),
    (264, LEAPFROG_2D, (4, 1)),
    (264, RING_COLLIDE, (4, 1)),
    (1, (64, 1), (4, 1)),
    (1, (3, 1), (1, 1)),
])
def test_bwd_split_follows_the_sm_count(sms, shape, want):
    assert tk.bwd_split(*shape, sms) == want


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
def test_bwd_split_never_asks_for_more_workers_than_query_tiles(sms):
    for nbt in list(range(0, 70)) + [127, 128, 129, 1000, 1024, 5000]:
        for nnt in (1, 2, 16, 96, 1184, 5000):
            w, s = tk.bwd_split(nbt, nnt, sms)
            assert w in tk.SPLIT_W and s in tk.SPLIT_S
            assert w * s <= max(nbt, 1), (nbt, nnt, sms, w, s)
            assert w * s == 1 or nbt >= 16 * w * s


@pytest.mark.parametrize("sms", [16, 132])
def test_bwd_split_fills_the_card_where_the_tiles_allow(sms):
    """With query tiles to spare: 32 warps an SM (a worker is two warps)
    or the largest split, workers within a block before blocks of a
    cluster, and the smallest split that does."""
    for nnt in (1, 16, 96, 400, 1184):
        w, s = tk.bwd_split(1 << 20, nnt, sms)
        assert 2 * nnt * w * s >= 32 * sms or (w, s) == (8, 8)
        assert s == 1 or w == tk.SPLIT_W[-1]
        if w * s > 1:
            assert 2 * nnt * w * s // 2 < 32 * sms


def _shares_direct(tmask, split):
    """Per column and worker, the live tiles of the kernel's loop: each
    LIST_CAP window compacted in order, worker u taking
    [u L / U, (u + 1) L / U)."""
    w, s = split
    u_all = w * s
    tm = tmask.numpy()
    out = np.zeros((tm.shape[1], u_all), np.int64)
    for j in range(tm.shape[1]):
        for base in range(0, tm.shape[0], tk.LIST_CAP):
            live = np.flatnonzero(tm[base:base + tk.LIST_CAP, j])
            for u in range(u_all):
                lo = u * len(live) // u_all
                hi = (u + 1) * len(live) // u_all
                out[j, u] += hi - lo
    return out


@pytest.mark.parametrize("nbt", [1, 7, 64, 1024, tk.LIST_CAP + 900])
@pytest.mark.parametrize("split", [(1, 1), (4, 2), (8, 8)])
def test_worker_tiles_are_the_kernels_equal_shares(nbt, split):
    rng = np.random.RandomState(nbt)
    tmask = torch.as_tensor((rng.rand(nbt, 5) < 0.3).astype(np.int32))
    tmask[:, 0] = 0           # an empty column
    tmask[:, 1] = 1           # a fully live column
    got = tk.worker_tiles(tmask, split)
    assert torch.equal(got, torch.as_tensor(_shares_direct(tmask, split)))
    assert torch.equal(got.sum(1), tmask.sum(0).to(torch.int64))
    if nbt <= tk.LIST_CAP:    # one window: shares differ by at most one
        assert int((got.max(1).values - got.min(1).values).max()) <= 1


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
    return (tmask, x, muT, ppT, v), douts


BAD_SPLITS = [(3, 1), (1, 3), (0, 1), (16, 1), (1, 16), (2,), (2, 2, 1),
              [2, 2], "4x4"]


@pytest.mark.parametrize("bad", BAD_SPLITS)
def test_wrappers_refuse_a_split_the_kernel_does_not_take(bad):
    args, douts = _cpu_inputs()
    tk.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tk.gsr_bwd_dn(*args, douts[0], 0.01, 3, split=bad)
    with pytest.raises(ValueError, match="split"):
        tk.gsr_bwd_dn2(*args, *douts, 0.01, 3, split=bad)
    assert not any(tk.launches.values())


def _same(got, want):
    """Equal up to the CPU's own summation order: its matrix products may
    round differently from one call to the next (1e-6 of the largest
    entry)."""
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


@pytest.mark.parametrize("split", [None, (1, 1), (8, 8)])
def test_split_on_the_cpu_is_the_plain_twin(split):
    """On a CPU tensor a valid split takes the plain version and launches
    nothing."""
    args, douts = _cpu_inputs()
    tk.reset_launches()
    _same(tk.gsr_bwd_dn(*args, douts[0], 0.01, 3, split=split),
          tk.bwd_dn_plain(*args, douts[0], 0.01, 3))
    got = tk.gsr_bwd_dn2(*args, *douts, 0.01, 3, use_val=False, split=split)
    want = tk.bwd_dn2_plain(*args, *douts, 0.01, 3, use_val=False)
    _same(got[0] + got[1], want[0] + want[1])
    assert not any(tk.launches.values())


# ---- rows 4 (dL/dx) and 10 (the triple backward) ----

def _dn3_args():
    """The small CPU inputs with a value-only cotangent for the triple
    backward (blocks 1 and 2 on the first 32 rows, block 3 on the rest)
    and rows' radii for dL/dx's box test."""
    args, douts = _cpu_inputs()
    dout3 = douts[0][:, :3].contiguous()
    rad = torch.full((args[2].shape[1],), 0.5)
    return args, douts, dout3, rad


BAD_FWD_SPLITS = [0, 3, 16, -1, (2, 1), [4], "4", 2.0, True]


@pytest.mark.parametrize("bad", BAD_SPLITS)
def test_dn3_refuses_a_split_the_kernel_does_not_take(bad):
    args, douts, dout3, _ = _dn3_args()
    tk.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tk.gsr_bwd_dn3(*args, *douts, dout3, 0.01, 3, 32, split=bad)
    assert not any(tk.launches.values())


@pytest.mark.parametrize("bad", BAD_FWD_SPLITS)
def test_dx_refuses_a_split_the_kernel_does_not_take(bad):
    args, douts, _, rad = _dn3_args()
    tk.reset_launches()
    with pytest.raises(ValueError, match="split"):
        tk.gsr_bwd_dx(*args, douts[0], 0.01, 3, rad, split=bad)
    assert not any(tk.launches.values())


@pytest.mark.parametrize("bad", ["short", "long", "matrix", "none", "list"])
def test_dx_refuses_bad_radii(bad):
    args, douts, _, rad = _dn3_args()
    bad_rad = {"short": rad[:-1], "long": torch.cat([rad, rad[:1]]),
               "matrix": rad[:, None], "none": None,
               "list": rad.tolist()}[bad]
    tk.reset_launches()
    with pytest.raises(ValueError, match="rad"):
        tk.gsr_bwd_dx(*args, douts[0], 0.01, 3, bad_rad)
    assert not any(tk.launches.values())


@pytest.mark.parametrize("split", [None, 1, 8])
def test_dx_split_on_the_cpu_is_the_plain_twin(split):
    args, douts, _, rad = _dn3_args()
    tk.reset_launches()
    for njac, dout in ((3, douts[0]), (0, douts[0][:, :3].contiguous())):
        _same([tk.gsr_bwd_dx(*args, dout, 0.01, njac, rad, split=split)],
              [tk.bwd_dx_plain(*args, dout, 0.01, njac)])
    assert not any(tk.launches.values())


@pytest.mark.parametrize("split", [None, (1, 1), (8, 1), (8, 8)])
def test_dn3_split_on_the_cpu_is_the_plain_twin(split):
    args, douts, dout3, _ = _dn3_args()
    tk.reset_launches()
    for use_val12 in (True, False):
        got = tk.gsr_bwd_dn3(*args, *douts, dout3, 0.01, 3, 32,
                             use_val12=use_val12, split=split)
        want = tk.bwd_dn3_plain(*args, *douts, dout3, 0.01, 3, 32,
                                use_val12=use_val12)
        _same([t for blk in got for t in blk],
              [t for blk in want for t in blk])
    assert not any(tk.launches.values())


@pytest.mark.parametrize("split", [(1, 1), (8, 1), (4, 2), (2, 8), (8, 8)])
def test_worker_tiles_give_each_fused_karman_tile_to_one_worker(split):
    """The triple backward's mask at the smoke's Karman-2D shapes (512
    data rows, 3072 boundary rows: 448 query tiles, one window): each
    column's compacted live query tiles cut into the kernel's contiguous
    shares go to exactly one worker each, in order, and ``worker_tiles``
    counts those shares. Its busiest column holds ~7 times the mean."""
    tmask = karman_heads_geometry()[7]
    assert tmask.shape == (448, 384) and tmask.shape[0] <= tk.LIST_CAP
    u_all = split[0] * split[1]
    got = tk.worker_tiles(tmask, split)
    live = tmask != 0
    for j in range(tmask.shape[1]):
        tiles = torch.nonzero(live[:, j]).flatten().tolist()
        owner = []
        for u in range(u_all):
            lo, hi = u * len(tiles) // u_all, (u + 1) * len(tiles) // u_all
            owner += [u] * (hi - lo)
            assert int(got[j, u]) == hi - lo
        assert owner == sorted(owner) and len(owner) == len(tiles)
    per_col = live.sum(0)
    assert int(per_col.max()) >= 6 * float(per_col.double().mean())
    assert int(got.sum()) == int(live.sum())
