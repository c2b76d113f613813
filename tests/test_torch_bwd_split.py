"""The centered parameter backwards' split along the query axis, on the
CPU: the host rule ``bwd_split`` at the main paths' shapes and for other
SM counts, its limits (never more workers than query tiles, only the
splits the kernel takes), the workers' shares of the live query tiles
(``worker_tiles``, the kernel's equal contiguous shares of each window's
compacted list) against a direct count, and the wrappers' refusal of a
forced split the kernel does not take, before any launch. The kernel at
every split against its plain twin is in tests/test_torch_cuda.py, which
runs on the card."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import gsr_centered as tk

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
