"""The port's bound model (``gaussian_fluids_torch/utils/roofline.py``)
against the JAX package's ``utils/roofline.py``: every count under a
shared name, the epoch FLOPs, the reference's modelled bounds and its pair
statistics equal on the same inputs (integers exactly, floats within
1e-12 relative), the tile fraction of the port's mask against the JAX
mask's, and ``chip_smoke.py``'s bound model the module's own objects."""

import importlib.util
import os

import numpy as np
import pytest

from gaussian_fluids_torch.utils import roofline as tr
from torch_parity import jax_mixture, jax_mixture_3d, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DV = [(2, 2), (3, 3), (2, 3), (3, 1)]


def _jr():
    from gaussian_fluids_tpu.utils import roofline
    return roofline


@pytest.mark.parametrize("d,vdim", DV)
def test_per_pair_counts_equal_the_jax_counts(d, vdim):
    jr = _jr()
    assert tr.tile_quantities_flops(d) == jr.tile_quantities_flops(d)
    assert tr.dxj_flops(d) == jr.dxj_flops(d)
    for name in ("value_only_flops_per_pair", "bwd_cotangent_flops",
                 "bwd_dx_flops_per_pair", "bwd_dn_flops_per_pair"):
        assert getattr(tr, name)(d, vdim) == getattr(jr, name)(d, vdim), name
    for njac in (None, 0, 1, d):
        assert tr.fwd_flops_per_pair(d, vdim, njac) == \
            jr.fwd_flops_per_pair(d, vdim, njac)
    assert tr.DUAL_FACTOR == jr.DUAL_FACTOR


@pytest.mark.parametrize("b,n,density", [(512, 6144, 0.11),
                                         (8192, 75776, 0.012),
                                         (8192, 1024, 0.5)])
def test_epoch_flops_equal_the_jax_formula(b, n, density):
    jr = _jr()
    for ours, theirs in ((tr.projection_epoch_cost_2d,
                          jr.projection_epoch_cost_2d),
                         (tr.projection_epoch_cost_3d,
                          jr.projection_epoch_cost_3d)):
        a, w = ours(b, n, density), theirs(b, n, density)
        assert a.flops == pytest.approx(w.flops, rel=1e-12)
        assert a.pairs == pytest.approx(w.pairs, rel=1e-12)
        # bytes on need, the epoch's rk4_evals + 4 launches
        d = 2 if ours is tr.projection_epoch_cost_2d else 3

        def lb(**kw):
            return tr.launch_bytes(b, n, d, d, **kw)

        assert a.hbm_bytes == (6 * lb(out_cols=(1 + d) * d)
                               + lb(cot_blocks=2) + lb(out_cols=d)
                               + lb(cot_blocks=1))


def test_utilization_reads_the_h100_peaks():
    c = tr.EpochCost(flops=67e12, hbm_bytes=3.35e12, pairs=1.0)
    u = c.utilization(0.5)
    assert u["achieved_tflops"] == pytest.approx(33.5)
    assert u["mfu_fp32_pct"] == pytest.approx(50.0)
    assert u["mfu_bf16_pct"] == pytest.approx(100 * 33.5e12 / 989e12)
    assert u["hbm_gbps"] == pytest.approx(1675.0)
    assert u["hbm_pct"] == pytest.approx(50.0)
    assert set(tr.PEAKS) == {"h100"}


def test_reference_bounds_equal_the_jax_model():
    jr = _jr()
    assert tr.reference_gpu_bound_2d() == jr.reference_gpu_bound_2d()
    for args in ((197e3, 43e3, 1.63e6), (1.0, 0.0, 10.0), (5e7, 1e6, 1e9)):
        a, w = tr.reference_gpu_bound_3d(*args), jr.reference_gpu_bound_3d(
            *args)
        np.testing.assert_allclose(a, w, rtol=1e-12, atol=0)


def test_pair_stats_3d_equal_the_jax_counts():
    jr = _jr()
    mix, spec = jax_mixture_3d(200, seed=3, scale_shift=1.5)
    rng = np.random.RandomState(4)
    x = rng.uniform(0.0, 1.0, (96, 3)).astype(np.float32)
    xb = rng.uniform(0.0, 1.0, (40, 3)).astype(np.float32)
    tmix, tspec = to_torch(mix, spec)
    want = jr.measured_pair_stats_3d(mix, spec, x, boundary_x=xb)
    got = tr.measured_pair_stats_3d(tmix, tspec, x, boundary_x=xb)
    assert got == want
    assert want[1] > 0 and want[2] > 0
    assert tr.measured_pair_stats_3d(tmix, tspec, x)[2] == 0.0


@pytest.mark.parametrize("dim", [2, 3])
def test_tile_density_equals_the_jax_mask_fraction(dim):
    jr = _jr()
    if dim == 2:
        mix, spec = jax_mixture(1000, seed=5)
        mix = mix.spatially_sorted()
        x = np.random.RandomState(6).uniform(-5, 5, (300, 2))
    else:
        mix, spec = jax_mixture_3d(300, seed=7)
        x = np.random.RandomState(8).uniform(0, 1, (300, 3))
    x = x.astype(np.float32)
    tmix, tspec = to_torch(mix, spec)
    for tb, tn in ((8, 64), (16, 128)):
        want = jr.measured_tile_density(mix, spec, x, tb=tb, tn=tn)
        got = tr.measured_tile_density(tmix, tspec, x, tb=tb, tn=tn)
        # the same tiles live: the JAX fraction is an f32 mean
        tiles = -(-x.shape[0] // tb) * (tmix.capacity // tn)
        assert abs(got - want) * tiles < 0.5
        assert 0.0 < got < 1.0


def test_support_density_counts_the_dense_mask():
    import jax.numpy as jnp
    from gaussian_fluids_tpu.ops import field as jfield
    mix, spec = jax_mixture_3d(300, seed=9)
    x = np.random.RandomState(10).uniform(0, 1, (200, 3)).astype(np.float32)
    tmix, tspec = to_torch(mix, spec)
    hits = int(np.asarray(jfield.masked_kernel(mix, spec,
                                               jnp.asarray(x))[1]).sum())
    want = hits / (200 * int(np.asarray(mix.alive).sum()))
    assert tr.measured_support_density(tmix, tspec, x, chunk=64) == \
        pytest.approx(want, rel=1e-12)


def test_kernel_bound_and_pair_ops():
    need, walked = tr.pair_ops(15, 17, walked_pairs=1000, support_pairs=100)
    assert (need, walked) == (3200, 15 * 1000 + 17 * 100)
    ms, by = tr.kernel_bound(67e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = tr.kernel_bound(1.0, 3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"


def test_chip_smoke_takes_the_modules_bound_model():
    """The smoke's bounds come from this module, with the counts and peaks
    every earlier row's bound_ms was computed with."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("OPS_GEOMETRY", "OPS_SUPPORT", "OPS_BANDED_WINDOW",
                 "OPS_BANDED_SUPPORT", "pair_ops", "kernel_bound"):
        assert getattr(cs, name) is getattr(tr, name), name
    assert not any(hasattr(cs, n) for n in ("_bound", "PEAK_F32_FLOPS",
                                            "PEAK_BYTES_PER_S"))
    assert (tr.PEAK_F32_FLOPS, tr.PEAK_BYTES_PER_S) == (67e12, 3.35e12)
    assert tr.OPS_GEOMETRY == {2: 15, 3: 27}
    assert tr.OPS_SUPPORT == {
        (2, "fwd"): 17, (2, "bwd_dn"): 74, (2, "bwd_dn2"): 126,
        (3, "fwd"): 34, (3, "bwd_dn"): 136, (3, "bwd_dn2"): 272,
        (2, "bwd_dx"): 36, (3, "bwd_dx"): 65, (2, "bwd_dn_val"): 28,
        (3, "bwd_dn_val"): 46, (2, "rk4_stage"): 5, (3, "rk4_stage"): 7}
    assert (tr.OPS_BANDED_WINDOW, tr.OPS_BANDED_SUPPORT) == (22, 10)
