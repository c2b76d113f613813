"""``--target_grid``: the port's grid interpolation and cached-target grids
against the JAX package's — ``bilinear_interp`` and
``multi_channel_interp``, each runner's ``target_grid_fn`` (2D projection
on a moved Karman box, 3D projection, the clone in 2D and 3D), one
projection epoch on interpolated targets, the interpolated targets
against the exact ones (on a smooth field, and on the committed
Ring-Collide fit beside the JAX package's own reading), and the grid mode
end to end."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import interp as ti
from gaussian_fluids_torch.scenes import get_scene_2d as tscene
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_torch.solver import covector as tcov
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.models.mixture import GaussianMixture as JMix
from gaussian_fluids_tpu.ops import interp as ji
from gaussian_fluids_tpu.scenes import get_scene_2d as jscene
from gaussian_fluids_tpu.solver import clone as jclone
from gaussian_fluids_tpu.solver import covector as jcov
from gaussian_fluids_tpu.solver import project as jproj

from torch_parity import (close, jax_mixture, jax_mixture_3d, jopt_warm,
                          params_close, t, to_torch, topt_warm)

R = np.random.RandomState
DOM2 = (-1.0, 3.0, -0.5, 2.5)
DOM3 = (0.0, 1.0, -0.5, 0.5, 0.2, 1.4)
RC_FIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "runs_r2_evidence", "ckpts", "output_3d_ring_collide",
                      "gaussian_velocity_0.pt")


@pytest.fixture
def centered(monkeypatch):
    """Both packages on their centered paths: the JAX package's Pallas
    kernels in interpret mode (its runners rebuilt), the port's plain
    twins. The grids' nodes come from jnp.linspace and torch.linspace,
    which round some nodes differently by an ulp; the dense paths'
    expanded quadratic form turns that into ~1e-4 of an entry, the
    centered form into ~1e-7."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    for f in (jproj._runner_2d, jproj._runner_3d, jclone._clone_runner):
        f.cache_clear()
    yield
    for f in (jproj._runner_2d, jproj._runner_3d, jclone._clone_runner):
        f.cache_clear()


def _rel_close(got, want, tol):
    """|got - want| <= tol * max|want| (the grid tests' measure)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# ---- interpolation ----

INTERP_2D = ["scalar", "channels", "tensor_domain", "outside"]


@pytest.mark.parametrize("case", INTERP_2D)
def test_bilinear_interp_matches(case):
    r = R(INTERP_2D.index(case))
    shape = (17, 13) + ((5,) if case == "channels" else ())
    f = r.randn(*shape).astype(np.float32)
    lo, hi = (-1.0, -0.5), (3.0, 2.5)
    if case == "outside":
        lo, hi = (-2.0, -1.5), (4.0, 3.5)   # points beyond the grid clamp
    x = r.uniform(lo, hi, (400, 2)).astype(np.float32)
    if case == "tensor_domain":
        # 0-d f32 scalars, as Karman's moving advance box hands them in
        dom_t = tuple(torch.tensor(v, dtype=torch.float32) for v in DOM2)
        dom_j = tuple(jnp.float32(v) for v in DOM2)
    else:
        dom_t = dom_j = DOM2
    want = ji.bilinear_interp(jnp.asarray(f), jnp.asarray(x), dom_j) \
        if f.ndim == 2 else ji.multi_channel_interp(
            jnp.asarray(f), jnp.asarray(x), dom_j)
    got = ti.bilinear_interp(t(f), t(x), dom_t)
    close(got, want, 1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_multi_channel_interp_matches(d):
    r = R(10 + d)
    shape = (9, 11, 7)[:d] + (4 if d == 3 else 6,)
    f = r.randn(*shape).astype(np.float32)
    dom = DOM2 if d == 2 else DOM3
    x = r.uniform(dom[0::2], dom[1::2], (300, d)).astype(np.float32)
    got = ti.multi_channel_interp(t(f), t(x), dom)
    close(got, ji.multi_channel_interp(jnp.asarray(f), jnp.asarray(x), dom),
          1e-6)
    # channel by channel, the scalar interpolation gives the same bits
    one = ti.bilinear_interp if d == 2 else ti.trilinear_interp
    for c in range(shape[-1]):
        assert torch.equal(got[:, c], one(t(f[..., c]), t(x), dom))


# ---- the cached-target grids ----

def _karman_mix(seed):
    """A small seeded mixture over the Karman scaled domain."""
    js = jscene("karman")
    sf = js.scaling_factor
    x0, x1, y0, y1 = js.initialize_domain
    return jax_mixture(200, seed, lo=x0 * sf, hi=x1 * sf,
                       spread=0.45 * (x1 - x0) * sf,
                       center=0.5 * (x0 + x1) * sf)


@pytest.mark.parametrize("scene_name,frame", [("taylor_green", 0),
                                              ("karman", 0), ("karman", 40)])
def test_projection_2d_grid_matches(centered, scene_name, frame):
    """The exact covector targets on a 24 x 20 grid over the scaled advance
    box (at Karman frame 40 the box has moved), against the JAX
    package's, to 1e-5 of the largest entry."""
    scene = jscene(scene_name)
    if scene_name == "karman":
        jm, spec = _karman_mix(41)
    else:
        jm, spec = jax_mixture(300, 42, lo=0.0, hi=10.0, spread=4.8,
                               center=5.0)
    tm, ts = to_torch(jm, spec)
    adv = np.float32(scene.advance_domain_at(frame, 0.05))
    assert frame == 0 or adv[0] > scene.advance_domain[0]
    jr = jproj._runner_2d(spec, scene_name, jproj.ProjectWeights(), 1.0, 64,
                          (24, 20))
    want = jr[3](jm.params(), jm.alive, jnp.asarray(adv), jnp.float32(0.05))
    tr = tproj._runner_2d(ts, scene_name, tproj.ProjectWeights(), 1.0, 64,
                          (24, 20))
    got = tr.target_grid_fn(tm, t(adv), 0.05)
    assert tuple(got.shape) == (24, 20)
    _rel_close(got, want, 1e-5)


def test_projection_3d_grid_matches(centered):
    jm, spec = jax_mixture_3d(300, 43, 0.0)
    tm, ts = to_torch(jm, spec)
    lo, hi = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    jr = jproj._runner_3d(spec, None, jproj.ProjectWeights(), 0.0, 64, lo,
                          hi, (10, 9, 8))
    want = jr[3](jm.params(), jm.alive, jnp.float32(0.02))
    tr = tproj._runner_3d(ts, None, tproj.ProjectWeights(), 0.0, 64, lo, hi,
                          (10, 9, 8))
    got = tr.target_grid_fn(tm, 0.02)
    assert tuple(got.shape) == (10, 9, 8, 4)
    _rel_close(got[..., :3], want[..., :3], 1e-5)
    _rel_close(got[..., 3], want[..., 3], 1e-5)


@pytest.mark.parametrize("d", [2, 3])
def test_clone_grid_matches(centered, d):
    """The old field's [val, jac] channels (vdim + vdim * d) on the clone's
    grid over (lo, hi)."""
    if d == 2:
        jm, spec = jax_mixture(300, 44, lo=0.0, hi=10.0, spread=4.8,
                               center=5.0)
        lo, hi, res = (0.5, 1.0), (9.0, 8.5), (21, 17)
    else:
        jm, spec = jax_mixture_3d(300, 45, 0.0)
        lo, hi, res = (0.0, 0.1, 0.0), (1.0, 0.9, 1.0), (9, 8, 7)
    tm, ts = to_torch(jm, spec)
    want = jclone._clone_runner(spec, 64, res)[3](
        jm.params(), jm.alive, jnp.asarray(lo, jnp.float32),
        jnp.asarray(hi, jnp.float32))
    got = tclone._clone_runner(ts, 64, lo, hi,
                               res).target_grid_fn(tm)
    assert tuple(got.shape) == res + (d + d * d,)
    _rel_close(got[..., :d], want[..., :d], 1e-5)
    _rel_close(got[..., d:], want[..., d:], 1e-5)


# ---- interpolated targets in use ----

def test_projection_epoch_on_interpolated_targets_matches():
    """One 2D projection epoch in grid mode: the JAX package's scan epoch
    (its grid in the carry, bilinear per batch) against the port's epoch
    fed the port's grid interpolated at the same draws."""
    jm, spec = jax_mixture(576, 46, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    old_j, _ = jax_mixture(576, 47, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    tm, ts = to_torch(jm, spec)
    old_t, _ = to_torch(old_j, spec)
    scene = jscene("taylor_green")
    sf = scene.scaling_factor
    w = jproj.ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                             delta_pos=0.5)
    jr = jproj._runner_2d(spec, "taylor_green", w, 1.0, 512, (32, 32))
    tr = tproj._runner_2d(ts, "taylor_green", tproj.ProjectWeights(*w[:5]),
                          1.0, 512, (32, 32))
    adv = np.float32(scene.advance_domain)
    dt = 0.05
    lrs = dict(jproj.DEFAULT_LRS_2D)
    jtgt = jr[3](old_j.params(), old_j.alive, jnp.asarray(adv),
                 jnp.float32(dt))
    ttgt = tr.target_grid_fn(old_t, t(adv), dt)
    pos0 = np.asarray(jm.positions) + np.float32(0.01)
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          jnp.asarray(pos0), old_j.params(), old_j.alive, jnp.asarray(adv),
          jnp.float32(dt), jtgt)
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, t(pos0), old_t,
          t(adv), dt)
    key = jax.random.PRNGKey(48)
    kd, _, kb2 = jax.random.split(jax.random.split(key, 1)[0], 3)
    lo = np.float32([adv[0], adv[2]]) * sf
    hi = np.float32([adv[1], adv[3]]) * sf
    data = t(jax.random.uniform(kd, (512, 2), jnp.float32) * (hi - lo) + lo)
    from gaussian_fluids_torch.scenes import boundaries2d as tb2
    bnd = tb2.sample_on_domain_boundary_2(
        t(jax.random.uniform(kb2, (512,))), t(adv), sf)
    ref = ti.bilinear_interp(ttgt, data, (lo[0], hi[0], lo[1], hi[1]))
    jc, jaux = jr[0](jc, key, 1)
    tc, taux = tr.epoch(tc, (data, ref, None, bnd))
    close(taux, jaux[0], 2e-5)
    params_close(tc[0], jc[0], "grid-mode projection epoch")


def test_interpolated_targets_close_to_exact():
    """The 3D projection's grid targets interpolated at seeded points
    within 2% of the largest exact target (the JAX package's test of its
    own grid mode, tests/test_target_grid.py), on a smooth field."""
    mix, spec, _ = ring_collide_state("cpu", seed=3, side=4)
    mix.scalings -= 1.0                              # wide, smooth
    tr = tproj._runner_3d(spec, None, tproj.ProjectWeights(), 0.0, 64,
                          (0.0,) * 3, (1.0,) * 3, (40, 40, 40))
    tgt = tr.target_grid_fn(mix, 0.01)
    x = t(R(49).uniform(0.02, 0.98, (256, 3)).astype(np.float32))
    ev, eh = tcov.advected_vorticity_3d(mix, spec, x, 0.01)
    ref = ti.multi_channel_interp(tgt, x, (0, 1, 0, 1, 0, 1))
    _rel_close(ref[:, :3], ev.numpy(), 0.02)
    _rel_close(ref[:, 3], eh.numpy(), 0.02)


def test_grid_mode_runs_end_to_end(monkeypatch):
    """project_2d, project_3d and the 3D clone with ``target_grid_res``:
    the grid is computed once a call and no epoch evaluates an exact
    target (the hoist is off in grid mode, even where its gate is on: the
    field on a kernel route, GF_HOIST_TARGETS=1); finite metrics."""
    from gaussian_fluids_torch.solver import covector
    from gaussian_fluids_torch.utils.grids import (grid_points_2d,
                                                   grid_points_3d)
    from gaussian_fluids_torch.utils.seeded_state import leapfrog_state
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    monkeypatch.setenv("GF_HOIST_TARGETS", "1")
    calls = []
    for name in ("advected_vorticity_2d", "advected_vorticity_3d"):
        real = getattr(covector, name)
        monkeypatch.setattr(covector, name, lambda *a, real=real, **k: (
            calls.append(a[2].shape[0]), real(*a, **k))[1])
    mix, spec, _ = leapfrog_state("cpu", seed=5)
    scene = tscene("leapfrog")
    tx = grid_points_2d(-5, 5, -5, 5, 8, 8)
    _, last = tproj.project_2d(
        mix, spec, mix, 0.025, scene=scene, adv_domain=scene.advance_domain,
        test_x=tx, gen=torch.Generator().manual_seed(0), batch_size=128,
        max_epoch=6, check_iter=3, verbose=0, target_grid_res=16)
    assert calls == [256, 64]          # the grid once, the test grid once
    assert all(np.isfinite(v) for v in last.values())
    calls.clear()
    m3, s3, _ = ring_collide_state("cpu", seed=6, side=5)
    tx3 = grid_points_3d(0, 1, 0, 1, 0, 1, 4, 4, 4)
    _, last, _ = tproj.project_3d(
        m3, s3, m3, 0.02, domain=(0, 1, 0, 1, 0, 1), test_x=tx3,
        gen=torch.Generator().manual_seed(1), scene_name="ring_collide",
        batch_size=128, max_epoch=4, check_iter=2, verbose=0,
        target_grid_res=6)
    assert calls == [216, 64]
    assert all(np.isfinite(v) for v in last.values())
    m3.scalings[::3, 0] += 1.0          # anisotropic: the clone splits
    _, last = tclone.clone_velocity_field(
        m3, s3, lo=(0, 0, 0), hi=(1, 1, 1), test_x=tx3,
        gen=torch.Generator().manual_seed(2), seed=3, d=3, batch_size=128,
        max_epoch=4, check_iter=2, verbose=0, target_grid_res=6)
    assert last and all(np.isfinite(v) for v in last.values())


def _off_node_errors(got, want):
    """{channel: (largest, 99th percentile, mean) |interpolated - exact|
    over the largest exact entry}, as ``chip_smoke.py``'s
    ``target_grid_rc`` reads them."""
    out = {}
    for k, sl in (("vorticity", slice(0, 3)), ("helicity", slice(3, 4))):
        d = np.abs(got[:, sl] - want[:, sl]).max(-1)
        s = float(np.abs(want[:, sl]).max())
        out[k] = (d.max() / s, np.quantile(d, 0.99) / s, d.mean() / s)
    return out


def test_off_node_error_matches_jax_on_the_committed_fit():
    """The committed Ring-Collide fit (the JAX package's TPU run, frame 0:
    the field its ``--target_grid 128`` run starts from) on a 16^3 grid at
    the 128^3 grid's spacing (its nodes 48..63 on each axis) through the
    first ring: the JAX package's grid targets and trilinear interpolation
    against its exact targets at 8192 seeded points, and the port's
    against the port's. The Gaussians within 0.08 of the box are kept
    (more than the clamp reach, 0.053, plus a backtrace step), so the
    field in the box is the whole fit's. Both packages' off-node errors
    over the largest exact target agree within 1e-3 (printed: the
    method's error, not the port's)."""
    lo, hi, margin, dt = 48 / 127, 63 / 127, 0.08, 0.02
    jm, spec = jckpt.load_checkpoint(RC_FIT)
    n = int(np.asarray(jm.alive).sum())
    keep = np.all(np.abs(np.asarray(jm.positions)[:n] - (lo + hi) / 2)
                  <= (hi - lo) / 2 + margin, 1)
    jm = JMix.from_arrays(*[np.asarray(getattr(jm, k))[:n][keep] for k in (
        "positions", "scalings", "rotations", "values")], spec)
    tm, ts = to_torch(jm, spec)
    box, res, dom = (lo,) * 3, (16,) * 3, (lo, hi) * 3
    x = R(18).uniform(lo, hi, (8192, 3)).astype(np.float32)
    jg = jproj._runner_3d(spec, None, jproj.ProjectWeights(), 0.0, 64, box,
                          (hi,) * 3, res)[3](jm.params(), jm.alive,
                                             jnp.float32(dt))
    jv, jh = jcov.advected_vorticity_3d(jm, spec, jnp.asarray(x),
                                        jnp.float32(dt))
    want = _off_node_errors(
        np.asarray(ji.multi_channel_interp(jg, jnp.asarray(x), dom)),
        np.concatenate([np.asarray(jv), np.asarray(jh)[:, None]], -1))
    tg = tproj._runner_3d(ts, None, tproj.ProjectWeights(), 0.0, 64, box,
                          (hi,) * 3, res).target_grid_fn(tm, dt)
    tv, th = tcov.advected_vorticity_3d(tm, ts, t(x), dt)
    got = _off_node_errors(ti.multi_channel_interp(tg, t(x), dom).numpy(),
                           torch.cat([tv, th[:, None]], -1).numpy())
    print(f"{int(keep.sum())} Gaussians; off-node error (max, p99, mean) "
          f"JAX {want}, port {got}")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
