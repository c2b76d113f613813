"""The port's solver pieces against the JAX package on the CPU: losses,
PCGrad, the 4-group Adam with its plateau schedule, the patience loop,
scenes and boundary samplers, RK4 advection and the covector target,
splitting, and one epoch each of fit, clone re-fit and projection fed the
same sample batches (jax.random and torch draw different streams, so the
tests draw with JAX and hand the batches to the port). Tolerance 1e-5 of
the largest reference entry unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import advect as tadv
from gaussian_fluids_torch.scenes import boundaries2d as tb2
from gaussian_fluids_torch.scenes import get_scene_2d as tscene
from gaussian_fluids_torch.scenes.fields2d import taylor_green_jac_closed
from gaussian_fluids_torch.solver import advect_field as taf
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_torch.solver import covector as tcov
from gaussian_fluids_torch.solver import fit as tfit
from gaussian_fluids_torch.solver import loop as tloop
from gaussian_fluids_torch.solver import losses as tl
from gaussian_fluids_torch.solver import optim as topt
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_torch.utils.grids import grid_points_2d as tgrid
from gaussian_fluids_tpu.ops import advect as jadv
from gaussian_fluids_tpu.scenes import get_scene_2d as jscene
from gaussian_fluids_tpu.solver import advect_field as jaf
from gaussian_fluids_tpu.solver import clone as jclone
from gaussian_fluids_tpu.solver import covector as jcov
from gaussian_fluids_tpu.solver import fit as jfit
from gaussian_fluids_tpu.solver import losses as jl
from gaussian_fluids_tpu.solver import optim as jopt
from gaussian_fluids_tpu.solver import project as jproj
from gaussian_fluids_tpu.utils.grids import grid_points_2d as jgrid

from torch_parity import (close, jax_mixture, jopt_warm as _jopt,
                          params_close as _params_close, t, to_torch,
                          topt_warm as _topt)

R = np.random.RandomState


# ---- losses ----

def _jac_batch(seed=0, b=64):
    rng = R(seed)
    return (rng.randn(b, 2).astype(np.float32),
            rng.randn(b, 2, 2).astype(np.float32),
            rng.randn(b).astype(np.float32))


@pytest.mark.parametrize("name", ["curl2d", "divergence", "divergence_loss"])
def test_jac_losses_match(name):
    _, jac, _ = _jac_batch()
    close(getattr(tl, name)(t(jac)), getattr(jl, name)(jnp.asarray(jac)))


def test_data_losses_match():
    val, jac, ref = _jac_batch(1)
    val2, jac2, _ = _jac_batch(2)
    close(tl.value_loss(t(val), t(val2)), jl.value_loss(val, val2))
    close(tl.grad_loss(t(jac), t(jac2)), jl.grad_loss(jac, jac2))
    close(tl.vorticity_loss_2d(t(jac), t(ref)),
          jl.vorticity_loss_2d(jac, ref))
    close(tl.boundary_dirichlet_loss(t(val), t(val2)),
          jl.boundary_dirichlet_loss(val, val2))
    close(tl.boundary_flux_loss(t(val), t(val2), t(ref)),
          jl.boundary_flux_loss(val, val2, ref))


def test_regularizers_and_freeze_match():
    rng = R(3)
    sca = rng.uniform(0, 3, (200, 2)).astype(np.float32)
    pos = rng.randn(200, 2).astype(np.float32)
    pos0 = pos + 0.1 * rng.randn(200, 2).astype(np.float32)
    alive = rng.rand(200) > 0.2
    stop = rng.rand(200) > 0.5
    close(tl.aniso_loss(t(sca), t(alive)), jl.aniso_loss(sca, alive))
    close(tl.volume_loss(t(sca), t(alive)), jl.volume_loss(sca, alive))
    close(tl.volume_loss(t(sca), t(alive), t(stop)),
          jl.volume_loss(sca, alive, jnp.asarray(stop)))
    close(tl.delta_pos_loss(t(pos), t(pos0), t(alive)),
          jl.delta_pos_loss(pos, pos0, alive))
    # freezing: frozen rows get no gradient
    s = t(sca).requires_grad_(True)
    fz = tl.freeze_params({"scalings": s}, t(stop))["scalings"]
    (g,) = torch.autograd.grad(tl.volume_loss(fz, t(alive)), [s])
    assert torch.all(g[t(stop)] == 0) and torch.any(g[~t(stop)] != 0)


@pytest.mark.parametrize("conflict", [True, False])
def test_pcgrad_matches(conflict):
    rng = R(4)
    g1 = {k: rng.randn(50, 2).astype(np.float32) for k in ("a", "b")}
    g2 = {k: (-1 if conflict else 1) * v + 0.3 * rng.randn(50, 2)
          .astype(np.float32) for k, v in g1.items()}
    want = jl.pcgrad_combine({k: jnp.asarray(v) for k, v in g1.items()},
                             {k: jnp.asarray(v) for k, v in g2.items()})
    got = tl.pcgrad_combine({k: t(v) for k, v in g1.items()},
                            {k: t(v) for k, v in g2.items()})
    for k in want:
        close(got[k], want[k], err_msg=k)


# ---- optimizer and loop ----

def test_adam_with_plateau_matches_over_steps():
    rng = R(5)
    params = {k: rng.randn(30, 2).astype(np.float32) for k in ("p", "q")}
    lrs = {"p": 1e-2, "q": 3e-3}
    js = jopt.init({k: jnp.asarray(v) for k, v in params.items()}, lrs,
                   patience=2)
    ts = topt.init({k: t(v) for k, v in params.items()}, lrs, patience=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: t(v) for k, v in params.items()}
    # a metric that improves, then stalls: the plateau cuts the lr
    metrics = [5.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    for i, m in enumerate(metrics):
        g = {k: R(100 + i).randn(30, 2).astype(np.float32) for k in params}
        jp, js = jopt.step(js, jp, {k: jnp.asarray(v) for k, v in g.items()},
                           jnp.float32(m))
        tp, ts = topt.step(ts, tp, {k: t(v) for k, v in g.items()},
                           torch.tensor(m))
        for k in params:
            close(tp[k], jp[k], 1e-6, err_msg=f"step {i} {k}")
    jl_, tl_ = jopt.get_lrs(js), topt.get_lrs(ts)
    for k in lrs:
        assert float(tl_[k]) == pytest.approx(float(jl_[k]), rel=1e-6)
        assert float(tl_[k]) < lrs[k]          # the schedule did cut


def test_patience_and_run_chunked(capsys):
    p = tloop.Patience(0.1)
    p.update(1.0, 100)
    p.update(0.95, 100)
    assert (p.best, p.iters) == (1.0, 100)
    seen = []

    def dispatch(c, n):
        return c + n, (1.0,)

    def on_chunk(mh, n):
        seen.append(n)
        return len(seen) == 3

    carry, done = tloop.run_chunked(0, dispatch, 1000, 100, on_chunk, "t")
    assert (carry, done, seen) == (300, 300, [100, 100, 100])
    carry, done = tloop.run_chunked(0, dispatch, 250, 100,
                                    lambda *a: False, "t")
    assert (carry, done) == (250, 250)
    assert "Reached maximum" in capsys.readouterr().out
    with pytest.raises(FloatingPointError):
        tloop.run_chunked(0, lambda c, n: (c, (float("nan"),)), 200,
                          100, lambda *a: False, "t")


# ---- scenes, grids, samplers ----

def test_grid_points_match():
    np.testing.assert_array_equal(tgrid(0, 1, -2, 2, 7, 5),
                                  jgrid(0, 1, -2, 2, 7, 5))


@pytest.mark.parametrize("name", ["leapfrog", "taylor_green",
                                  "taylor_vortex", "karman"])
def test_scene_fields_match(name):
    js, ts = jscene(name), tscene(name)
    assert ts.scaling_factor == js.scaling_factor
    assert ts.particle_count == js.particle_count
    assert ts.initialize_domain == js.initialize_domain
    assert ts.advance_domain == js.advance_domain
    assert ts.visualize_domain == js.visualize_domain
    assert ts.visualize_res == js.visualize_res
    assert ts.info == js.info
    for k in ("boundary_sampler_1", "boundary_sampler_2"):
        assert (getattr(ts, k) is None) == (getattr(js, k) is None), k
    x = R(6).uniform(0, 10, (128, 2)).astype(np.float32) - \
        (0.0 if name == "taylor_green" else 5.0)
    close(ts.target_velocity(t(x)), js.target_velocity(jnp.asarray(x)))
    close(ts.target_velocity_jac(t(x)),
          js.target_velocity_jac(jnp.asarray(x)), 1e-5)
    if name == "taylor_green":
        close(ts.velocity_jac(t(x)), taylor_green_jac_closed(t(x)), 1e-6)


def test_unported_scene_is_refused():
    """Every 2D scene of the JAX package is ported; an unknown name is
    refused with the valid ones listed."""
    with pytest.raises(KeyError, match="vortices_pass_noslip"):
        tscene("vortices_pass_wide")


def test_domain_boundary_sampler_matches():
    from gaussian_fluids_tpu.scenes import boundaries2d as jb2
    key = jax.random.PRNGKey(7)
    adv = (-5.0, 5.0, -4.0, 3.0)
    jd, jn, jr = jb2.sample_on_domain_boundary_2(key, 500,
                                                 jnp.asarray(adv), 1.5)
    u = jax.random.uniform(key, (500,))
    td, tn, tr = tb2.sample_on_domain_boundary_2(t(u), t(np.float32(adv)),
                                                 1.5)
    close(td, jd)
    close(tn, jn)
    close(tr, jr)
    g = torch.Generator().manual_seed(0)
    d, n, r = tscene("leapfrog").boundary_sampler_2(g, 64, t(np.float32(adv)))
    assert d.shape == (64, 2) and n.shape == (64, 2) and r.shape == (64,)


# ---- advection, covector target, splitting ----

def _fitted_like(seed, n=500):
    jm, spec = jax_mixture(n, seed, lo=-5, hi=5)
    return jm, spec, *to_torch(jm, spec)


def test_rk4_advection_and_covector_target_match():
    jm, spec, tm, ts = _fitted_like(8)
    x = R(9).uniform(-4, 4, (200, 2)).astype(np.float32)
    close(tadv.rk4_advect(tm, ts, t(x), 0.05),
          jadv.rk4_advect(jm, spec, jnp.asarray(x), 0.05), 1e-5)
    got = tadv.rk4_advect(tm, ts, t(x), 0.05, with_deformation=True)
    want = jadv.rk4_advect(jm, spec, jnp.asarray(x), 0.05,
                           with_deformation=True)
    for g, w in zip(got, want):
        close(g, w, 2e-5)
    lo, hi = np.float32([-4.5, -4.5]), np.float32([4.5, 4.5])
    close(tcov.advected_vorticity_2d(tm, ts, t(x), 0.05, t(lo), t(hi)),
          jcov.advected_vorticity_2d(jm, spec, jnp.asarray(x), 0.05,
                                     jnp.asarray(lo), jnp.asarray(hi)),
          2e-5)


def test_advect_covector_field_matches():
    jm, spec, tm, ts = _fitted_like(10)
    jn = jaf.advect_covector_field_2d(jm, spec, 0.3)
    tn = taf.advect_covector_field_2d(tm, ts, 0.3)
    assert tn.n_alive() == int(jn.n_alive())
    assert tn.capacity == jn.capacity
    for k in ("positions", "scalings", "rotations", "values"):
        close(getattr(tn, k), getattr(jn, k), 1e-5, err_msg=k)


def test_split_and_unfreeze_match():
    jm, spec, tm, ts = _fitted_like(11, n=300)
    # stretch a third of the Gaussians past the 1.5 ratio
    sca = np.asarray(jm.scalings).copy()
    sca[::3, 0] += 0.8
    jm = type(jm)(jm.positions, jnp.asarray(sca), jm.rotations, jm.values,
                  jm.alive)
    tm, ts = to_torch(jm, spec)
    jn, jstop, jk = jclone.split_gaussians_2d(jm, spec, R(12))
    tn, tstop, tk = tclone.split_gaussians_2d(tm, ts, R(12))
    assert tk == jk > 0
    np.testing.assert_array_equal(tstop, jstop)
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        close(getattr(tn, k).float(), np.asarray(getattr(jn, k), np.float32),
              1e-5, err_msg=k)
    np.testing.assert_array_equal(
        tclone._unfreeze_neighbors(tn, ts, tstop).numpy(),
        np.asarray(jclone._unfreeze_neighbors(jn, spec, jstop)))


# ---- one epoch of each training phase, fed the same batches ----

def _tg_state(seed):
    """A taylor_green-sized random state in the scaled domain [0, 10]^2."""
    jm, spec = jax_mixture(576, seed, lo=0.0, hi=10.0, spread=4.8,
                           center=5.0)
    return jm, spec, *to_torch(jm, spec)


def _jax_tree(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_fit_epoch_matches():
    jm, spec, tm, ts = _tg_state(13)
    js, tsn = jscene("taylor_green"), tscene("taylor_green")
    lo, hi = (0.0, 0.0), (10.0, 10.0)
    lrs = {"positions": 1.6e-3, "scalings": 5e-2, "rotations": 5e-2,
           "values": 5e-3}
    jep = jfit.make_fit_epoch(spec, js.target_velocity,
                              js.target_velocity_jac, lo, hi, 512)
    tep = tfit.make_fit_epoch(ts, tsn.target_velocity,
                              tsn.target_velocity_jac)
    jc = (jm.params(), _jopt(jm.params(), lrs), jm.alive)
    tc = (tm.params(), _topt(tm.params(), lrs), tm.alive)
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        x = jax.random.uniform(key, (512, 2), jnp.float32) * 10.0
        jc, jaux = jax.jit(jep)(jc, key)
        tc, taux = tep(tc, t(x))
        close(taux, jaux, 2e-5)
        _params_close(tc[0], jc[0], f"fit epoch {i}")


def test_clone_epoch_matches():
    jm, spec, tm, ts = _tg_state(14)
    old_j, _ = jax_mixture(576, 15, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    old_t, _ = to_torch(old_j, spec)
    stop = R(16).rand(jm.capacity) > 0.5
    lrs = dict(jclone.DEFAULT_LRS_CLONE_2D)
    lo, hi = jnp.zeros(2), jnp.full((2,), 10.0)
    run_chunk = jclone._clone_runner(spec, 512, None)[0]
    jc = (jm.params(), _jopt(jm.params(), lrs), jm.alive,
          jnp.asarray(stop), old_j.params(), old_j.alive, lo, hi)
    epoch = tclone._clone_runner(ts).epoch
    tc = (tm.params(), _topt(tm.params(), lrs), tm.alive,
          t(stop), old_t)
    key = jax.random.PRNGKey(17)
    x = jax.random.uniform(jax.random.split(key, 1)[0], (512, 2),
                           jnp.float32) * 10.0
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = epoch(tc, t(x))
    close(taux, jaux[0], 2e-5)
    _params_close(tc[0], jc[0], "clone epoch")


def test_project_epoch_matches():
    jm, spec, tm, ts = _tg_state(18)
    old_j, _ = jax_mixture(576, 19, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    old_t, _ = to_torch(old_j, spec)
    scene = jscene("taylor_green")
    sf = scene.scaling_factor
    w = jproj.ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                             delta_pos=0.5)
    tw = tproj.ProjectWeights(*w[:5])
    run_chunk = jproj._runner_2d(spec, "taylor_green", w, 1.0, 512, None)[0]
    epoch = tproj._runner_2d(ts, "taylor_green", tw, 1.0, 512).epoch
    adv = np.float32(scene.advance_domain)
    lrs = dict(jproj.DEFAULT_LRS_2D)
    dt = 0.05
    pos0 = np.asarray(jm.positions) + np.float32(0.01)
    jc = (jm.params(), _jopt(jm.params(), lrs), jm.alive,
          jnp.asarray(pos0), old_j.params(), old_j.alive, jnp.asarray(adv),
          jnp.float32(dt))
    tc = (tm.params(), _topt(tm.params(), lrs), tm.alive,
          t(pos0), old_t, t(adv), dt)
    key = jax.random.PRNGKey(20)
    kd, _, kb2 = jax.random.split(jax.random.split(key, 1)[0], 3)
    lo = np.float32([adv[0], adv[2]]) * sf
    hi = np.float32([adv[1], adv[3]]) * sf
    data = jax.random.uniform(kd, (512, 2), jnp.float32) * (hi - lo) + lo
    u = jax.random.uniform(kb2, (512,))
    bnd = tb2.sample_on_domain_boundary_2(t(u), t(adv), sf)
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = epoch(tc, (t(data), None, None, bnd))
    close(taux, jaux[0], 2e-5)
    _params_close(tc[0], jc[0], "project epoch")
