"""The four ``vortices_pass`` obstacle scenes of the port against the JAX
package: the fields' values and Jacobians, the OBJ vortex asset, each
boundary sampler on identical uniform draws, one projection epoch with the
obstacle boundary terms fed the JAX package's draws, the committed TPU
fit of ``vortices_pass`` (``runs_r2_evidence/ckpts/output_vp/``) read by
both packages, and ``initialize2d`` -> ``advance2d`` through the entry
points at a tiny size for every scene."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch import advance2d, initialize2d
from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.scenes import boundaries2d as tb2
from gaussian_fluids_torch.scenes import fields2d as tf2
from gaussian_fluids_torch.scenes import get_scene_2d as tscene
from gaussian_fluids_torch.scenes import registry2d as treg
from gaussian_fluids_torch.solver import losses as tlosses
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.scenes import fields2d as jf2
from gaussian_fluids_tpu.scenes import get_scene_2d as jscene
from gaussian_fluids_tpu.scenes import registry2d as jreg
from gaussian_fluids_tpu.solver import losses as jlosses
from gaussian_fluids_tpu.solver import project as jproj

from torch_parity import (close, jax_mixture, jopt_warm, params_close, t,
                          to_torch, topt_warm)

SCENES = ["vortices_pass", "vortices_pass_narrow", "vortices_pass_noslip",
          "vortices_pass_particles"]
VP_FIT = os.path.join(os.path.dirname(__file__), "..", "runs_r2_evidence",
                      "ckpts", "output_vp", "gaussian_velocity_0.pt")


def _points(scene, n, seed):
    """n seeded points in the scene's scaled initialize box."""
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    return np.random.RandomState(seed).uniform(
        (x0 * sf, y0 * sf), (x1 * sf, y1 * sf), (n, 2)).astype(np.float32)


def test_registry_is_the_jax_registry():
    assert treg.SCENES_2D == jreg.SCENES_2D
    assert len(treg.SCENES_2D) == 8
    for name in treg.SCENES_2D:
        ts, js = tscene(name), jscene(name)
        for k in ("initialize_domain", "advance_domain", "visualize_domain",
                  "particle_count", "visualize_res", "info",
                  "scaling_factor"):
            assert getattr(ts, k) == getattr(js, k), (name, k)
        assert (ts.boundary_sampler_1 is None) == \
            (js.boundary_sampler_1 is None), name
        assert (ts.boundary_sampler_2 is None) == \
            (js.boundary_sampler_2 is None), name


def test_vortex_particles_asset_matches():
    tp, tw = tf2.load_vortex_particles()
    jp, jw = jf2.load_vortex_particles()
    assert tp.shape == (48, 2) and tw.shape == (48,)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("name", SCENES)
def test_field_value_and_jacobian_match(name):
    """The analytic field (original space) and its scaled target velocity
    and Jacobian at seeded points, against the JAX package's."""
    ts, js = tscene(name), jscene(name)
    x = _points(ts, 512, 1)
    xo = x / np.float32(ts.scaling_factor)
    close(ts.velocity(t(xo)), js.velocity(jnp.asarray(xo)), 1e-5)
    close(ts.velocity_jac(t(xo)), js.velocity_jac(jnp.asarray(xo)), 1e-5)
    close(ts.target_velocity(t(x)), js.target_velocity(jnp.asarray(x)),
          1e-5)
    close(ts.target_velocity_jac(t(x)),
          js.target_velocity_jac(jnp.asarray(x)), 1e-5)


def _jax_uniforms(key, n, parts):
    """The uniform draws a JAX sampler takes from ``key``: split into
    ``parts`` keys (or the key itself for 1), one (n,) draw each."""
    keys = [key] if parts == 1 else list(jax.random.split(key, parts))
    return [t(jax.random.uniform(k, (n,))) for k in keys]


SAMPLERS = [("vortices_pass", 2), ("vortices_pass_narrow", 2),
            ("vortices_pass_noslip", 1), ("vortices_pass_noslip", 2),
            ("vortices_pass_particles", 2)]


@pytest.mark.parametrize("name,which", SAMPLERS)
def test_sampler_matches_on_identical_draws(name, which):
    """Each boundary sampler's geometry on the JAX sampler's own uniform
    draws: the same points, normals and targets, in the JAX package's
    count and concatenation order (3n, 2n + n walls, 2n)."""
    ts, js = tscene(name), jscene(name)
    sf, info, n = ts.scaling_factor, ts.info, 300
    adv = np.float32(ts.advance_domain)
    key = jax.random.PRNGKey(11 + which)
    want = getattr(js, f"boundary_sampler_{which}")(key, n, jnp.asarray(adv))
    if name in ("vortices_pass", "vortices_pass_narrow"):
        got = tb2.vortices_pass_flux(*_jax_uniforms(key, n, 3), t(adv), info,
                                     sf)
    elif which == 1:
        got = tb2.circles_noslip(*_jax_uniforms(key, n, 2), info, sf)
    elif name == "vortices_pass_noslip":
        got = tb2.sample_on_domain_boundary_2(*_jax_uniforms(key, n, 1),
                                              t(adv), sf)
    else:
        got = tb2.circles_flux(*_jax_uniforms(key, n, 2), info, sf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, 1e-6)
    # the port's samplers draw the same counts from a torch generator
    sampler = getattr(ts, f"boundary_sampler_{which}")
    out = sampler(torch.Generator().manual_seed(0), n, t(adv))
    assert [tuple(o.shape) for o in out] == [tuple(w.shape) for w in want]


def _scene_mixture(name, seed):
    """A seeded JAX mixture on a 12 x 12 grid of the scene's scaled box."""
    js = jscene(name)
    sf = js.scaling_factor
    x0, x1, y0, y1 = js.initialize_domain
    lo, hi = x0 * sf, x1 * sf
    return jax_mixture(144, seed, lo=lo, hi=hi, spread=0.4 * (hi - lo),
                       center=0.5 * (lo + hi))


@pytest.mark.parametrize("name", ["vortices_pass", "vortices_pass_noslip"])
def test_projection_epoch_matches(name):
    """One advance projection epoch with the scene's obstacle boundary
    terms (free-slip circles + walls, 3n flux points; or no-slip circles
    2n + walls n), fed the JAX package's draws."""
    jm, spec = _scene_mixture(name, 31)
    old_j, _ = _scene_mixture(name, 32)
    tm, ts = to_torch(jm, spec)
    old_t, _ = to_torch(old_j, spec)
    scene = jscene(name)
    sf = scene.scaling_factor
    w = jproj.ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                             delta_pos=0.5)
    run_chunk = jproj._runner_2d(spec, name, w, 1.0, 512, None)[0]
    epoch = tproj._runner_2d(ts, name, tproj.ProjectWeights(*w[:5]), 1.0,
                             512).epoch
    lrs = dict(jproj.DEFAULT_LRS_2D)
    adv = np.float32(scene.advance_domain)
    pos0 = np.asarray(jm.positions) + np.float32(0.01)
    dt = 0.05
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          jnp.asarray(pos0), old_j.params(), old_j.alive, jnp.asarray(adv),
          jnp.float32(dt))
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, t(pos0), old_t,
          t(adv), dt)
    key = jax.random.PRNGKey(33)
    kd, kb1, kb2 = jax.random.split(jax.random.split(key, 1)[0], 3)
    lo = np.float32([adv[0], adv[2]]) * sf
    hi = np.float32([adv[1], adv[3]]) * sf
    data = jax.random.uniform(kd, (512, 2), jnp.float32) * (hi - lo) + lo
    info = tscene(name).info
    if name == "vortices_pass":
        b1 = None
        b2 = tb2.vortices_pass_flux(*_jax_uniforms(kb2, 512, 3), t(adv),
                                    info, sf)
    else:
        b1 = tb2.circles_noslip(*_jax_uniforms(kb1, 512, 2), info, sf)
        b2 = tb2.sample_on_domain_boundary_2(*_jax_uniforms(kb2, 512, 1),
                                             t(adv), sf)
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = epoch(tc, (t(data), None, b1, b2))
    close(taux, jaux[0], 2e-5)
    assert float(np.asarray(jaux[0])[2]) > 0   # the boundary term is live
    params_close(tc[0], jc[0], f"{name} projection epoch")


def test_committed_vortices_pass_fit(monkeypatch):
    """The JAX package's TPU fit of vortices_pass (frame 0 of the committed
    run) read by both packages: the same parameters, the same velocity and
    Jacobian at seeded points, and the same flux loss on seeded obstacle
    and wall points. Both through their centered paths (the JAX Pallas
    kernels in interpret mode, the port's plain twins): the dense paths'
    expanded quadratic form loses ~4e-5 of a value to f32 cancellation at
    this state's coordinates (up to 10 scaled units)."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    tm, tspec = tckpt.load_checkpoint(VP_FIT, device="cpu")
    jm, jspec = jckpt.load_checkpoint(VP_FIT)
    assert tm.n_alive() == 71 * 71
    for k, v in jm.params().items():
        np.testing.assert_array_equal(tm.params()[k].numpy(), np.asarray(v))
    ts = tscene("vortices_pass")
    x = _points(ts, 1024, 5)
    jv, jj = jf.value_and_jac(jm, jspec, jnp.asarray(x))
    with torch.no_grad():
        tv, tj = tf.value_and_jac_centered(tm, tspec, t(x))
    close(tv, jv, 1e-5)
    close(tj, jj, 1e-5)
    u = np.random.RandomState(6).uniform(0, 1, (3, 512)).astype(np.float32)
    adv = np.float32(ts.advance_domain)
    bd, bn, bnr = tb2.vortices_pass_flux(*map(t, u), t(adv), ts.info,
                                         ts.scaling_factor)
    with torch.no_grad():
        tl = tlosses.boundary_flux_loss(tf.value_centered(tm, tspec, bd), bn,
                                        bnr)
    jl = jlosses.boundary_flux_loss(jf.value(jm, jspec, jnp.asarray(bd)),
                                    jnp.asarray(bn), jnp.asarray(bnr))
    close(tl, jl, 1e-5)


@pytest.mark.parametrize("name", SCENES)
def test_entry_points_run(name, tmp_path, monkeypatch):
    """initialize2d and one advance2d frame through the entry points on the
    CPU, the scene's particle and test grids cut through the registry."""
    monkeypatch.setitem(treg._PARTICLE_COUNT, name, (12, 12))
    monkeypatch.setitem(treg._VISUALIZE_RES, name, (16, 16))
    common = ["--device", "cpu", "--init_cond", name, "--dir",
              str(tmp_path), "--max_epoch", "10", "--no_viz"]
    mix, _ = initialize2d.main(common)
    assert mix.n_alive() == 144
    mix, _, frames = advance2d.main(common + ["--dt", ".01",
                                              "--last_time", ".01"])
    assert [f["frame"] for f in frames] == [1]
    for k in ("loss_vor", "loss_div", "boundary_constraint"):
        assert np.isfinite(frames[0]["project"][k]), k
    assert frames[0]["project"]["boundary_constraint"] > 0
    assert sorted(os.listdir(tmp_path)) == ["gaussian_velocity_0.pt",
                                            "gaussian_velocity_1.pt"]
