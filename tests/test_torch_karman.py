"""The Karman-2D scene of the port on the CPU against the JAX package: its
boundary samplers on identical uniform draws, the moving advance domain
(``extra_advect``, ``advance_domain_at``), one epoch of the initialization's
zero-dt projection fed the same batches, and a tiny initialize / advance
through the entry points with a ``--start_frame`` resume. (The scene's
field, Jacobian, domains and info are held in tests/test_torch_solver.py,
``test_scene_fields_match[karman]``.) Tolerance 1e-5 of the largest
reference entry unless stated; the domains exactly."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_fluids_torch import advance2d, initialize2d
from gaussian_fluids_torch.scenes import boundaries2d as tb2
from gaussian_fluids_torch.scenes import get_scene_2d as tscene
from gaussian_fluids_torch.scenes import registry2d as treg
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_torch.solver import simulate2d as tsim
from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.scenes import get_scene_2d as jscene
from gaussian_fluids_tpu.solver import project as jproj
from gaussian_fluids_tpu.solver import simulate2d as jsim
from gaussian_fluids_tpu.utils.grids import grid_points_2d as jgrid

from torch_parity import (close, jopt_warm, params_close, t, to_torch,
                          topt_warm)


def test_karman_samplers_match():
    js, ts = jscene("karman"), tscene("karman")
    sf = js.scaling_factor
    adv = np.float32(js.advance_domain_at(40, 0.01))
    key = jax.random.PRNGKey(5)
    jd, jv = js.boundary_sampler_1(key, 300, jnp.asarray(adv))
    td, tv = tb2.karman_cylinder(t(jax.random.uniform(key, (300,))),
                                 ts.info, sf)
    close(td, jd)
    close(tv, jv)
    jd, jn, jr = js.boundary_sampler_2(key, 300, jnp.asarray(adv))
    k1, k2 = jax.random.split(key)
    td, tn, tr = tb2.karman_edges(t(jax.random.uniform(k1, (300,))),
                                  t(jax.random.uniform(k2, (300,))), t(adv),
                                  ts.info, sf)
    assert tuple(td.shape) == jd.shape == (1500, 2)
    close(td, jd)
    close(tn, jn)
    close(tr, jr)
    # the samplers as the projection calls them: own draws, same shapes
    import torch
    g = torch.Generator().manual_seed(0)
    d, v = ts.boundary_sampler_1(g, 64, t(adv))
    assert d.shape == (64, 2) and v.shape == (64, 2)
    d, n, r = ts.boundary_sampler_2(g, 64, t(adv))
    assert d.shape == (320, 2) and n.shape == (320, 2) and r.shape == (320,)


@pytest.mark.parametrize("name", ["karman", "leapfrog"])
def test_advance_domain_moves_as_in_jax(name):
    js, ts = jscene(name), tscene(name)
    for dt in (0.01, 0.037):
        jd, td = js.advance_domain, ts.advance_domain
        for frame in range(1, 400):
            jd, td = js.extra_advect(jd, dt), ts.extra_advect(td, dt)
            assert td == jd, (dt, frame)
            assert ts.advance_domain_at(frame, dt) == \
                js.advance_domain_at(frame, dt), (dt, frame)
        # far past the visualize domain's left edge, the growth stops
        assert ts.advance_domain_at(10 ** 5, dt) == \
            js.advance_domain_at(10 ** 5, dt)


def _karman_state(seed):
    """A small JAX mixture on a 30 x 6 grid of the Karman scaled domain with
    seeded shapes and values."""
    scene = jscene("karman")
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    lo, hi = (x0 * sf, y0 * sf), (x1 * sf, y1 * sf)
    pos = jgrid(lo[0], hi[0], lo[1], hi[1], 30, 6)
    spec = FieldSpec.create(lo, hi, pos.shape[0], d=2, vdim=2)
    mix = GaussianMixture.create(pos, spec)
    rng = np.random.RandomState(seed)
    p = mix.params()
    p["scalings"] = p["scalings"] + jnp.asarray(
        rng.uniform(-0.3, 0.3, p["scalings"].shape), jnp.float32)
    p["rotations"] = p["rotations"] + jnp.asarray(
        rng.uniform(-1, 1, p["rotations"].shape), jnp.float32)
    p["values"] = jnp.asarray((4.0 + rng.randn(*p["values"].shape))
                              * np.asarray(mix.alive)[:, None], jnp.float32)
    return mix.with_params(p), spec


def test_init_karman_projection_epoch_matches():
    """One epoch of the initialization's zero-dt projection (its weights,
    boundary lambda and learning rates; the cylinder's Dirichlet batch and
    the 5-edge flux batch), fed the JAX package's draws."""
    jm, spec = _karman_state(21)
    old_j, _ = _karman_state(22)
    tm, ts = to_torch(jm, spec)
    old_t, _ = to_torch(old_j, spec)
    scene = jscene("karman")
    sf = scene.scaling_factor
    w = jproj.ProjectWeights(vor=1.0, div=10.0, aniso=10.0, vol=10.0,
                             delta_pos=0.0)
    run_chunk = jproj._runner_2d(spec, "karman", w, 10.0, 512, None)[0]
    epoch = tproj._runner_2d(ts, "karman", tproj.ProjectWeights(*w[:5]),
                             10.0, 512).epoch
    lrs = {"positions": 1e-4, "scalings": 1e-5,
           "rotations": 1e-5 * jsim.LR_RATIO, "values": 1e-4}
    assert tsim.LR_RATIO == jsim.LR_RATIO
    adv = np.float32(scene.advance_domain)
    pos0 = np.asarray(jm.positions)
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          jnp.asarray(pos0), old_j.params(), old_j.alive, jnp.asarray(adv),
          jnp.float32(0.0))
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, t(pos0), old_t,
          t(adv), 0.0)
    key = jax.random.PRNGKey(23)
    kd, kb1, kb2 = jax.random.split(jax.random.split(key, 1)[0], 3)
    lo = np.float32([adv[0], adv[2]]) * sf
    hi = np.float32([adv[1], adv[3]]) * sf
    data = jax.random.uniform(kd, (512, 2), jnp.float32) * (hi - lo) + lo
    b1 = tb2.karman_cylinder(t(jax.random.uniform(kb1, (512,))),
                             tscene("karman").info, sf)
    k1, k2 = jax.random.split(kb2)
    b2 = tb2.karman_edges(t(jax.random.uniform(k1, (512,))),
                          t(jax.random.uniform(k2, (512,))), t(adv),
                          tscene("karman").info, sf)
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = epoch(tc, (t(data), None, b1, b2))
    close(taux, jaux[0], 2e-5)
    assert float(np.abs(np.asarray(jaux[0])).min()) > 0   # every term live
    params_close(tc[0], jc[0], "karman projection epoch")


def test_karman_entry_points_and_resume(tmp_path, monkeypatch):
    """initialize2d and advance2d --init_cond karman on the CPU at a tiny
    size (the scene's particle grid and test grid cut through the
    registry): the inflow fit and zero-dt projection, two frames, and the
    same two frames as one frame plus a --start_frame 1 resume, whose
    advance domain equals the uninterrupted run's."""
    monkeypatch.setitem(treg._PARTICLE_COUNT, "karman", (40, 6))
    monkeypatch.setitem(treg._VISUALIZE_RES, "karman", (50, 20))
    full, resumed = str(tmp_path / "full"), str(tmp_path / "resumed")
    common = ["--device", "cpu", "--init_cond", "karman", "--max_epoch",
              "20", "--no_viz"]
    mix, spec = initialize2d.main(common + ["--dir", full])
    assert mix.n_alive() == 240
    os.makedirs(resumed)
    shutil.copy(os.path.join(full, "gaussian_velocity_0.pt"), resumed)
    frames = advance2d.main(common + ["--dir", full, "--dt", ".01",
                                      "--last_time", ".02"])[2]
    first = advance2d.main(common + ["--dir", resumed, "--dt", ".01",
                                     "--last_time", ".01"])[2]
    second = advance2d.main(common + ["--dir", resumed, "--dt", ".01",
                                      "--last_time", ".01",
                                      "--start_frame", "1"])[2]
    scene = tscene("karman")
    assert [f["frame"] for f in frames] == [1, 2]
    assert [f["frame"] for f in first + second] == [1, 2]
    assert frames[0]["advance_domain"] == first[0]["advance_domain"] \
        == scene.advance_domain_at(1, 0.01)
    assert second[0]["advance_domain"] == frames[1]["advance_domain"] \
        == scene.advance_domain_at(2, 0.01)
    assert frames[1]["advance_domain"][0] > scene.advance_domain[0]
    for f in frames + first + second:
        for k in ("loss_vor", "loss_div", "boundary_constraint"):
            assert np.isfinite(f["project"][k]), (f["frame"], k)
    for d in (full, resumed):
        assert sorted(os.listdir(d)) == [f"gaussian_velocity_{i}.pt"
                                         for i in range(3)]
