"""The port's 3D pieces against the JAX package on the CPU: quaternion
rotations and packed precisions, the 3D mixture, losses, the vortex-ring
fields, the box sampler fed the same uniforms, grids and chunks, the
centered kernels' plain twins at d = 3 against the Pallas kernels in
interpret mode, splitting, the covector target, advection, one fit, clone
and projection epoch fed the same sample batches, the epochs' sorts on
the cells and centered routes against the float64 dense path, and 3D
checkpoints crossing between the packages. The slice end to end is in
tests/test_torch_e2e_3d.py. Tolerance 1e-5 of the largest reference entry
unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.models.mixture import GaussianMixture as TMix
from gaussian_fluids_torch.ops import advect as tadv
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.ops import rotations as trot
from gaussian_fluids_torch.scenes import boundaries3d as tb3
from gaussian_fluids_torch.scenes import fields3d as tf3
from gaussian_fluids_torch.scenes import get_scene_3d as tscene
from gaussian_fluids_torch.solver import advect_field as taf
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_torch.solver import covector as tcov
from gaussian_fluids_torch.solver import fit as tfit
from gaussian_fluids_torch.solver import losses as tl
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_torch.solver.simulate3d import FIT_LRS_3D
from gaussian_fluids_torch.utils import grids as tgrids
from gaussian_fluids_tpu import FieldSpec as JSpec
from gaussian_fluids_tpu import GaussianMixture as JMix
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.ops import advect as jadv
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.ops import rotations as jrot
from gaussian_fluids_tpu.ops.pallas import gsr_centered as jk
from gaussian_fluids_tpu.scenes import fields3d as jf3
from gaussian_fluids_tpu.scenes import get_scene_3d as jscene
from gaussian_fluids_tpu.solver import advect_field as jaf
from gaussian_fluids_tpu.solver import clone as jclone
from gaussian_fluids_tpu.solver import covector as jcov
from gaussian_fluids_tpu.solver import fit as jfit
from gaussian_fluids_tpu.solver import losses as jl
from gaussian_fluids_tpu.solver import project as jproj
from gaussian_fluids_tpu.utils import grids as jgrids

from torch_parity import (EPOCH_KINDS_3D, assert_epochs_agree, close,
                          jax_mixture_3d, jopt_warm, one_epoch_runs_3d,
                          params_close, sorted_queries_3d, t, to_torch,
                          topt_warm)

R = np.random.RandomState


def _state(seed, n=500, scale_shift=0.5):
    jm, spec = jax_mixture_3d(n, seed, scale_shift)
    return jm, spec, *to_torch(jm, spec)


# ---- rotations, mixture, losses ----

def test_quaternion_rotations_and_precisions_match():
    rng = R(0)
    q = rng.randn(64, 4).astype(np.float32)
    s = rng.randn(64, 3).astype(np.float32)
    close(trot.rotation_matrix_3d(t(q)), jrot.rotation_matrix_3d(q))
    close(trot.precision_matrix(t(s), t(q), 3), jrot.precision_matrix(s, q, 3),
          2e-6)
    close(trot.packed_precision_entries(t(s), t(q), 3),
          jrot.packed_precision_entries(s, q, 3), 2e-6)


def test_mixture_3d_create_and_pad_match():
    rng = R(1)
    pos = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    spec = JSpec.create((0, 0, 0), (1, 1, 1), 700, d=3, vdim=3)
    jm = JMix.create(pos, spec)
    tspec = to_torch(jm, spec)[1]
    tm = TMix.create(pos, tspec, device="cpu")
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    arrs = [pos[:600], rng.randn(600, 3), rng.randn(600, 4), rng.randn(600, 3)]
    jm2 = JMix.from_arrays(*[a.astype(np.float32) for a in arrs], spec,
                           min_capacity=1024)
    tm2 = TMix.from_arrays(*arrs, tspec, min_capacity=1024, device="cpu")
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(tm2, k).numpy(),
                                      np.asarray(getattr(jm2, k)), err_msg=k)
    np.testing.assert_array_equal(
        tm2.spatially_sorted().positions.numpy(),
        np.asarray(jm2.spatially_sorted().positions))


def test_3d_losses_match():
    rng = R(2)
    val = rng.randn(64, 3).astype(np.float32)
    jac = rng.randn(64, 3, 3).astype(np.float32)
    ref = rng.randn(64, 3).astype(np.float32)
    hel = rng.randn(64).astype(np.float32)
    alive = rng.rand(64) > 0.2
    close(tl.curl3d(t(jac)), jl.curl3d(jac))
    close(tl.vorticity_loss_3d(t(jac), t(ref)), jl.vorticity_loss_3d(jac, ref))
    close(tl.helicity_loss(t(val), t(jac), t(hel)),
          jl.helicity_loss(val, jac, hel))
    close(tl.boundary_freeslip_loss(t(val), t(ref)),
          jl.boundary_freeslip_loss(val, ref))
    close(tl.value_reg_loss(t(val), t(alive)), jl.value_reg_loss(val, alive))
    close(tl.divergence(t(jac)), jl.divergence(jac))


# ---- scenes ----

@pytest.mark.parametrize("name", ["leapfrog", "single_vortex_ring",
                                  "ring_collide"])
def test_ring_fields_match(name):
    js, ts = jscene(name), tscene(name)
    assert (ts.domain, ts.particle_count, ts.visualize_res) == \
        (js.domain, js.particle_count, js.visualize_res)
    x = R(3).uniform(0.05, 0.95, (128, 3)).astype(np.float32)
    close(ts.velocity(t(x)), js.velocity(jnp.asarray(x)), 2e-5)
    close(ts.velocity_jac(t(x)), js.velocity_jac(jnp.asarray(x)), 2e-5)


def test_ring_particles_match():
    for ring in jf3.OTHER_INFO["ring_collide"].values():
        want = jf3.ring_particles(ring.center, ring.normal, ring.radius, 50)
        got = tf3.ring_particles(ring.center, ring.normal, ring.radius, 50)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_box_sampler_matches_on_the_same_uniforms():
    key = jax.random.PRNGKey(4)
    dom = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    want = jscene("ring_collide").boundary_sampler(key, 300)
    k0, k1, k2 = jax.random.split(key, 3)
    u = [t(jax.random.uniform(k, (300,))) for k in (k0, k1, k2)]
    got = tb3.sample_on_box(*u, dom)
    for g, w in zip(got, want):
        close(g, w)
    gen = torch.Generator().manual_seed(0)
    pts, nrm = tscene("ring_collide").boundary_sampler(gen, 64)
    assert pts.shape == nrm.shape == (64, 3)


def test_obstacle_scene_is_refused_clearly():
    """The obstacle scene, refused until its mesh sampler was ported, now
    builds with it (tests/test_torch_mesh.py holds it against the JAX
    package); an unknown scene is refused with the valid names."""
    scene = tscene("ring_with_obstacle")
    assert scene.mesh_sampler is not None
    assert scene.domain == jscene("ring_with_obstacle").domain
    with pytest.raises(KeyError, match="ring_with_obstacle"):
        tscene("no_such_scene")


def test_grids_and_chunks_match():
    np.testing.assert_array_equal(
        tgrids.grid_points_3d(0, 1, 0, 2, 0, 3, 4, 5, 6),
        jgrids.grid_points_3d(0, 1, 0, 2, 0, 3, 4, 5, 6))
    for n, b in ((100, 8192), (7, 256), (64, 4096)):
        assert tgrids.sweep_group(n, b) == jgrids.sweep_group(n, b)
    x = R(5).rand(5000, 3).astype(np.float32)
    for g, w in zip(tgrids.pad_chunks(t(x), 3, 5000),
                    jgrids.pad_chunks(jnp.asarray(x), 3, 5000)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- centered kernels at d = 3 ----

TB, TN = 128, 256


def _centered_inputs(seed):
    jm, spec = jax_mixture_3d(700, seed)
    x = sorted_queries_3d(seed + 1, 512)
    x_p, _, _, mu_p, pp_p, v_p, tmask = jf._centered_prep(
        jm, spec, jnp.asarray(x), TB, TN, presorted=True)
    tmask = np.asarray(tmask).copy()
    live = np.argwhere(tmask)
    tmask[tuple(live[len(live) // 2])] = 0        # one live tile forced off
    rng = R(seed + 2)
    douts = [rng.randn(x_p.shape[0], 12).astype(np.float32)
             for _ in range(2)]
    jargs = (jnp.asarray(tmask), x_p, mu_p.T, pp_p.T, v_p)
    targs = tuple(t(a) for a in (tmask, x_p, mu_p.T, pp_p.T, v_p))
    rad = tf.row_radius(*to_torch(jm, spec), TN)
    return jargs, targs, douts, float(spec.clamp_threshold), rad


@pytest.mark.parametrize("njac", [0, 3])
def test_centered_fwd_d3_matches_pallas(njac):
    ja, ta, _, c, rad = _centered_inputs(21)
    want = jk._fwd(*ja, 3, 3, c, TB, TN, njac)
    close(tk.gsr_fwd(*ta, c, njac, rad), want)


@pytest.mark.parametrize("njac", [0, 3])
def test_centered_bwd_dn_d3_matches_pallas(njac):
    ja, ta, douts, c, _ = _centered_inputs(31)
    dout = douts[0][:, :(1 + njac) * 3].copy()
    _, dmuT, dppT, dv = jk._bwd(*ja, dout, 3, 3, c, TB, TN, njac,
                                need_dx=False)
    got = tk.gsr_bwd_dn(*ta, t(dout), c, njac)
    for g, w, k in zip(got, (dmuT, dppT, dv), ("dmuT", "dppT", "dv")):
        assert tuple(g.shape) == w.shape
        close(g, w, err_msg=k)


@pytest.mark.parametrize("use_val", [True, False])
def test_centered_bwd_dn2_d3_matches_pallas(use_val):
    ja, ta, douts, c, _ = _centered_inputs(41)
    want = jk.fused_gsr_centered_bwd2(*ja, *douts, 3, 3, c, TB, TN,
                                      use_val=use_val)
    got = tk.gsr_bwd_dn2(*ta, *(t(d) for d in douts), c, 3, use_val=use_val)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            close(g, w)


def test_centered_field_d3_matches_jax():
    jm, spec, tm, tspec = _state(51)
    x = R(52).uniform(-0.02, 1.02, (300, 3)).astype(np.float32)
    jv, jj = jf.value_and_jac_centered(jm, spec, jnp.asarray(x))
    with torch.no_grad():
        tv, tj = tf.value_and_jac_centered(tm, tspec, t(x))
    close(tv, jv)
    close(tj, jj, 2e-5)


# ---- solver pieces ----

def test_split_gaussians_3d_matches():
    jm, spec = jax_mixture_3d(300, 61, scale_shift=0.0)
    sca = np.asarray(jm.scalings).copy()
    sca[::4, 1] += 1.0                   # a quarter past the ratio of 2
    sca[::12, 2] += 1.5                  # some split twice
    jm = JMix(jm.positions, jnp.asarray(sca), jm.rotations, jm.values,
              jm.alive)
    tm, tspec = to_torch(jm, spec)
    jn, jstop, jcount = jclone.split_gaussians_3d(jm, spec, R(62))
    tn, tstop, tcount = tclone.split_gaussians_3d(tm, tspec, R(62))
    assert tcount == jcount > 75
    assert tn.capacity == jn.capacity and tn.n_alive() == int(jn.n_alive())
    np.testing.assert_array_equal(tstop, jstop)
    # the same draws in the same order; the children differ only by the
    # f32 rounding of the precision matrices the two packages compute
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        close(getattr(tn, k).float(), np.asarray(getattr(jn, k), np.float32),
              1e-6, err_msg=k)
    np.testing.assert_array_equal(
        tclone._unfreeze_neighbors(tn, tspec, tstop).numpy(),
        np.asarray(jclone._unfreeze_neighbors(jn, spec, jstop)))


def test_covector_target_and_advection_3d_match():
    jm, spec, tm, tspec = _state(71, scale_shift=0.0)
    x = R(72).uniform(0.1, 0.9, (200, 3)).astype(np.float32)
    jv, jh = jcov.advected_vorticity_3d(jm, spec, jnp.asarray(x), 0.02)
    tv, th = tcov.advected_vorticity_3d(tm, tspec, t(x), 0.02)
    # five field evaluations, a curl and a 3x3 solve through the dense
    # path's expanded quadratic in f32: each package lies 1-2e-5 of the
    # largest entry from the float64 result at this state, so 5e-5
    close(tv, jv, 5e-5)
    close(th, jh, 5e-5)
    close(tadv.rk4_advect(tm, tspec, t(x), 0.02),
          jadv.rk4_advect(jm, spec, jnp.asarray(x), 0.02))
    old_j, _ = jax_mixture_3d(500, 73, 0.0)
    old_t, _ = to_torch(old_j, spec)
    jn = jaf.advect_covector_field_3d(jm, old_j, spec, 0.05)
    tn = taf.advect_covector_field_3d(tm, old_t, tspec, 0.05)
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        close(getattr(tn, k).float(), np.asarray(getattr(jn, k), np.float32),
              err_msg=k)


# ---- one epoch of each training phase, fed the same batches ----

B = 256
LO3, HI3 = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)


def test_fit_epoch_3d_matches():
    jm, spec, tm, tspec = _state(81, scale_shift=0.0)
    js, ts = jscene("ring_collide"), tscene("ring_collide")
    jep = jfit.make_fit_epoch(spec, js.velocity, js.velocity_jac, LO3, HI3,
                              B)
    tep = tfit.make_fit_epoch(tspec, ts.velocity, ts.velocity_jac)
    jc = (jm.params(), jopt_warm(jm.params(), FIT_LRS_3D), jm.alive)
    tc = (tm.params(), topt_warm(tm.params(), FIT_LRS_3D), tm.alive)
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        x = jax.random.uniform(key, (B, 3), jnp.float32)
        jc, jaux = jax.jit(jep)(jc, key)
        tc, taux = tep(tc, t(x))
        close(taux, jaux, 2e-5)
        params_close(tc[0], jc[0], f"fit epoch {i}")


def test_clone_epoch_3d_matches():
    jm, spec, tm, tspec = _state(82, scale_shift=0.0)
    old_j, _ = jax_mixture_3d(500, 83, 0.0)
    old_t, _ = to_torch(old_j, spec)
    stop = R(84).rand(jm.capacity) > 0.5
    lrs = dict(jclone.DEFAULT_LRS_CLONE_3D)
    run_chunk = jclone._clone_runner(spec, B, None)[0]
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          jnp.asarray(stop), old_j.params(), old_j.alive, jnp.zeros(3),
          jnp.ones(3))
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, t(stop), old_t)
    key = jax.random.PRNGKey(85)
    x = jax.random.uniform(jax.random.split(key, 1)[0], (B, 3), jnp.float32)
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = tclone._clone_runner(tspec).epoch(tc, t(x))
    close(taux, jaux[0], 2e-5)
    params_close(tc[0], jc[0], "clone epoch")


def test_project_epoch_3d_matches():
    jm, spec, tm, tspec = _state(86, scale_shift=0.0)
    old_j, _ = jax_mixture_3d(500, 87, 0.0)
    old_t, _ = to_torch(old_j, spec)
    w = jproj.ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                             delta_pos=0.0, hel=1.0, val_reg=0.0)
    tw = tproj.ProjectWeights(*w)
    run_chunk = jproj._runner_3d(spec, "ring_collide", w, 10.0, B, LO3, HI3,
                                 None)[0]
    epoch = tproj._runner_3d(tspec, "ring_collide", tw, 10.0, B, LO3,
                             HI3).epoch
    lrs = dict(jproj.DEFAULT_LRS_3D)
    dt = 0.02
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          old_j.params(), old_j.alive, jnp.float32(dt))
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, old_t, dt)
    key = jax.random.PRNGKey(88)
    kd, kb = jax.random.split(jax.random.split(key, 1)[0])
    data = jax.random.uniform(kd, (B, 3), jnp.float32)
    u = [t(jax.random.uniform(k, (B,))) for k in jax.random.split(kb, 3)]
    bnd = tb3.sample_on_box(*u, jscene("ring_collide").domain)
    jc, jaux = run_chunk(jc, key, 1)
    tc, taux = epoch(tc, (t(data), None, None, bnd))
    close(taux, jaux[0], 2e-5)
    params_close(tc[0], jc[0], "project epoch")


@pytest.mark.parametrize("kind", EPOCH_KINDS_3D)
def test_epoch_3d_sorts_keep_batches_aligned(monkeypatch, kind):
    """One 3D epoch on an unsorted batch through the cells route and the
    centered route (the kernels' plain twins, with the epoch's sorts)
    against the float64 dense path, which never sorts, and the cells
    route on the batch handed in sorted. Losses and gradients within 1e-5
    of the largest reference entry."""
    cells, cells_sorted, centered, dense = one_epoch_runs_3d(
        kind, torch.device("cpu"), monkeypatch,
        [("cells", False), ("cells", True), ("centered", False),
         ("dense64", False)])
    assert_epochs_agree(cells, dense, 1e-5)
    assert_epochs_agree(centered, dense, 1e-5)
    assert_epochs_agree(cells, cells_sorted, 1e-5)


# ---- checkpoints ----

def test_3d_checkpoints_cross_between_packages(tmp_path):
    jm, spec, tm, tspec = _state(91, n=400, scale_shift=0.0)
    jpath, tpath = str(tmp_path / "j.pt"), str(tmp_path / "t.pt")
    jckpt.save_checkpoint(jpath, jm, spec)
    tckpt.save_checkpoint(tpath, tm, tspec)
    x = sorted_queries_3d(92, 256)
    for path in (jpath, tpath):
        jl_m, jl_s = jckpt.load_checkpoint(path)
        tl_m, tl_s = tckpt.load_checkpoint(path, device="cpu")
        assert tl_s == to_torch(jl_m, jl_s)[1]
        assert tl_m.rotations.shape == (tl_m.capacity, 4)
        jv, jj = jf.value_and_jac_centered(jl_m, jl_s, jnp.asarray(x))
        with torch.no_grad():
            tv, tj = tf.value_and_jac_centered(tl_m, tl_s, t(x))
        close(tv, jv)
        close(tj, jj, 2e-5)
