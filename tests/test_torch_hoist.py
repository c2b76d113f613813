"""The exact-target hoist of the projections and the clone re-fit: each
chunk draws its n epochs' batches first (in the per-epoch path's generator
order), sorts them, computes their exact targets in ``sweep_group``
sweeps, then runs the epochs. On the CPU the hoisted chunk gives the
per-epoch chunk's parameters bit for bit, on the dense path and on the
centered path (the kernels' plain twins, with the sorts); one hoisted 3D
projection chunk matches the JAX package's hoisted chunk run on its
Pallas kernels in interpret mode (as tests/test_target_hoist.py runs it),
fed the JAX draws; and a seeded anisotropic 3D state is split and re-fit
end to end through the hoisted path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.scenes import boundaries3d as tb3
from gaussian_fluids_torch.scenes import get_scene_2d as tscene
from gaussian_fluids_torch.scenes import registry2d as treg
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_torch.solver import loop as tloop
from gaussian_fluids_torch.solver import project as tproj
from gaussian_fluids_torch.utils import grids as tgrids
from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                      leapfrog_state,
                                                      ring_collide_state)
from gaussian_fluids_tpu.scenes import get_scene_3d as jscene3
from gaussian_fluids_tpu.solver import clone as jclone
from gaussian_fluids_tpu.solver import project as jproj
from gaussian_fluids_tpu.utils import grids as jgrids

from torch_parity import (jax_mixture_3d, jopt_warm, params_close, t,
                          to_torch, topt_warm)

N_EPOCHS = 4


def test_sweep_group_rounds_as_the_jax_package():
    """The sweeps of the smoke's shapes: 100 batches of 512 in one sweep
    (B = 51,200), 100 of 8192 in four of 25 (B = 204,800)."""
    assert tgrids.sweep_group(100, 512) == 100
    assert tgrids.sweep_group(100, 8192) == 25
    assert tgrids.sweep_group(25, 8192) == 25
    for n in (1, 3, 7, 64, 97, 100, 128):
        for b in (128, 512, 1536, 8192, 40000):
            assert tgrids.sweep_group(n, b) == jgrids.sweep_group(n, b)


def test_sorted_batches_is_each_batch_stably_sorted(monkeypatch):
    """With the field on a kernel every batch is sorted by coordinate 0,
    stably (uniform f32 draws tie), in the order the epoch's own sort
    gives it alone; on the dense path nothing moves."""
    r = np.random.RandomState(0)
    x = r.randint(0, 40, (5, 300, 3)).astype(np.float32)   # many ties
    x[..., 1] = np.arange(5 * 300).reshape(5, 300)      # tells ties apart
    assert torch.equal(tloop.sorted_batches(t(x)), t(x))
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    got = tloop.sorted_batches(t(x))
    for i in range(5):
        assert torch.equal(got[i], tproj._sorted_by_x(t(x[i]))[0])


def test_swept_gives_each_batch_its_rows():
    data = t(np.random.RandomState(1).randn(12, 50, 2).astype(np.float32))
    calls = []

    def fn(c):
        calls.append(c.shape[0])
        return c.sum(-1), c[:, :1] * 2.0

    a, b = tloop.swept(fn, data)
    assert calls == [600]                       # one sweep of 12 batches
    assert torch.equal(a, data.sum(-1))
    assert torch.equal(b, data[..., :1] * 2.0)


def test_hoist_gate(monkeypatch):
    """On where the field runs on a kernel, unless GF_HOIST_TARGETS=0."""
    x = torch.zeros(4, 2)
    assert not tloop.hoist_default(x)
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    assert tloop.hoist_default(x)
    monkeypatch.setenv("GF_HOIST_TARGETS", "0")
    assert not tloop.hoist_default(x)
    monkeypatch.setenv("GF_HOIST_TARGETS", "1")
    assert tloop.hoist_default(x)


# ---- hoisted against per-epoch, bit for bit ----

def _chunk_2d(scene_name, mix, spec, old, dt, w, lam, batch):
    scene = tscene(scene_name)
    run_chunk = tproj._runner_2d(spec, scene_name, w, lam,
                                  batch).run_chunk
    adv = torch.tensor(scene.advance_domain)

    def run(hoist):
        p = mix.params()
        carry = (p, topt_warm(p, tproj.DEFAULT_LRS_2D), mix.alive,
                 mix.positions + 0.01, old, adv, dt)
        gen = torch.Generator().manual_seed(5)
        return run_chunk(carry, gen, N_EPOCHS, hoist)[0]
    return run


def _chunk_3d(mix, spec, old, batch):
    run_chunk = tproj._runner_3d(
        spec, "ring_collide", tproj.ProjectWeights(delta_pos=0.0), 10.0,
        batch, (0.0,) * 3, (1.0,) * 3).run_chunk

    def run(hoist):
        p = mix.params()
        carry = (p, topt_warm(p, tproj.DEFAULT_LRS_3D), mix.alive, old, 0.02)
        gen = torch.Generator().manual_seed(6)
        return run_chunk(carry, gen, N_EPOCHS, hoist)[0]
    return run


def _chunk_clone(mix, spec, old, lo, hi, batch, lrs):
    run_chunk = tclone._clone_runner(spec, batch, lo,
                                      hi).run_chunk
    stop = torch.rand(mix.capacity, generator=torch.Generator()
                      .manual_seed(7)) > 0.5

    def run(hoist):
        p = mix.params()
        carry = (p, topt_warm(p, lrs), mix.alive, stop, old)
        gen = torch.Generator().manual_seed(8)
        return run_chunk(carry, gen, N_EPOCHS, hoist)[0]
    return run


def _case(kind):
    if kind in ("project_2d", "clone_2d", "vortices_pass"):
        mix, spec, _ = leapfrog_state("cpu", seed=1)
        old, _, _ = leapfrog_state("cpu", seed=2)
        if kind == "project_2d":
            return _chunk_2d("leapfrog", mix, spec, old, 0.025,
                             tproj.ProjectWeights(), 1.0, 256)
        if kind == "vortices_pass":
            # the scene's 3 x 256 flux points on the leapfrog-sized state
            return _chunk_2d("vortices_pass", mix, spec, old, 0.025,
                             tproj.ProjectWeights(), 1.0, 256)
        return _chunk_clone(mix, spec, old, (-5.0, -5.0), (5.0, 5.0), 256,
                            tclone.DEFAULT_LRS_CLONE_2D)
    if kind.startswith("karman"):
        # the initialization's zero-dt projection: Dirichlet + flux
        mix, spec, _ = karman_state("cpu")
        w = tproj.ProjectWeights(vor=1.0, div=10.0, aniso=10.0, vol=10.0,
                                 delta_pos=0.0)
        return _chunk_2d("karman", mix, spec, mix, 0.0 if kind == "karman"
                         else 0.01, w, 10.0, 256)
    mix, spec, _ = ring_collide_state("cpu", seed=3, side=8)
    old, _, _ = ring_collide_state("cpu", seed=4, side=8)
    if kind == "project_3d":
        return _chunk_3d(mix, spec, old, 256)
    return _chunk_clone(mix, spec, old, (0.0,) * 3, (1.0,) * 3, 256,
                        tclone.DEFAULT_LRS_CLONE_3D)


KINDS = ["project_2d", "vortices_pass", "karman", "project_3d", "clone_2d",
         "clone_3d"]
CASES = [(k, r) for k in KINDS for r in ("dense", "centered")] \
    + [("karman_fused", "centered")]


@pytest.mark.parametrize("kind,route", CASES)
def test_hoisted_chunk_equals_per_epoch(kind, route, monkeypatch):
    """Parameters after a chunk of 4 epochs, hoisted and per epoch, from
    the same state and generator: equal bit for bit. On the centered
    route every batch is sorted; ``karman_fused`` takes the 2D target
    through the fused RK4 kernel's plain twin (GF_FUSED_RK4=1, a branch
    of the kernel route only)."""
    if route == "centered":
        monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    # the Karman state on a 40 x 6 grid of the scene's domain
    monkeypatch.setitem(treg._PARTICLE_COUNT, "karman", (40, 6))
    if kind == "karman_fused":
        monkeypatch.setenv("GF_FUSED_RK4", "1")
    run = _case(kind)
    per_epoch, hoisted = run(False), run(True)
    for k in per_epoch:
        assert torch.equal(per_epoch[k], hoisted[k]), (kind, route, k)


# ---- against the JAX package's hoisted chunk ----

def test_hoisted_3d_chunk_matches_jax_pallas(monkeypatch):
    """One hoisted chunk of 4 Ring-Collide projection epochs: the JAX
    package's run_chunk on its Pallas kernels (interpret mode; the hoist
    on, as it is there on the accelerator) against the port's hoisted
    run_chunk on its centered plain twins, fed the JAX draws (data
    batches and box boundary batches) in the JAX order; parameters within
    1e-5 of their largest entry."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    monkeypatch.delenv("GF_HOIST_TARGETS", raising=False)
    jproj._runner_3d.cache_clear()
    B, lo, hi = 256, (0.0,) * 3, (1.0,) * 3
    jm, spec = jax_mixture_3d(120, 51, 0.0)
    old_j, _ = jax_mixture_3d(120, 52, 0.0)
    tm, ts = to_torch(jm, spec)
    old_t, _ = to_torch(old_j, spec)
    w = jproj.ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                             delta_pos=0.0, hel=1.0, val_reg=0.0)
    lrs = dict(jproj.DEFAULT_LRS_3D)
    key = jax.random.PRNGKey(53)
    # the JAX chunk's draws: per epoch key k -> (kd, kb) = split(k)
    data, bnds = [], []
    dom = jscene3("ring_collide").domain
    for k in jax.random.split(key, N_EPOCHS):
        kd, kb = jax.random.split(k)
        data.append(t(jax.random.uniform(kd, (B, 3), jnp.float32)))
        u = [t(jax.random.uniform(q, (B,))) for q in jax.random.split(kb, 3)]
        bnds.append(tb3.sample_on_box(*u, dom))
    feed = iter(data)
    boxes = iter(bnds)

    class Scene:
        boundary_sampler = staticmethod(lambda gen, n: next(boxes))

    monkeypatch.setattr(tproj, "uniform_batch", lambda *a: next(feed))
    monkeypatch.setattr(tproj, "get_scene_3d", lambda name: Scene)
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    jrun = jproj._runner_3d(spec, "ring_collide", w, 10.0, B, lo, hi,
                            None)[0]
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          old_j.params(), old_j.alive, jnp.float32(0.02))
    jc, _ = jrun(jc, key, N_EPOCHS)
    trun = tproj._runner_3d(ts, "ring_collide", tproj.ProjectWeights(*w),
                            10.0, B, lo, hi).run_chunk
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, old_t, 0.02)
    tc = trun(tc, torch.Generator(), N_EPOCHS, True)
    jproj._runner_3d.cache_clear()
    params_close(tc[0], jc[0], "hoisted 3D chunk")


# ---- the clone re-fit, end to end ----

def test_clone_refit_3d_end_to_end(monkeypatch):
    """A seeded anisotropic 3D state really splits (the same parents and
    children as the JAX package's split on the same numpy seed) and is
    re-fit to the old field through the hoisted path (the centered route,
    sorts included): the clone loss falls and the metrics stay finite.
    The per-epoch path ends within 1e-3 of the hoisted path's metrics, not
    bit for bit: at the old field's repadded capacity (N = 1024) the CPU's
    matrix product rounds a row differently in a 5120-row sweep than in a
    256-row batch, and a fresh Adam state's sign steps carry that into the
    parameters."""
    jm, spec = jax_mixture_3d(300, 61, 0.3)
    p = jm.params()
    sca = np.array(p["scalings"])
    sca[::4, 0] += 1.2                      # ratio e^1.2 = 3.3 >= 2: split
    jm = jm.with_params({**p, "scalings": jnp.asarray(sca)})
    tm, ts = to_torch(jm, spec)
    jsplit, _, jn = jclone.split_gaussians_3d(jm, spec,
                                              np.random.RandomState(3))
    tsplit, _, tn = tclone.split_gaussians_3d(tm, ts,
                                              np.random.RandomState(3))
    assert tn == jn > 0
    for k, v in jsplit.params().items():
        np.testing.assert_allclose(tsplit.params()[k].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-6)
    monkeypatch.setattr(tf, "_use_kernel", lambda x: True)
    test_x = np.random.RandomState(62).uniform(0, 1, (216, 3)) \
        .astype(np.float32)
    runs = []
    for gate in ("1", "0"):                 # hoisted, then per epoch
        monkeypatch.setenv("GF_HOIST_TARGETS", gate)
        new, last = tclone.clone_velocity_field(
            tm, ts, lo=(0.0,) * 3, hi=(1.0,) * 3, test_x=test_x,
            gen=torch.Generator().manual_seed(63), seed=3, d=3,
            batch_size=256, max_epoch=40, check_iter=20, patience=10 ** 6,
            verbose=0)
        runs.append((new, last))
    (new, last), (_, last0) = runs
    assert new.n_alive() == tm.n_alive() + tn
    assert all(np.isfinite(v) for v in last.values())
    for k in last:
        assert abs(last[k] - last0[k]) <= 1e-3 * abs(last0[k]), k
    # the re-fit moved the split field toward the old one
    assert last["loss"] < 0.8 * _clone_loss(tsplit, tm, ts, test_x)


def _clone_loss(new_mix, old_mix, spec, test_x):
    """The clone's test value loss of ``new_mix`` against ``old_mix``."""
    with torch.no_grad():
        x = torch.as_tensor(test_x)
        v, _ = tf.value_and_jac(new_mix, spec, x)
        rv, _ = tf.value_and_jac(old_mix, spec, x)
    return float((v - rv).abs().mean(-1).mean())
