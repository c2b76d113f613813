"""The port's sharded epochs (``gaussian_fluids_torch/parallel/``) on gloo
meshes of CPU processes at (1, 2), (2, 1) and (2, 2), against the JAX
package's sharded steps on its 4 x 2 virtual mesh and against the port's
single-device epochs, on the same seeded inputs (the JAX package's own
sharded tests' states, ``tests/test_parallel.py``: anisotropic shapes and
random rotations, whose gradients are nowhere exactly zero).

Tolerances, those of ``tests/test_parallel.py``: parameters after one
Adam step rtol 2e-4, atol 1e-6; losses rtol 1e-5, atol 1e-7 (Karman's
against the JAX package rtol 1e-3, atol 1e-6, as there). Gradients
(Adam's first moments, 0.1 of them after one step) against the
single-device epoch within 1e-4 of each group's largest entry: a sum
over the gauss group in ``psum_g``'s backward would give G times them
(the JAX package's own sharded gradients are G times its single-device
ones, which a fresh Adam step all but hides, so only the parameters are
held against it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gaussian_fluids_torch.parallel.mesh import launch
from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.parallel import sharding as jsh
from gaussian_fluids_tpu.scenes import get_scene_2d, get_scene_3d
from gaussian_fluids_tpu.solver import optim as jopt

import torch_mesh_ranks as ranks

SHAPES = [(1, 2), (2, 1), (2, 2)]
KINDS = ["fit", "clone_2d", "clone_3d", "project_leapfrog",
         "project_karman", "project_3d"]
RANK_TIMEOUT = 300   # a hung collective fails its test
N, B = 128, 32


def _np_mix(m):
    return {"positions": np.asarray(m.positions),
            "scalings": np.asarray(m.scalings),
            "rotations": np.asarray(m.rotations),
            "values": np.asarray(m.values), "alive": np.asarray(m.alive)}


def _rand_mix(spec, seed, lo, hi, d):
    r = np.random.RandomState(seed)
    m = GaussianMixture.create(r.uniform(lo, hi, (N, d)), spec, pad=False)
    sca = m.scalings + jnp.asarray(0.2 * r.randn(N, d), jnp.float32)
    if d == 2:
        rot = jnp.asarray(r.uniform(-1, 1, (N,)), jnp.float32)
    else:
        rot = jnp.asarray(r.randn(N, 4) * 0.1 + np.array([1.0, 0, 0, 0]),
                          jnp.float32)
    return GaussianMixture(m.positions, sca, rot,
                           jnp.asarray(0.1 * r.randn(N, d), jnp.float32),
                           m.alive)


def _case(kind, spec, mix, lrs, **kw):
    return {"kind": kind, "spec": dict(spec.__dict__), "mix": _np_mix(mix),
            "lrs": dict(lrs), **kw}


def _weights(w):
    return dict(w._asdict())


def build_cases():
    """{name: (port case, JAX package's sharded step on its 4 x 2 mesh ->
    (params, losses))}."""
    from gaussian_fluids_tpu.solver.project import ProjectWeights
    out = {}
    put = functools.partial(jax.device_put)

    # fit (tests/test_parallel.py test_shardmap_step_matches_single_device)
    spec = FieldSpec.create((-5, -5), (5, 5), N, d=2, vdim=2)
    rng = np.random.RandomState(3)
    mix = _rand_mix(spec, 3, -4, 4, 2)
    x = rng.uniform(-4, 4, (B, 2)).astype(np.float32)
    rv = rng.randn(B, 2).astype(np.float32)
    rj = rng.randn(B, 2, 2).astype(np.float32)
    lrs = {k: 1e-3 for k in mix.params()}

    def jfit(mesh, spec=spec, mix=mix, x=x, rv=rv, rj=rj, lrs=lrs):
        step, place, ds = jsh.make_sharded_train_step_shardmap(spec, mesh)
        p, o, a = place(mix.params(), jopt.init(mix.params(), lrs), mix.alive)
        p, _, total = step(p, o, a, put(x, ds), put(rv, ds),
                           put(rj, NamedSharding(mesh, P("batch", None,
                                                         None))))
        return p, np.atleast_1d(np.asarray(total))
    out["fit"] = (_case("fit", spec, mix, lrs, x=x, ref_val=rv, ref_jac=rj),
                  jfit)

    # clone re-fit, 2D and 3D
    for d, seed in ((2, 7), (3, 9)):
        spec = FieldSpec.create((-5,) * d, (5,) * d, N, d=d, vdim=d)
        rng = np.random.RandomState(seed)
        mix, old = (_rand_mix(spec, seed, -4, 4, d),
                    _rand_mix(spec, seed + 1, -4, 4, d))
        stop = rng.rand(N) < 0.5
        x = rng.uniform(-4, 4, (B, d)).astype(np.float32)
        lrs = ({"positions": 1e-2, "scalings": 5e-2, "rotations": 5e-2,
                "values": 5e-3} if d == 2 else
               {k: 1e-3 for k in mix.params()})

        def jclone(mesh, spec=spec, mix=mix, old=old, stop=stop, x=x,
                   lrs=lrs):
            step, place, ds = jsh.make_sharded_clone_step(spec, mesh)
            args = place(mix.params(), jopt.init(mix.params(), lrs),
                         mix.alive, jnp.asarray(stop), old.params(),
                         old.alive)
            p, _, aux = step(*args, put(x, ds))
            return p, np.asarray(aux)
        out[f"clone_{d}d"] = (_case("clone", spec, mix, lrs,
                                    old=_np_mix(old), stop=stop, x=x),
                              jclone)

    # 2D projection, leapfrog (flux boundary) and karman (both samplers)
    for name, seed, dt in (("leapfrog", 5, 0.025), ("karman", 12, 0.05)):
        scene = get_scene_2d(name)
        sf = scene.scaling_factor
        adv = np.asarray(scene.advance_domain, np.float32)
        lo = np.asarray([adv[0], adv[2]]) * sf
        hi = np.asarray([adv[1], adv[3]]) * sf
        spec = FieldSpec.create(tuple(lo), tuple(hi), N, d=2, vdim=2)
        span = hi - lo
        mix, old = (_rand_mix(spec, seed + 1, lo + 0.1 * span,
                              hi - 0.1 * span, 2),
                    _rand_mix(spec, seed + 2, lo + 0.1 * span,
                              hi - 0.1 * span, 2))
        rng = np.random.RandomState(seed)
        data = rng.uniform(lo, hi, (B, 2)).astype(np.float32)
        b1 = b2 = None
        if scene.boundary_sampler_1 is not None:
            b1 = tuple(np.asarray(a) for a in scene.boundary_sampler_1(
                jax.random.PRNGKey(7), B, jnp.asarray(adv)))
        b2 = tuple(np.asarray(a) for a in scene.boundary_sampler_2(
            jax.random.PRNGKey(8), 8 if b1 is not None else B,
            jnp.asarray(adv)))
        w = ProjectWeights()
        lrs = {k: 1e-4 for k in mix.params()}

        def jproj(mesh, spec=spec, mix=mix, old=old, name=name, adv=adv,
                  dt=dt, data=data, b1=b1, b2=b2, w=w, lrs=lrs):
            step, place, ds = jsh.make_sharded_project_step_2d(
                spec, mesh, name, boundary_lambda=1.0, weights=w)
            args = place(mix.params(), jopt.init(mix.params(), lrs),
                         mix.alive, mix.positions, old.params(), old.alive)
            rows = (put(data, ds),)
            if b1 is not None:
                rows += (put(b1[0], ds), put(b1[1], ds))
            rows += (put(b2[0], ds), put(b2[1], ds),
                     put(b2[2], NamedSharding(mesh, P("batch"))))
            p, _, ls = step(*args, jnp.asarray(adv),
                            jnp.asarray(dt, jnp.float32), *rows)
            return p, np.asarray(ls)
        out[f"project_{name}"] = (
            _case("project_2d", spec, mix, lrs, old=_np_mix(old),
                  scene=name, lam=1.0, weights=_weights(w), adv=adv, dt=dt,
                  data=data, b1=b1, b2=b2), jproj)

    # 3D projection (ring_collide's free-slip sampler)
    spec = FieldSpec.create((-5,) * 3, (5,) * 3, N, d=3, vdim=3)
    mix, old = (_rand_mix(spec, 8, -4, 4, 3), _rand_mix(spec, 9, -4, 4, 3))
    rng = np.random.RandomState(4)
    data = rng.uniform(-4.5, 4.5, (B, 3)).astype(np.float32)
    bnd = tuple(np.asarray(a) for a in get_scene_3d(
        "ring_collide").boundary_sampler(jax.random.PRNGKey(3), B))
    w = ProjectWeights(delta_pos=0.0)
    lrs = {k: 3e-4 for k in mix.params()}

    def jproj3(mesh, spec=spec, mix=mix, old=old, data=data, bnd=bnd, w=w,
               lrs=lrs):
        step, place, ds = jsh.make_sharded_project_step_3d(
            spec, mesh, boundary_lambda=10.0, weights=w)
        args = place(mix.params(), jopt.init(mix.params(), lrs), mix.alive,
                     old.params(), old.alive)
        p, _, ls = step(*args, jnp.asarray(0.02, jnp.float32),
                        put(data, ds), put(bnd[0], ds), put(bnd[1], ds))
        return p, np.asarray(ls)
    out["project_3d"] = (
        _case("project_3d", spec, mix, lrs, old=_np_mix(old),
              scene="ring_collide", lam=10.0, weights=_weights(w), dt=0.02,
              data=data, bnd=bnd), jproj3)
    return out


@pytest.fixture(scope="module")
def cases():
    return build_cases()


@pytest.fixture(scope="module")
def sharded(cases):
    """{mesh shape: every rank's results}, launched once a shape."""
    got = {}

    def at(shape):
        if shape not in got:
            got[shape] = launch(ranks.epochs_rank, shape,
                                ({k: c for k, (c, _) in cases.items()},),
                                device="cpu", timeout=RANK_TIMEOUT,
                                threads=1)
        return got[shape]
    return at


@pytest.fixture(scope="module")
def jax_sharded(cases, monkeypatch_module):
    monkeypatch_module.setenv("GF_FIELD_BACKEND", "dense")
    mesh = jsh.make_mesh(4, 2)
    got = {}

    def of(kind):
        if kind not in got:
            p, ls = cases[kind][1](mesh)
            got[kind] = ({k: np.asarray(v) for k, v in p.items()}, ls)
        return got[kind]
    return of


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def single(cases):
    return {k: ranks.single(c) for k, (c, _) in cases.items()}


def _grads_close(got, want, tol=1e-4, msg=""):
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * scale, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_epoch_matches_single_device(kind, shape, sharded, single):
    """Losses, gradients and parameters of one sharded epoch against the
    port's single-device epoch; every rank ends with the same global
    parameters."""
    per_rank = [r[kind] for r in sharded(shape)]
    got, want = per_rank[0], single[kind]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-7)
    _grads_close(got["m"], want["m"], msg=kind)
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    for other in per_rank[1:]:
        for k in got["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          got["params"][k])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_epoch_matches_jax_sharded(kind, shape, sharded,
                                           jax_sharded):
    """Parameters and losses of one sharded epoch against the JAX
    package's sharded step on its 4 x 2 mesh."""
    got = sharded(shape)[0][kind]
    jp, jls = jax_sharded(kind)
    rtol, atol = (1e-3, 1e-6) if kind == "project_karman" else (1e-5, 1e-7)
    np.testing.assert_allclose(got["losses"], jls, rtol=rtol, atol=atol)
    for k in jp:
        np.testing.assert_allclose(got["params"][k], jp[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_clone_epoch_freezes_the_stopped_rows(cases, sharded):
    """Frozen rows of the sharded clone epoch get exactly zero gradient."""
    for kind in ("clone_2d", "clone_3d"):
        stop = cases[kind][0]["stop"]
        for k, m in sharded((2, 2))[0][kind]["m"].items():
            assert np.all(m[stop] == 0.0), (kind, k)


@pytest.fixture(scope="module")
def reg_case(cases):
    c = cases["clone_2d"][0]
    return {k: c[k] for k in ("kind", "spec", "mix", "stop", "x")}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_psum_g_backward_is_the_identity(shape, reg_case):
    """The regularizers' global masked means and a loss of the field
    summed by ``psum_g`` give the single-device gradients on every shard
    (within 1e-5 of each group's largest entry); ``torch.distributed.nn``'s
    all-reduce, whose backward sums over the group, gives G times them."""
    got = launch(ranks.regularizer_grads_rank, shape, (reg_case,),
                 device="cpu", timeout=RANK_TIMEOUT, threads=1)[0]
    want = ranks.single_regularizer_grads(reg_case)
    _grads_close(got["regularizers"], want["regularizers"], 1e-5,
                 "regularizers")
    _grads_close(got["psum_g"], want["psum_g"], 1e-5, "psum_g")
    if shape[1] > 1:
        _grads_close(got["all_reduce"],
                     {k: shape[1] * v for k, v in want["psum_g"].items()},
                     1e-5, "all_reduce")
