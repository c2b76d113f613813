"""Per-rank work of the mesh tests (``tests/test_torch_mesh_*.py``).

``parallel.mesh.launch`` spawns the ranks, which import these functions
by name; so they live here, with torch, numpy and the port only (no JAX,
which a rank would otherwise import with the test module). Inputs arrive
as numpy arrays (``case`` dicts, the same the tests give the JAX package
and the port's single-device epochs); results leave as numpy arrays.
Each epoch kind's ``single_*`` twin runs the port's single-device epoch
on the same case in the test process.
"""

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import PARAM_KEYS, mixture_of
from gaussian_fluids_torch.parallel import collectives, density, driver
from gaussian_fluids_torch.parallel import sharding
from gaussian_fluids_torch.solver import clone, fit, losses, optim, project
from gaussian_fluids_torch.solver.simulate3d import advected_density


def t(a, device="cpu"):
    return None if a is None else torch.as_tensor(np.array(a),
                                                  device=device)


def rows(b):
    return None if b is None else tuple(t(v) for v in b)


def mix_of(m):
    """The port's mixture over a case's parameter arrays and alive mask."""
    return mixture_of({k: t(m[k]).float() for k in PARAM_KEYS},
                      t(m["alive"]).bool())


def spec_of(c):
    return FieldSpec(**c["spec"])


def weights_of(c):
    return project.ProjectWeights(**c["weights"])


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def result(params, opt_state, ls):
    """Global parameters after the epoch, Adam's first moments (0.1 of
    the gradients after one step) and the losses."""
    return {"params": _np(params),
            "m": {k: g.m.detach().cpu().numpy()
                  for k, g in opt_state.groups.items()},
            "losses": np.atleast_1d(np.asarray(ls.detach().cpu()))}


def _gathered(mesh, params, opt_state, ls):
    return result(sharding.gather_params(params, mesh),
                  opt_state._replace(groups={
                      k: g._replace(m=collectives.gather_rows(g.m, mesh))
                      for k, g in opt_state.groups.items()}), ls)


def _init(mix, c):
    p = mix.params()
    return p, optim.init(p, c["lrs"], patience=50)


# ---- the sharded epochs on one rank ----

def sharded_fit(mesh, c):
    spec, mix = spec_of(c), mix_of(c["mix"])
    p, opt = _init(mix, c)
    step, place = sharding.make_sharded_train_step_shardmap(spec, mesh)
    params, opt, total = step(*place(p, opt, mix.alive), t(c["x"]),
                              t(c["ref_val"]), t(c["ref_jac"]))
    return _gathered(mesh, params, opt, total)


def sharded_clone(mesh, c):
    spec, mix, old = spec_of(c), mix_of(c["mix"]), mix_of(c["old"])
    p, opt = _init(mix, c)
    step, place = sharding.make_sharded_clone_step(spec, mesh)
    params, opt, aux = step(*place(p, opt, mix.alive, t(c["stop"]), old),
                            t(c["x"]))
    return _gathered(mesh, params, opt, aux)


def sharded_project_2d(mesh, c):
    spec, mix, old = spec_of(c), mix_of(c["mix"]), mix_of(c["old"])
    p, opt = _init(mix, c)
    step, place = sharding.make_sharded_project_step_2d(
        spec, mesh, c["scene"], c["lam"], weights_of(c))
    params, opt, ls = step(*place(p, opt, mix.alive, mix.positions, old),
                           t(c["adv"]), c["dt"], t(c["data"]),
                           rows(c.get("b1")), rows(c.get("b2")))
    return _gathered(mesh, params, opt, ls)


def sharded_project_3d(mesh, c):
    spec, mix, old = spec_of(c), mix_of(c["mix"]), mix_of(c["old"])
    p, opt = _init(mix, c)
    step, place = sharding.make_sharded_project_step_3d(
        spec, mesh, c["lam"], weights_of(c))
    params, opt, ls = step(*place(p, opt, mix.alive, old), c["dt"],
                           t(c["data"]), rows(c.get("bnd")))
    return _gathered(mesh, params, opt, ls)


SHARDED = {"fit": sharded_fit, "clone": sharded_clone,
           "project_2d": sharded_project_2d,
           "project_3d": sharded_project_3d}


def epochs_rank(mesh, cases):
    """Every case's sharded epoch on this rank: {name: result}."""
    torch.manual_seed(0)
    return {name: SHARDED[c["kind"]](mesh, c) for name, c in cases.items()}


# ---- the port's single-device epochs, in the test process ----

def single(c):
    spec, mix = spec_of(c), mix_of(c["mix"])
    p, opt = _init(mix, c)
    kind = c["kind"]
    if kind == "fit":
        epoch = fit.make_fit_epoch(spec, lambda x: t(c["ref_val"]),
                                   lambda x: t(c["ref_jac"]))
        (params, opt, _), aux = epoch((p, opt, mix.alive), t(c["x"]))
        return result(params, opt, aux[:4].sum())
    old = mix_of(c["old"])
    if kind == "clone":
        lo, hi = spec.lo, spec.hi
        (params, opt, *_), aux = clone._clone_runner(
            spec, len(c["x"]), lo, hi).epoch(
            (p, opt, mix.alive, t(c["stop"]), old), t(c["x"]))
        return result(params, opt, aux)
    if kind == "project_2d":
        runner = project._runner_2d(spec, c["scene"], weights_of(c),
                                    c["lam"], len(c["data"]))
        (params, opt, *_), ls = runner.epoch(
            (p, opt, mix.alive, mix.positions.detach(), old, t(c["adv"]),
             c["dt"]), (t(c["data"]), None, rows(c.get("b1")),
                        rows(c.get("b2"))))
        return result(params, opt, ls)
    runner = project._runner_3d(spec, c["scene"], weights_of(c), c["lam"],
                                len(c["data"]), spec.lo, spec.hi)
    (params, opt, *_), ls = runner.epoch(
        (p, opt, mix.alive, old, c["dt"]),
        (t(c["data"]), None, None, rows(c.get("bnd"))))
    return result(params, opt, ls)


# ---- the collectives' gradients ----

def regularizer_grads_rank(mesh, c):
    """Gradients of the sharded regularizers and of a loss of the summed
    field (``collectives.psum_g``), gathered; beside them the same
    field loss summed with ``torch.distributed.nn``'s all-reduce, whose
    backward sums the gradients over the group too."""
    from torch.distributed.nn.functional import all_reduce
    spec, mix = spec_of(c), mix_of(c["mix"])
    shard = sharding.shard_mixture(mix, mesh)
    stop = sharding.shard_rows(t(c["stop"]), mesh)
    x = sharding.batch_rows(t(c["x"]), mesh)
    out = {}

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in shard.params().items()}
        g = torch.autograd.grad(fn(leaves), list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
        g = collectives.pmean_b(list(g), mesh)
        return {k: collectives.gather_rows(v, mesh).numpy()
                for k, v in zip(leaves, g)}

    def reg(p):
        a, v = collectives.regularizers(p["scalings"], shard.alive, mesh)
        ca, cv = collectives.regularizers(p["scalings"], shard.alive, mesh,
                                          stop)
        return a + 2.0 * v + 3.0 * ca + 4.0 * cv

    def field_loss(total):
        def f(p):
            from gaussian_fluids_torch.ops import field
            val = field.value(mixture_of(p, shard.alive), spec, x)
            return (total(val) ** 2).mean()
        return f

    out["regularizers"] = grads(reg)
    out["psum_g"] = grads(field_loss(lambda v: collectives.psum_g(v, mesh)))
    if mesh.n_gauss > 1:
        out["all_reduce"] = grads(field_loss(
            lambda v: all_reduce(v, group=mesh.gauss_group)))
    return out


def single_regularizer_grads(c):
    from gaussian_fluids_torch.ops import field
    spec, mix = spec_of(c), mix_of(c["mix"])
    stop, x = t(c["stop"]), t(c["x"])
    out = {}

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in mix.params().items()}
        g = torch.autograd.grad(fn(leaves), list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
        return {k: v.numpy() for k, v in zip(leaves, g)}

    alive = mix.alive
    out["regularizers"] = grads(lambda p: (
        losses.aniso_loss(p["scalings"], alive)
        + 2.0 * losses.volume_loss(p["scalings"], alive)
        + 3.0 * losses.aniso_loss(p["scalings"], alive & ~stop)
        + 4.0 * losses.volume_loss(p["scalings"], alive, detach_mask=stop)))
    out["psum_g"] = grads(lambda p: (field.value(
        mixture_of(p, alive), spec, x) ** 2).mean())
    return out


# ---- chunk runners against repeated steps ----

def chunk_rank(mesh, cases, n):
    """For each case, ``n`` epochs of its chunk runner against ``n`` calls
    of the epoch on batches drawn from a twin generator in the runner's
    order: the largest difference of the parameters."""
    out = {}
    for name, c in cases.items():
        spec, mix = spec_of(c), mix_of(c["mix"])
        old = mix_of(c["old"]) if "old" in c else mix
        p, opt = _init(mix, c)
        b = c["batch"]
        if c["kind"] == "project_2d":
            run, place = driver.make_sharded_project_chunk_2d(
                spec, mesh, c["scene"], c["lam"], weights_of(c), b)
            carry = place(p, opt, mix.alive, mix.positions, old,
                          t(c["adv"]), c["dt"])
            epoch = sharding._project_epoch_2d(spec, mesh, c["scene"],
                                               c["lam"], weights_of(c))
            sample = project._runner_2d(spec, c["scene"], weights_of(c),
                                        c["lam"], b // mesh.n_batch).sample

            def steps(carry, gen):
                params, o, alive, pos, old_s, adv, dt = carry
                for _ in range(n):
                    data, _, b1, b2 = sample(gen, adv)
                    params, o, _ = epoch(params, o, alive, pos, old_s, adv,
                                         dt, data, b1, b2)
                return params
        elif c["kind"] == "project_3d":
            run, place = driver.make_sharded_project_chunk_3d(
                spec, mesh, c["scene"], spec.lo, spec.hi, c["lam"],
                weights_of(c), b)
            carry = place(p, opt, mix.alive, old, c["dt"])
            epoch = sharding._project_epoch_3d(spec, mesh, c["lam"],
                                               weights_of(c))
            sample = project._runner_3d(spec, c["scene"], weights_of(c),
                                        c["lam"], b // mesh.n_batch,
                                        spec.lo, spec.hi).sample

            def steps(carry, gen):
                params, o, alive, old_s, dt = carry
                for _ in range(n):
                    data, _, _, bnd = sample(gen)
                    params, o, _ = epoch(params, o, alive, old_s, dt, data,
                                         bnd)
                return params
        else:
            run, place = driver.make_sharded_clone_chunk(
                spec, mesh, b, spec.lo, spec.hi)
            carry = place(p, opt, mix.alive, t(c["stop"]), old)
            epoch = sharding._clone_epoch(spec, mesh)
            lo = torch.tensor(spec.lo)
            hi = torch.tensor(spec.hi)

            def steps(carry, gen):
                params, o, alive, stop, old_s = carry
                for _ in range(n):
                    params, o, _ = epoch(
                        params, o, alive, stop, old_s,
                        fit.uniform_batch(gen, b // mesh.n_batch, lo, hi))
                return params
        got = run(carry, mesh.generator(3), n)[0]
        want = steps(carry, mesh.generator(3))
        out[name] = max(float((got[k] - want[k]).abs().max()) for k in got)
    return out


# ---- the density step ----

def density_rank(mesh, c):
    spec = spec_of(c)
    return density.advected_density_sharded(
        t(c["density"]), mix_of(c["mix"]), spec, c["domain"], c["dt"],
        c["grid"], mesh, chunk=c["chunk"]).numpy()


def single_density(c):
    return advected_density(t(c["density"]), mix_of(c["mix"]), spec_of(c),
                            c["domain"], c["dt"], c["grid"],
                            chunk=c["chunk"]).numpy()


# ---- the host loops end to end ----

def phases_rank(mesh, c):
    """``clone_velocity_field_sharded`` then ``project_2d_sharded`` (a
    few chunks each) on the case's 2D state: the gathered mixtures and
    the test metrics."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    spec, mix = spec_of(c), mix_of(c["mix"])
    scene = get_scene_2d(c["scene"])
    new, clone_m = driver.clone_velocity_field_sharded(
        mix, spec, mesh=mesh, lo=spec.lo, hi=spec.hi, test_x=t(c["test_x"]),
        gen=mesh.generator(1), seed=c["seed"], d=2, batch_size=c["batch"],
        max_epoch=c["epochs"], check_iter=c["check_iter"], verbose=0)
    proj, proj_m = driver.project_2d_sharded(
        new, spec, mix, c["dt"], mesh=mesh, scene=scene,
        adv_domain=scene.advance_domain, test_x=t(c["test_x"]),
        gen=mesh.generator(2), test_gen=torch.Generator().manual_seed(3),
        batch_size=c["batch"], max_epoch=c["epochs"],
        check_iter=c["check_iter"], verbose=0)
    return {"clone": _np(new.params()) | {"alive": new.alive.numpy()},
            "project": _np(proj.params()) | {"alive": proj.alive.numpy()},
            "clone_metrics": clone_m, "project_metrics": proj_m}


# ---- the mesh itself ----

def basics_rank(mesh):
    """This rank's coordinates, a draw of its batch-row generator, the
    gathered shards of a global arange and of a bool mask, and rank 0's
    value broadcast."""
    ar = torch.arange(8 * mesh.n_gauss, dtype=torch.float32)
    mask = ar.long() % 3 == 0
    from gaussian_fluids_torch.parallel.mesh import reshape
    flat = reshape(mesh, (1, mesh.size))
    ones = collectives.psum_g(torch.ones(1), flat)
    return {"coords": (mesh.b, mesh.g, mesh.rank, mesh.size),
            "reshaped": (flat.b, flat.g, flat.rank, float(ones)),
            "draw": torch.rand(4, generator=mesh.generator(5)).numpy(),
            "gathered": collectives.gather_rows(
                sharding.shard_rows(ar, mesh), mesh).numpy(),
            "mask": collectives.gather_rows(
                sharding.shard_rows(mask, mesh), mesh).numpy(),
            "broadcast": collectives.broadcast(
                torch.tensor([float(mesh.rank + 7)]), mesh).numpy()}


def failing_rank(mesh):
    """Rank 1 raises while the others wait in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed")
    collectives.broadcast(torch.zeros(1), mesh, src=1)


def failing_rank_0(mesh):
    """Rank 0 raises while rank 1 waits in a broadcast from it."""
    if mesh.rank == 0:
        raise FloatingPointError("rank 0 failed")
    collectives.broadcast(torch.zeros(1), mesh, src=0)


def sleeping_rank(mesh, seconds):
    import time
    time.sleep(seconds)


# ---- the 3D frame loop ----

def advance_3d_rank(mesh, out_dir, kwargs):
    """``simulate3d.advance_3d`` on this rank of the mesh: its frames and
    the final mixture."""
    from gaussian_fluids_torch.solver.simulate3d import advance_3d
    mix, _, frames = advance_3d("leapfrog", out_dir, mesh=mesh, **kwargs)
    return {"frames": frames,
            "mix": _np(mix.params()) | {"alive": mix.alive.numpy()}}
