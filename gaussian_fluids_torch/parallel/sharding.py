"""The sharded epochs: the JAX package's ``parallel/sharding.py`` over the
ranks of a (batch, gauss) mesh (``parallel/mesh.py``).

Two axes, as there: ``batch`` splits the B collocation points data-
parallel, ``gauss`` splits the padded Gaussian axis into G equal
contiguous slices. Each rank runs the port's kernels on its own (batch
rows, Gaussian shard) block; the collectives (``parallel/collectives.py``)
make the sums explicit:
  * every field evaluation (targets, heads, boundary) is a partial sum
    over the rank's Gaussians, summed over the gauss group;
  * data-term gradients and losses are means over the rank's rows,
    averaged over the batch group;
  * the regularizers are global masked means from (sum, count) pairs;
  * PCGrad takes its dots and norms over the gauss group.
A contiguous slice of a mixture sorted along x stays compact, so each
rank's tile masks and work lists are built on its shard as on one device.
The shard's own size picks the field path (``field._use_cells`` reads
the rank's B and N).

The sharded epochs evaluate exact per-epoch targets: the hoist and the
target grid do not apply under a mesh. The 2D covector target is the
staged RK4, each stage's value and the endpoint Jacobian summed over the
gauss group (the fused RK4 kernel evaluates the whole mixture at once).

An epoch's arguments are this rank's shards (``place``) and its own batch
rows; the one-step wrappers take the global batch and keep their rows
(``batch_rows``), as the JAX steps take batches laid over the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import (PARAM_KEYS,
                                                  GaussianMixture,
                                                  mixture_of)
from gaussian_fluids_torch.ops import field, spatial
from gaussian_fluids_torch.ops.advect import rk4_pos_stages
from gaussian_fluids_torch.parallel.collectives import (
    gather_rows, global_masked_mean, pcgrad_sharded, pmean_b, pmean_b_dict,
    psum_g, psum_g_many, regularizers)
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.solver import covector, losses, optim
from gaussian_fluids_torch.solver.fit import grads_of
from gaussian_fluids_torch.solver.project import (ProjectWeights,
                                                  _scaled_box, _sorted_by_key,
                                                  _sorted_by_x)


# ---- shards ----

def check_divisible(capacity: int, mesh):
    """The padded capacity must split into G equal shards; a mesh that
    does not divide it is refused, never padded quietly (capacities are
    multiples of 512, so G dividing 512 always does)."""
    if capacity % mesh.n_gauss:
        raise ValueError(f"capacity {capacity} does not split over "
                         f"{mesh.n_gauss} gauss ranks")


def shard_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous slice of the Gaussian axis."""
    check_divisible(t.shape[0], mesh)
    k = t.shape[0] // mesh.n_gauss
    return t[mesh.g * k:(mesh.g + 1) * k].contiguous()


def local_batch(batch_size: int, mesh) -> int:
    """A rank's rows of a global batch of ``batch_size``."""
    if batch_size % mesh.n_batch:
        raise ValueError(f"global batch {batch_size} not divisible by the "
                         f"batch mesh axis ({mesh.n_batch})")
    return batch_size // mesh.n_batch


def batch_rows(x: Optional[torch.Tensor], mesh):
    """This rank's contiguous slice of a global batch (None stays None)."""
    if x is None:
        return None
    k = local_batch(x.shape[0], mesh)
    return x[mesh.b * k:(mesh.b + 1) * k].contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh):
    return {k: shard_rows(v.detach(), mesh) for k, v in params.items()}


def shard_mixture(mix: GaussianMixture, mesh) -> GaussianMixture:
    return mixture_of(shard_params(mix.params(), mesh),
                      shard_rows(mix.alive, mesh))


def shard_opt_state(state: optim.OptState, mesh) -> optim.OptState:
    """Adam's moments follow their parameters' shards; the scalars (lr,
    step, plateau state) are the same on every rank."""
    return state._replace(groups={
        k: g._replace(m=shard_rows(g.m, mesh), v=shard_rows(g.v, mesh))
        for k, g in state.groups.items()})


def gather_params(params: Dict[str, torch.Tensor], mesh):
    """The whole parameter dict from the gauss group's shards."""
    return {k: gather_rows(v, mesh) for k, v in params.items()}


def _place(mesh, params, opt_state, alive):
    """(params, opt_state, alive) shards of global ones."""
    return (shard_params(params, mesh), shard_opt_state(opt_state, mesh),
            shard_rows(alive, mesh))


def _finish(params, opt_state, grads, total, mesh):
    """Average the data-term gradients over the batch group and step."""
    grads = pmean_b_dict(grads, mesh)
    return optim.step(opt_state, params, grads, total)


# ---- fit ----

def _fit_epoch(spec: FieldSpec, mesh):
    """The fit epoch on this rank: ``epoch(params, opt_state, alive, x,
    ref_val, ref_jac) -> (params, opt_state, total)`` on its rows."""

    def loss_fn(p, alive, x, ref_val, ref_jac):
        val, jac = psum_g_many(*field.value_and_jac(
            mixture_of(p, alive), spec, x, presorted=True, need_dx=False),
            mesh=mesh)
        l_val = losses.value_loss(val, ref_val)
        l_grad = losses.grad_loss(jac, ref_jac)
        l_aniso, l_vol = regularizers(p["scalings"], alive, mesh)
        total = l_val + l_grad + l_aniso + l_vol
        return total, torch.stack([l_val, l_grad, l_aniso, l_vol])

    def epoch(params, opt_state, alive, x, ref_val, ref_jac):
        if field._use_kernel(x):
            o = torch.argsort(x[:, 0])
            x, ref_val, ref_jac = x[o], ref_val[o], ref_jac[o]
        total, _, grads = grads_of(loss_fn, params, alive, x, ref_val,
                                   ref_jac)
        (total,) = pmean_b([total], mesh)
        params, opt_state = _finish(params, opt_state, grads, total, mesh)
        return params, opt_state, total

    return epoch


def make_sharded_train_step_shardmap(spec: FieldSpec, mesh):
    """(step, place): one fit epoch on this rank. ``place(params,
    opt_state, alive)`` gives this rank's shards of the global state;
    ``step(params, opt_state, alive, x, ref_val, ref_jac) -> (params,
    opt_state, total)`` takes the global batch and its references and
    keeps this rank's rows."""
    epoch = _fit_epoch(spec, mesh)

    def step(params, opt_state, alive, x, ref_val, ref_jac):
        return epoch(params, opt_state, alive, batch_rows(x, mesh),
                     batch_rows(ref_val, mesh), batch_rows(ref_jac, mesh))

    return step, lambda *a: _place(mesh, *a)


def make_sharded_train_step(spec: FieldSpec, mesh):
    """The JAX package's jit-with-shardings fit step, where XLA's
    partitioner inserts the collectives. PyTorch has no partitioner:
    this is the same per-rank step as
    :func:`make_sharded_train_step_shardmap`."""
    return make_sharded_train_step_shardmap(spec, mesh)


# ---- clone re-fit ----

def _clone_epoch(spec: FieldSpec, mesh):
    """The clone re-fit epoch on this rank: ``epoch(params, opt_state,
    alive, stop, old, x) -> (params, opt_state, aux)``, ``old`` this
    rank's shard of the old mixture, ``x`` its rows, aux = [l_val, l_grad,
    l_aniso, l_vol] of the global batch. The targets are the old field's
    (val, jac) at x, summed over the gauss group."""

    def loss_fn(p, alive, stop, x, ref_val, ref_jac):
        frozen = losses.freeze_params(p, stop)
        val, jac = psum_g_many(*field.value_and_jac(
            mixture_of(frozen, alive), spec, x, presorted=True,
            need_dx=False), mesh=mesh)
        l_val = losses.value_loss(val, ref_val)
        l_grad = losses.grad_loss(jac, ref_jac)
        l_aniso, l_vol = regularizers(p["scalings"], alive, mesh, stop)
        total = l_val + l_grad + l_aniso + l_vol
        return total, torch.stack([l_val, l_grad, l_aniso, l_vol])

    def epoch(params, opt_state, alive, stop, old, x):
        if field._use_kernel(x):
            x = x[torch.argsort(spatial.sort_key(x), stable=True)]
        with torch.no_grad():
            ref = psum_g_many(*field.value_and_jac(
                old, spec, x, presorted=True, need_dx=False), mesh=mesh)
        total, aux, grads = grads_of(loss_fn, params, alive, stop, x, *ref)
        total, aux = pmean_b([total, aux], mesh)
        params, opt_state = _finish(params, opt_state, grads, total, mesh)
        return params, opt_state, aux

    return epoch


def make_sharded_clone_step(spec: FieldSpec, mesh):
    """(step, place): one clone re-fit epoch on this rank (the JAX
    package's ``make_sharded_clone_step``). ``place(params, opt_state,
    alive, stop, old_mix)`` gives this rank's shards; ``step(params,
    opt_state, alive, stop, old, x) -> (params, opt_state, [l_val,
    l_grad, l_aniso, l_vol])`` takes the global batch."""
    epoch = _clone_epoch(spec, mesh)

    def step(params, opt_state, alive, stop, old, x):
        return epoch(params, opt_state, alive, stop, old,
                     batch_rows(x, mesh))

    def place(params, opt_state, alive, stop, old_mix):
        return _place(mesh, params, opt_state, alive) + (
            shard_rows(stop, mesh), shard_mixture(old_mix, mesh))

    return step, place


# ---- projection ----

def covector_target_2d(old: GaussianMixture, spec: FieldSpec, x, dt, lo, hi,
                       mesh):
    """The 2D covector target at this rank's rows through the sharded old
    field: the staged RK4 backtrace with each stage's value, and the
    endpoint Jacobian, summed over the gauss group before it is used (the
    JAX package's ``_project_epoch_2d._covector``)."""
    with torch.no_grad():
        bk = rk4_pos_stages(lambda p: psum_g(field.value(
            old, spec, p, presorted=True, need_dx=False), mesh), x, -dt)
        _, dv = field.value_and_jac(old, spec, bk, presorted=True,
                                    need_dx=False)
        return covector._finish_2d(bk, psum_g(dv, mesh), lo, hi)


def covector_target_3d(old: GaussianMixture, spec: FieldSpec, x, dt, mesh):
    """(vor, hel) at this rank's rows: the deformation backtrace with every
    stage's (val, jac) summed over the gauss group."""
    with torch.no_grad():
        return covector.covector_targets_3d_from(
            lambda p: psum_g_many(*field.value_and_jac(
                old, spec, p, presorted=True, need_dx=False), mesh=mesh),
            x, dt)


def _project_epoch_2d(spec: FieldSpec, mesh, scene_name: str,
                      boundary_lambda: float, weights=None):
    """The 2D projection epoch on this rank: ``epoch(params, opt_state,
    alive, positions_org, old, adv, dt, data, b1, b2) -> (params,
    opt_state, [l_vor, l_div, l_bnd])`` with this rank's rows: ``data``
    (B, 2), the Dirichlet rows ``b1`` = (points, values) and the flux
    rows ``b2`` = (points, normals, normal targets), None where the scene
    has no such sampler or ``boundary_lambda`` is 0. The two PCGrad heads
    sum the rank's partial (val, jac) over the gauss group inside
    themselves, so ``field.two_head_grads`` runs its one dual-cotangent
    backward per shard and its gradients land on the rank's own
    Gaussians."""
    w = weights or ProjectWeights()
    scene = get_scene_2d(scene_name)
    sf = scene.scaling_factor

    def boundary(m, b1, b2):
        bc = torch.zeros((), device=m.device)
        if b1 is not None:
            bc = bc + losses.boundary_dirichlet_loss(psum_g(field.value(
                m, spec, b1[0], presorted=True, need_dx=False), mesh), b1[1])
        if b2 is not None:
            bc = bc + losses.boundary_flux_loss(psum_g(field.value(
                m, spec, b2[0], presorted=True, need_dx=False), mesh),
                b2[1], b2[2])
        return bc

    def epoch(params, opt_state, alive, positions_org, old, adv, dt, data,
              b1=None, b2=None):
        lo, hi = _scaled_box(adv, sf)
        if field._use_kernel(data):
            data = _sorted_by_x(data)[0]
            b1 = _sorted_by_x(*b1) if b1 is not None else None
            b2 = _sorted_by_x(*b2) if b2 is not None else None
        ref_vor = covector_target_2d(old, spec, data, dt, lo, hi, mesh)

        def head_vor(val, jac):
            return w.vor * losses.vorticity_loss_2d(psum_g(jac, mesh),
                                                    ref_vor)

        def head_div(val, jac):
            return w.div * losses.divergence_loss(psum_g(jac, mesh))

        (l_vor, l_div), (g_vor, g_div) = field.two_head_grads(
            params, alive, spec, data, head_vor, head_div)
        g_vor, g_div = pmean_b_dict(g_vor, mesh), pmean_b_dict(g_div, mesh)
        g_data = pcgrad_sharded(g_vor, g_div, mesh)

        def rest(p):
            l_aniso, l_vol = regularizers(p["scalings"], alive, mesh)
            l_dp = global_masked_mean(
                ((p["positions"] - positions_org) ** 2).mean(-1), alive,
                mesh)
            total = w.aniso * l_aniso + w.vol * l_vol + w.delta_pos * l_dp
            bc = boundary(mixture_of(p, alive), b1, b2)
            return total + boundary_lambda * bc, bc

        l_rest, bc, g_rest = grads_of(rest, params)
        l_vor, l_div, l_rest, bc = pmean_b([l_vor, l_div, l_rest, bc], mesh)
        grads = {k: g_rest[k] + g_data[k] for k in params}
        params, opt_state = _finish(params, opt_state, grads,
                                    l_vor + l_div + l_rest, mesh)
        return params, opt_state, torch.stack([l_vor, l_div, bc])

    return epoch


def make_sharded_project_step_2d(spec: FieldSpec, mesh, scene_name: str,
                                 boundary_lambda: float = 1.0,
                                 weights=None):
    """(step, place): one 2D projection epoch on this rank (the JAX
    package's ``make_sharded_project_step_2d``). ``place(params,
    opt_state, alive, positions_org, old_mix)`` gives the shards;
    ``step(params, opt_state, alive, positions_org, old, adv, dt, data,
    b1=None, b2=None)`` takes the global batches (``b1``, ``b2`` as in
    ``_project_epoch_2d``) and returns (params, opt_state, [l_vor, l_div,
    l_bnd]) of the global batch."""
    epoch = _project_epoch_2d(spec, mesh, scene_name, boundary_lambda,
                              weights)

    def rows(b):
        return None if b is None else tuple(batch_rows(t, mesh) for t in b)

    def step(params, opt_state, alive, positions_org, old, adv, dt, data,
             b1=None, b2=None):
        return epoch(params, opt_state, alive, positions_org, old, adv, dt,
                     batch_rows(data, mesh), rows(b1), rows(b2))

    def place(params, opt_state, alive, positions_org, old_mix):
        return _place(mesh, params, opt_state, alive) + (
            shard_rows(positions_org.detach(), mesh),
            shard_mixture(old_mix, mesh))

    return step, place


def _project_epoch_3d(spec: FieldSpec, mesh, boundary_lambda: float,
                      weights=None):
    """The 3D projection epoch on this rank: ``epoch(params, opt_state,
    alive, old, dt, data, bnd) -> (params, opt_state, [l_vorhel, l_div,
    l_bnd])``, ``bnd`` the free-slip rows (points, normals) or None. The
    vorticity head carries the helicity; both heads sum the partial
    (val, jac) over the gauss group inside themselves."""
    w = weights or ProjectWeights(delta_pos=0.0)

    def epoch(params, opt_state, alive, old, dt, data, bnd=None):
        if field._use_kernel(data):
            data = _sorted_by_key(data)[0]
            bnd = _sorted_by_key(*bnd) if bnd is not None else None
        ref_vor, ref_hel = covector_target_3d(old, spec, data, dt, mesh)

        def head_vorhel(val, jac):
            val, jac = psum_g_many(val, jac, mesh=mesh)
            return (w.vor * losses.vorticity_loss_3d(jac, ref_vor)
                    + w.hel * losses.helicity_loss(val, jac, ref_hel))

        def head_div(val, jac):
            return w.div * losses.divergence_loss(psum_g(jac, mesh))

        (l_vorhel, l_div), (g_vor, g_div) = field.two_head_grads(
            params, alive, spec, data, head_vorhel, head_div)
        g_vor, g_div = pmean_b_dict(g_vor, mesh), pmean_b_dict(g_div, mesh)
        g_data = pcgrad_sharded(g_vor, g_div, mesh)

        def rest(p):
            l_aniso, l_vol = regularizers(p["scalings"], alive, mesh)
            vr = global_masked_mean(p["values"].abs().mean(-1), alive, mesh)
            total = w.aniso * l_aniso + w.vol * l_vol + w.val_reg * vr
            bc = torch.zeros((), device=data.device)
            if bnd is not None:
                bc = losses.boundary_freeslip_loss(psum_g(field.value(
                    mixture_of(p, alive), spec, bnd[0], presorted=True,
                    need_dx=False), mesh), bnd[1])
            return total + boundary_lambda * bc, bc

        l_rest, bc, g_rest = grads_of(rest, params)
        l_vorhel, l_div, l_rest, bc = pmean_b([l_vorhel, l_div, l_rest, bc],
                                              mesh)
        grads = {k: g_rest[k] + g_data[k] for k in params}
        params, opt_state = _finish(params, opt_state, grads,
                                    l_vorhel + l_div + l_rest, mesh)
        return params, opt_state, torch.stack([l_vorhel, l_div, bc])

    return epoch


def make_sharded_project_step_3d(spec: FieldSpec, mesh,
                                 boundary_lambda: float = 10.0,
                                 weights=None):
    """(step, place): one 3D projection epoch on this rank (the JAX
    package's ``make_sharded_project_step_3d``). ``place(params,
    opt_state, alive, old_mix)``; ``step(params, opt_state, alive, old,
    dt, data, bnd=None)`` with the global batches."""
    epoch = _project_epoch_3d(spec, mesh, boundary_lambda, weights)

    def step(params, opt_state, alive, old, dt, data, bnd=None):
        return epoch(params, opt_state, alive, old, dt,
                     batch_rows(data, mesh),
                     None if bnd is None else
                     tuple(batch_rows(t, mesh) for t in bnd))

    def place(params, opt_state, alive, old_mix):
        return _place(mesh, params, opt_state, alive) + (
            shard_mixture(old_mix, mesh),)

    return step, place


# ---- dry run ----

def _dryrun_rank(mesh, batch, n_gaussians):
    """The dry run's work on one rank: the fit, clone and 2D projection
    steps, the 2D projection and clone chunk runners and the density step
    on tiny seeded shapes; the fit's loss against the single-device
    epoch's on the same inputs."""
    from gaussian_fluids_torch.parallel import density, driver
    from gaussian_fluids_torch.solver import fit

    dev = mesh.device
    rng = np.random.RandomState(0)
    spec = FieldSpec.create((-5, -5), (5, 5), n_gaussians, d=2, vdim=2)
    mix = GaussianMixture.create(rng.uniform(-4, 4, (n_gaussians, 2)), spec,
                                 device=dev)
    p = mix.params()
    p["scalings"] = p["scalings"] + torch.as_tensor(
        0.2 * rng.randn(mix.capacity, 2), dtype=torch.float32, device=dev)
    p["values"] = torch.as_tensor(0.1 * rng.randn(mix.capacity, 2),
                                  dtype=torch.float32, device=dev)
    mix = mix.with_params(p)
    x = torch.as_tensor(rng.uniform(-4, 4, (batch, 2)), dtype=torch.float32,
                        device=dev)
    ref_val = torch.as_tensor(0.1 * rng.randn(batch, 2), dtype=torch.float32,
                              device=dev)
    ref_jac = torch.zeros((batch, 2, 2), device=dev)
    lrs = {k: 1e-3 for k in PARAM_KEYS}
    out = {}

    step, place = make_sharded_train_step_shardmap(spec, mesh)
    _, _, total = step(*place(p, optim.init(p, lrs), mix.alive), x, ref_val,
                       ref_jac)
    fit_epoch = fit.make_fit_epoch(spec, lambda q: ref_val, lambda q: ref_jac)
    single = fit_epoch((p, optim.init(p, lrs), mix.alive), x)[1][:4].sum()
    assert abs(float(total) - float(single)) <= 1e-4 * max(
        1.0, abs(float(single))), (float(total), float(single))
    out["fit_loss"] = float(total)

    scene = get_scene_2d("leapfrog")
    adv = torch.tensor(scene.advance_domain, dtype=torch.float32, device=dev)
    gen = mesh.generator(1)
    bd = scene.boundary_sampler_2(gen, batch, adv)
    pstep, pplace = make_sharded_project_step_2d(spec, mesh, "leapfrog", 1.0)
    _, _, ls = pstep(*pplace(p, optim.init(p, lrs), mix.alive,
                             mix.positions, mix), adv, 0.025, x, None, bd)
    assert torch.isfinite(ls).all(), ls
    out["project_losses"] = ls.tolist()

    stop = torch.as_tensor(rng.rand(mix.capacity) < 0.5, device=dev)
    cstep, cplace = make_sharded_clone_step(spec, mesh)
    _, _, aux = cstep(*cplace(p, optim.init(p, lrs), mix.alive, stop, mix), x)
    assert torch.isfinite(aux).all(), aux
    out["clone_losses"] = aux.tolist()

    run, cplace2 = driver.make_sharded_project_chunk_2d(
        spec, mesh, "leapfrog", 1.0, batch_size=batch)
    run(cplace2(p, optim.init(p, lrs), mix.alive, mix.positions, mix, adv,
                0.025), mesh.generator(5), 2)
    run, cplace3 = driver.make_sharded_clone_chunk(
        spec, mesh, batch, (-5.0, -5.0), (5.0, 5.0))
    run(cplace3(p, optim.init(p, lrs), mix.alive, stop, mix),
        mesh.generator(6), 2)

    spec3 = FieldSpec.create((-1, -1, -1), (1, 1, 1), n_gaussians, d=3,
                             vdim=3)
    mix3 = GaussianMixture.create(rng.uniform(-0.8, 0.8, (n_gaussians, 3)),
                                  spec3, device=dev)
    mix3.values = torch.as_tensor(0.1 * rng.randn(mix3.capacity, 3),
                                  dtype=torch.float32,
                                  device=dev) * mix3.alive[:, None]
    dens = density.advected_density_sharded(
        torch.as_tensor(rng.rand(8, 8, 8), dtype=torch.float32, device=dev),
        mix3.x_sorted(), spec3, (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0), 0.05,
        (8, 8, 8), mesh, chunk=8 * mesh.size)
    assert dens.shape == (8, 8, 8) and torch.isfinite(dens).all()
    out["density_mean"] = float(dens.mean())
    return out


def dryrun(n_ranks: int = 4, batch: int = 64, n_gaussians: int = 128,
           device="cpu", timeout: Optional[float] = 600.0) -> dict:
    """Launch an n-rank mesh ((n/2) x 2 where n is even) and run one real
    fit, clone and projection step, two epochs of each chunk runner and a
    density step on tiny shapes (the JAX package's ``dryrun``). Returns
    rank 0's losses."""
    from gaussian_fluids_torch.parallel.mesh import launch

    n_gauss = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    shape = (n_ranks // n_gauss, n_gauss)
    out = launch(_dryrun_rank, shape, (batch, n_gaussians), device=device,
                 timeout=timeout, threads=1)[0]
    print(f"[parallel.dryrun] mesh={shape} {out} OK")
    return out
