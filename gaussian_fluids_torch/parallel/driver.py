"""The multi-device frame-loop phases: the sharded epochs
(``parallel/sharding.py``) as runnable loops, the JAX package's
``parallel/driver.py``.

``make_sharded_*_chunk`` give a rank's chunk runner: n epochs, each
drawing its own rows with the rank's batch-row generator
(``Mesh.generator``: the ranks of one row draw the same samples, so the
global batch is ``batch_size`` split over the batch axis, the statistics
of the single-device epoch at equal global batch), in the draw order of
the single-device runners. ``project_2d_sharded``, ``project_3d_sharded``
and ``clone_velocity_field_sharded`` are the host loops around them, with
the single-device defaults and patience (``loop.run_chunked``).

Every rank must take the same early-stop decision and raise the same
``FloatingPointError``, or the others would wait in a collective: rank 0
computes the test metrics with the single-device test functions on the
gathered mixture and broadcasts them, and every rank reads the same
numbers. The clone's split runs on the global mixture, the same numpy
draws on every rank, and its freeze mask is rank 0's. Each phase returns
the same global mixture on every rank.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import (PARAM_KEYS,
                                                  GaussianMixture,
                                                  mixture_of)
from gaussian_fluids_torch.parallel import sharding
from gaussian_fluids_torch.parallel.collectives import broadcast
from gaussian_fluids_torch.solver import clone, optim, project
from gaussian_fluids_torch.solver.fit import uniform_batch
from gaussian_fluids_torch.solver.loop import Patience, run_chunked


def make_sharded_project_chunk_2d(spec: FieldSpec, mesh, scene_name: str,
                                  boundary_lambda: float = 1.0,
                                  weights=None, batch_size: int = 512):
    """(run_chunk, place): ``run_chunk(carry, gen, n)`` runs n sharded 2D
    projection epochs; carry = (params, opt_state, alive, positions_org,
    old, adv, dt) as the single-device runner's, sharded by
    ``place(params, opt_state, alive, positions_org, old_mix, adv, dt)``.
    ``batch_size`` is the global batch."""
    w = weights or project.ProjectWeights()
    epoch = sharding._project_epoch_2d(spec, mesh, scene_name,
                                       boundary_lambda, w)
    sample = project._runner_2d(spec, scene_name, w, boundary_lambda,
                                sharding.local_batch(batch_size, mesh)).sample

    def run_chunk(carry, gen, n):
        params, opt_state, alive, pos_org, old, adv, dt = carry
        for _ in range(n):
            data, _, b1, b2 = sample(gen, adv)
            params, opt_state, _ = epoch(params, opt_state, alive, pos_org,
                                         old, adv, dt, data, b1, b2)
        return params, opt_state, alive, pos_org, old, adv, dt

    def place(params, opt_state, alive, positions_org, old_mix, adv, dt):
        p, o, a = sharding._place(mesh, params, opt_state, alive)
        return (p, o, a, sharding.shard_rows(positions_org.detach(), mesh),
                sharding.shard_mixture(old_mix, mesh),
                torch.as_tensor(adv, dtype=torch.float32, device=mesh.device),
                float(dt))

    return run_chunk, place


def make_sharded_project_chunk_3d(spec: FieldSpec, mesh,
                                  scene_name: Optional[str], lo, hi,
                                  boundary_lambda: float = 10.0,
                                  weights=None, batch_size: int = 8192):
    """(run_chunk, place): the 3D twin; carry = (params, opt_state, alive,
    old, dt), ``place(params, opt_state, alive, old_mix, dt)``; ``lo``,
    ``hi`` the sampling box corners."""
    w = weights or project.ProjectWeights(delta_pos=0.0)
    epoch = sharding._project_epoch_3d(spec, mesh, boundary_lambda, w)
    sample = project._runner_3d(spec, scene_name, w, boundary_lambda,
                                sharding.local_batch(batch_size, mesh),
                                tuple(lo), tuple(hi)).sample

    def run_chunk(carry, gen, n):
        params, opt_state, alive, old, dt = carry
        for _ in range(n):
            data, _, _, bnd = sample(gen)
            params, opt_state, _ = epoch(params, opt_state, alive, old, dt,
                                         data, bnd)
        return params, opt_state, alive, old, dt

    def place(params, opt_state, alive, old_mix, dt):
        return sharding._place(mesh, params, opt_state, alive) + (
            sharding.shard_mixture(old_mix, mesh), float(dt))

    return run_chunk, place


def make_sharded_clone_chunk(spec: FieldSpec, mesh, batch_size: int = 512,
                             lo=None, hi=None):
    """(run_chunk, place): n sharded clone re-fit epochs over the box
    (lo, hi); carry = (params, opt_state, alive, stop, old), ``place(
    params, opt_state, alive, stop, old_mix)``."""
    epoch = sharding._clone_epoch(spec, mesh)
    b_local = sharding.local_batch(batch_size, mesh)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=mesh.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=mesh.device)

    def run_chunk(carry, gen, n):
        params, opt_state, alive, stop, old = carry
        for _ in range(n):
            params, opt_state, _ = epoch(params, opt_state, alive, stop, old,
                                         uniform_batch(gen, b_local, lo_t,
                                                       hi_t))
        return params, opt_state, alive, stop, old

    def place(params, opt_state, alive, stop, old_mix):
        return sharding._place(mesh, params, opt_state, alive) + (
            sharding.shard_rows(stop, mesh),
            sharding.shard_mixture(old_mix, mesh))

    return run_chunk, place


def _agreed_metrics(mesh, carry, test, size: int):
    """Rank 0's ``size`` test metrics on the gathered mixture, on every
    rank. ``test(params) -> tensor`` runs on rank 0 only."""
    params = sharding.gather_params(carry[0], mesh) if mesh.b == 0 else None
    m = test(params).to(torch.float32) if mesh.rank == 0 else \
        torch.zeros(size, dtype=torch.float32, device=mesh.device)
    return broadcast(m.contiguous(), mesh).tolist()


def _global_mix(mix: GaussianMixture, carry, mesh) -> GaussianMixture:
    """``mix`` with the run's parameters gathered over the gauss group (the
    batch rows hold the same ones)."""
    return mix.with_params(sharding.gather_params(carry[0], mesh))


def project_2d_sharded(mix: GaussianMixture, spec: FieldSpec,
                       old_mix: GaussianMixture, dt: float, *, mesh, scene,
                       adv_domain, test_x, gen: torch.Generator,
                       test_gen: torch.Generator,
                       weights: project.ProjectWeights =
                       project.ProjectWeights(),
                       boundary_lambda: float = 1.0,
                       lrs: Optional[Dict[str, float]] = None,
                       batch_size: int = 512, max_epoch: int = 3000,
                       patience: int = 500, check_iter: int = 100,
                       verbose: int = 1):
    """The multi-device ``project_2d``: every epoch sharded over ``mesh``
    with exact per-epoch targets; ``gen`` is this rank's batch-row
    generator, ``test_gen`` rank 0's for the test metrics' boundary
    draws. Returns (new global mixture, the last test metrics keyed by
    ``project.METRIC_NAMES``)."""
    if lrs is None:
        lrs = dict(project.DEFAULT_LRS_2D)
    run_chunk, place = make_sharded_project_chunk_2d(
        spec, mesh, scene.name, float(boundary_lambda), weights, batch_size)
    runner = project._runner_2d(spec, scene.name, weights,
                                float(boundary_lambda), batch_size)
    dev = mesh.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    adv = torch.tensor(adv_domain, dtype=torch.float32, device=dev)
    params = mix.params()
    pos_org = mix.positions.detach()
    carry = place(params, optim.init(params, lrs, patience=50), mix.alive,
                  pos_org, old_mix, adv, float(dt))
    test_ref = runner.test_ref_fn(old_mix, test_x, adv, float(dt)) \
        if mesh.rank == 0 else None
    last = {}

    def metrics(c):
        return _agreed_metrics(mesh, c, lambda p: runner.test_fn(
            p, mix.alive, pos_org, adv, test_x, test_ref, test_gen),
            len(project.METRIC_NAMES))

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in
                         zip(project.METRIC_NAMES, mh))

    if verbose:   # every rank: the metrics are a collective
        print(f"[projection/sharded] {line(metrics(carry))}")
    pat_vor, pat_div = (Patience(t) for t in project.PATIENCE_REL_2D)
    st = time.time()

    def dispatch(c, n):
        c = run_chunk(c, gen, n)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(project.METRIC_NAMES, mh))
        if verbose:
            print(f"[projection/sharded] {line(mh)}, "
                  f"time: {time.time() - st}")
            st = time.time()
        pat_vor.update(mh[0], n)
        pat_div.update(mh[1], n)
        return pat_vor.iters >= patience and pat_div.iters >= patience

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "projection/sharded")
    return _global_mix(mix, carry, mesh), last


def project_3d_sharded(mix: GaussianMixture, spec: FieldSpec,
                       old_mix: GaussianMixture, dt: float, *, mesh, domain,
                       test_x, gen: torch.Generator,
                       test_gen: torch.Generator,
                       scene_name: Optional[str] = None,
                       weights: project.ProjectWeights =
                       project.ProjectWeights(delta_pos=0.0),
                       boundary_lambda: float = 10.0,
                       lrs: Optional[Dict[str, float]] = None,
                       batch_size: int = 8192, max_epoch: int = 3000,
                       patience: int = 500, check_iter: int = 100,
                       verbose: int = 1):
    """The multi-device ``project_3d`` (``project_2d_sharded``'s
    conventions). Returns (new global mixture, the last test metrics
    keyed by ``project.METRIC_NAMES_3D``)."""
    if lrs is None:
        lrs = dict(project.DEFAULT_LRS_3D)
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    lo, hi = (x_min, y_min, z_min), (x_max, y_max, z_max)
    run_chunk, place = make_sharded_project_chunk_3d(
        spec, mesh, scene_name, lo, hi, float(boundary_lambda), weights,
        batch_size)
    runner = project._runner_3d(spec, scene_name, weights,
                                float(boundary_lambda), batch_size, lo, hi)
    dev = mesh.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    params = mix.params()
    carry = place(params, optim.init(params, lrs, patience=50), mix.alive,
                  old_mix, float(dt))
    test_ref = runner.test_ref_fn(old_mix, test_x, float(dt)) \
        if mesh.rank == 0 else None
    last = {}

    def metrics(c):
        return _agreed_metrics(mesh, c, lambda p: runner.test_fn(
            p, mix.alive, test_x, test_ref, test_gen),
            len(project.METRIC_NAMES_3D))

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in
                         zip(project.METRIC_NAMES_3D, mh))

    if verbose:   # every rank: the metrics are a collective
        print(f"[projection/sharded] {line(metrics(carry))}")
    pats = [Patience(t) for t in project.PATIENCE_REL_3D]
    st = time.time()

    def dispatch(c, n):
        c = run_chunk(c, gen, n)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(project.METRIC_NAMES_3D, mh))
        if verbose:
            print(f"[projection/sharded] {line(mh)}, "
                  f"time: {time.time() - st}")
            st = time.time()
        for pat, v in zip(pats, mh[:3]):
            pat.update(v, n)
        return all(pat.iters >= patience for pat in pats)

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "projection/sharded")
    return _global_mix(mix, carry, mesh), last


def clone_velocity_field_sharded(old_mix: GaussianMixture, spec: FieldSpec,
                                 *, mesh, lo, hi, test_x,
                                 gen: torch.Generator, seed: int = 0,
                                 d: int = 2,
                                 lrs: Optional[Dict[str, float]] = None,
                                 batch_size: int = 512,
                                 max_epoch: int = 3000, patience: int = 500,
                                 check_iter: int = 100, verbose: int = 1):
    """The multi-device ``clone_velocity_field``: the split on the global
    mixture (the same ``RandomState(seed)`` draws on every rank), then the
    re-fit with every epoch sharded over ``mesh``. Returns (new global
    mixture, the last test metrics, empty when nothing was split)."""
    rng = np.random.RandomState(seed)
    dev = mesh.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    if d == 2:
        new_mix, stop_np, n_split = clone.split_gaussians_2d(old_mix, spec,
                                                             rng)
        lrs = lrs or dict(clone.DEFAULT_LRS_CLONE_2D)
    else:
        new_mix, stop_np, n_split = clone.split_gaussians_3d(old_mix, spec,
                                                             rng)
        lrs = lrs or dict(clone.DEFAULT_LRS_CLONE_3D)
    if n_split == 0:
        return new_mix, {}
    sharding.check_divisible(new_mix.capacity, mesh)
    stop = broadcast(clone._unfreeze_neighbors(new_mix, spec, stop_np), mesh)
    if verbose:
        print(f"[clone/sharded] Add {n_split} particles.")

    run_chunk, place = make_sharded_clone_chunk(spec, mesh, batch_size,
                                                tuple(lo), tuple(hi))
    runner = clone._clone_runner(spec, batch_size, tuple(lo), tuple(hi))
    old_padded = clone._repad_like(old_mix, new_mix.capacity, spec)
    params = new_mix.params()
    carry = place(params, optim.init(params, lrs, patience=50),
                  new_mix.alive, stop, old_padded)
    test_ref = runner.test_ref_fn(old_padded, test_x) \
        if mesh.rank == 0 else None
    names = ("loss", "loss_grad", "loss_aniso", "loss_vol")
    last = {}

    def metrics(c):
        return _agreed_metrics(mesh, c, lambda p: runner.test_fn(
            p, new_mix.alive, stop, test_x, test_ref), len(names))

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in zip(names, mh))

    if verbose:   # every rank: the metrics are a collective
        print(f"[clone/sharded] {line(metrics(carry))}")
    pat_v, pat_g = (Patience(t) for t in clone.PATIENCE_REL_CLONE)
    st = time.time()

    def dispatch(c, n):
        c = run_chunk(c, gen, n)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(names, mh))
        if verbose:
            print(f"[clone/sharded] {line(mh)}, time: {time.time() - st}")
            st = time.time()
        pat_v.update(mh[0], n)
        pat_g.update(mh[1], n)
        return pat_v.iters >= patience and pat_g.iters >= patience

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "clone/sharded")
    return _global_mix(new_mix, carry, mesh), last


def broadcast_mixture(mix: GaussianMixture, mesh) -> GaussianMixture:
    """Rank 0's mixture on every rank. The frame loop's steps outside the
    sharded phases (the advect) run on every rank; this pins their result
    to rank 0's bits, its capacity first."""
    cap = int(broadcast(torch.tensor([mix.capacity], device=mesh.device),
                        mesh))
    out = {}
    for k in PARAM_KEYS + ("alive",):
        v = getattr(mix, k).detach()
        buf = v.clone() if v.shape[0] == cap else \
            v.new_zeros((cap,) + tuple(v.shape[1:]))
        out[k] = broadcast(buf.contiguous(), mesh)
    return mixture_of(out, out["alive"])
