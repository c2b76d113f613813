"""Clone + adaptive splitting and the re-fit that follows (2D and 3D).

Per frame the solver copies the current field, splits over-stretched
Gaussians into two children, freezes everything except the children and
their neighbours, and re-fits to the old field — the JAX package's
``solver/clone.py``. Splitting is host-side numpy (it changes N once per
frame); the re-fit runs epochs on the device with a host check every
``check_iter`` epochs.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field, interp, spatial
from gaussian_fluids_torch.ops.rotations import precision_matrix
from gaussian_fluids_torch.solver import losses, optim
from gaussian_fluids_torch.solver.fit import grads_of, uniform_batch
from gaussian_fluids_torch.solver.loop import (Patience, Runner,
                                               hoist_default, run_chunked,
                                               sorted_batches, swept)
from gaussian_fluids_torch.utils.grids import default_chunk

PATIENCE_REL_CLONE = (1e-3, 1e-3)          # (val, grad)
DEFAULT_LRS_CLONE_2D = {"positions": 1e-2, "scalings": 5e-2,
                        "rotations": 5e-2, "values": 5e-3}
DEFAULT_LRS_CLONE_3D = {"positions": 1e-3, "scalings": 1e-3,
                        "rotations": 1e-3, "values": 1e-3}


def _repad_like(mix: GaussianMixture, capacity: int,
                spec: FieldSpec) -> GaussianMixture:
    """Re-pad a mixture to a target capacity (>= its alive count)."""
    if mix.capacity == capacity:
        return mix
    m = mix.compact()
    return GaussianMixture.from_arrays(m.positions, m.scalings, m.rotations,
                                       m.values, spec, min_capacity=capacity,
                                       device=mix.device)


def _sample_children(rng: np.random.RandomState, mu: np.ndarray,
                     prec: np.ndarray, n_children: int = 2) -> np.ndarray:
    """Sample children from N(mu, prec^{-1}); prec is symmetrised first."""
    prec = 0.5 * (prec + np.swapaxes(prec, -1, -2))
    L = np.linalg.cholesky(prec)          # prec = L L^T
    z = rng.standard_normal((n_children,) + mu.shape).astype(np.float32)
    # x = mu + L^{-T} z  has covariance (L L^T)^{-1}
    delta = np.linalg.solve(np.swapaxes(L, -1, -2)[None], z[..., None])
    return (mu[None] + delta[..., 0]).reshape(-1, mu.shape[-1])


def split_gaussians_2d(mix: GaussianMixture, spec: FieldSpec,
                       rng: np.random.RandomState
                       ) -> Tuple[GaussianMixture, np.ndarray, int]:
    """One splitting pass at ratio >= 1.5, shrinking the long axis by
    log(1.5). Returns (new mixture, stop-gradient mask over the alive
    entries, number of parents split)."""
    p = mix.to_param_dict()
    pos, sca, rot, val = (p["positions"], p["scalings"], p["rotations"],
                          p["values"])
    ratio = np.exp(sca.max(-1) - sca.min(-1))
    need = ratio >= 1.5
    n_split = int(need.sum())
    if n_split == 0:
        return mix, np.ones((pos.shape[0],), bool), 0

    prec = precision_matrix(torch.from_numpy(sca[need]),
                            torch.from_numpy(rot[need]), 2).numpy()
    child_pos = _sample_children(rng, pos[need], prec)
    child_rot = np.tile(rot[need], 2)
    child_sca = np.tile(sca[need], (2, 1))
    axis1 = child_sca[:, 1] < child_sca[:, 0]
    child_sca[axis1, 1] += np.log(1.5)
    child_sca[~axis1, 0] += np.log(1.5)
    child_val = np.tile(val[need], (2, 1))

    new_pos = np.concatenate([pos[~need], child_pos])
    new_rot = np.concatenate([rot[~need], child_rot])
    new_sca = np.concatenate([sca[~need], child_sca])
    new_val = np.concatenate([val[~need], child_val])
    stop = np.zeros((new_pos.shape[0],), bool)
    stop[: int((~need).sum())] = True
    order = np.argsort(new_pos[:, 0], kind="stable")
    return (GaussianMixture.from_arrays(new_pos[order], new_sca[order],
                                        new_rot[order], new_val[order],
                                        spec, min_capacity=mix.capacity,
                                        device=mix.device),
            stop[order], n_split)


def split_gaussians_3d(mix: GaussianMixture, spec: FieldSpec,
                       rng: np.random.RandomState
                       ) -> Tuple[GaussianMixture, np.ndarray, int]:
    """Loop-until-none splitting at ratio >= 2: the parent's shortest-scale
    axis gets += log 2, all axes -= log(2)/3, then two children copy the
    modified shape; children's positions are clamped to the padded domain.
    The same numpy draws in the same order as the JAX package."""
    p = mix.to_param_dict()
    pos, sca, rot, val = (p["positions"], p["scalings"], p["rotations"],
                          p["values"])
    stop = np.ones((pos.shape[0],), bool)
    total_split = 0
    lo = np.asarray(spec.lo, np.float32)
    hi = np.asarray(spec.hi, np.float32)
    while True:
        ratio = np.exp(sca.max(-1) - sca.min(-1))
        need = ratio >= 2.0
        n_split = int(need.sum())
        print(f"Add {n_split} particles. {float(ratio.max())}")
        if n_split == 0:
            break
        total_split += n_split
        axis_min = sca[need].argmin(-1)
        prec = precision_matrix(torch.from_numpy(sca[need]),
                                torch.from_numpy(rot[need]), 3).numpy()
        child_pos = np.clip(_sample_children(rng, pos[need], prec), lo, hi)
        child_rot = np.tile(rot[need], (2, 1))
        mod = sca[need].copy()
        mod[np.arange(n_split), axis_min] += np.log(2.0)
        mod -= np.log(2.0) / 3.0
        child_sca = np.tile(mod, (2, 1))
        child_val = np.tile(val[need], (2, 1))
        pos = np.concatenate([pos[~need], child_pos])
        rot = np.concatenate([rot[~need], child_rot])
        sca = np.concatenate([sca[~need], child_sca])
        val = np.concatenate([val[~need], child_val])
        stop = np.concatenate([stop[~need],
                               np.zeros((2 * n_split,), bool)])
    if total_split == 0:
        return mix, stop, 0
    # the spatial sort of the block-sparse backends; stop stays aligned
    order = np.argsort(spatial.sort_key_np(pos), kind="stable")
    return (GaussianMixture.from_arrays(pos[order], sca[order], rot[order],
                                        val[order], spec,
                                        min_capacity=mix.capacity,
                                        device=mix.device),
            stop[order], total_split)


def _unfreeze_neighbors(mix: GaussianMixture, spec: FieldSpec,
                        stop: np.ndarray) -> torch.Tensor:
    """(capacity,) bool: stop &= ~neighbours(new Gaussians)."""
    n = mix.n_alive()
    stop_full = np.zeros((mix.capacity,), bool)
    stop_full[:n] = stop
    stop_t = torch.as_tensor(stop_full, device=mix.device)
    free_pos = mix.positions[:n][torch.as_tensor(~stop, device=mix.device)]
    if free_pos.shape[0] == 0:
        return stop_t
    radius = spec.max_reach(float(mix.min_scaling()))
    near = field.neighbor_mark(mix, spec, free_pos, radius)
    return stop_t & ~near


def _clone_runner(spec: FieldSpec, batch_size: int = 512, lo=None, hi=None,
                  target_grid: Optional[tuple] = None):
    """The ``loop.Runner`` of the clone re-fit over the box (lo, hi).

    ``epoch(carry, xs, presorted=False)`` runs one epoch on xs = the
    sample batch x (the seam the tests feed), against the old field's
    (val, jac) at x; or xs = (x, ref_val, ref_jac) with the targets
    given, ``presorted`` when they come sorted, as the hoist hands them
    in. carry = (params, opt_state, alive, stop, old_mix).
    ``chunk_inputs(carry, gen, n, hoist, tgt)`` draws a chunk's inputs in
    the projection's three target modes (``loop.run_chunk``);
    ``target_grid_fn(old_mix)`` gives the old field's [val, jac] channels
    (vdim + vdim * d) on the ``target_grid`` over the box."""
    d, vdim = spec.d, spec.vdim

    def bounds(dev):
        return (torch.tensor(lo, dtype=torch.float32, device=dev),
                torch.tensor(hi, dtype=torch.float32, device=dev))

    def loss_fn(params, alive, stop, x, ref_val, ref_jac):
        frozen = losses.freeze_params(params, stop)
        val, jac = field.value_and_jac(mixture_of(frozen, alive), spec, x,
                                       presorted=True, need_dx=False)
        l_val = losses.value_loss(val, ref_val)
        l_grad = losses.grad_loss(jac, ref_jac)
        l_aniso = losses.aniso_loss(params["scalings"], alive & ~stop)
        l_vol = losses.volume_loss(params["scalings"], alive,
                                   detach_mask=stop)
        total = l_val + l_grad + l_aniso + l_vol
        return total, torch.stack([l_val, l_grad, l_aniso, l_vol])

    def epoch(carry, xs, presorted=False):
        params, opt_state, alive, stop, old_mix = carry
        x, *ref = xs if isinstance(xs, tuple) else (xs,)
        if field._use_kernel(x) and not presorted:
            o = torch.argsort(spatial.sort_key(x, lo, hi), stable=True)
            x, ref = x[o], [r[o] for r in ref]
        if not ref:
            with torch.no_grad():
                # the old field's targets, as the JAX package's hoisted
                # sweep computes them (need_dx=False)
                ref = field.value_and_jac(old_mix, spec, x, presorted=True,
                                          need_dx=False)
        total, aux, grads = grads_of(loss_fn, params, alive, stop, x, *ref)
        params, opt_state = optim.step(opt_state, params, grads, total)
        return (params, opt_state, alive, stop, old_mix), aux

    def chunk_inputs(carry, gen, n, hoist=False, tgt=None):
        lo_t, hi_t = bounds(gen.device)
        xs = [uniform_batch(gen, batch_size, lo_t, hi_t) for _ in range(n)]
        if tgt is not None:
            box = tuple(v for k in range(d) for v in (lo_t[k], hi_t[k]))
            outs = [interp.multi_channel_interp(tgt, x, box) for x in xs]
            return [(x, o[:, :vdim], o[:, vdim:].reshape(-1, vdim, d))
                    for x, o in zip(xs, outs)]
        if not hoist:
            return xs
        x = sorted_batches(torch.stack(xs), lo_t, hi_t)
        with torch.no_grad():
            rv, rj = swept(lambda c: field.value_and_jac(
                carry[4], spec, c, presorted=True, need_dx=False), x)
        return [(x[i], rv[i], rj[i]) for i in range(n)]

    @torch.no_grad()
    def target_grid_fn(old_mix):
        """The old field's [val, jac] channels on the grid over the box,
        axis-0-major (coordinate 0 ascends: presorted), in chunks."""
        dev = old_mix.device
        lo_t, hi_t = bounds(dev)
        u = [torch.linspace(0.0, 1.0, r, dtype=torch.float32, device=dev)
             for r in target_grid]
        pts = lo_t + torch.stack(torch.meshgrid(*u, indexing="ij"),
                                 -1).reshape(-1, d) * (hi_t - lo_t)
        c = default_chunk(pts)
        out = []
        for i in range(0, pts.shape[0], c):
            v, j = field.value_and_jac(old_mix, spec, pts[i:i + c],
                                       presorted=True)
            out.append(torch.cat([v, j.reshape(v.shape[0], -1)], -1))
        return torch.cat(out).reshape(tuple(target_grid) + (vdim + vdim * d,))

    def test_ref_fn(old_mix, test_x):
        """Old-field (val, jac) on the test grid, constant over the fit."""
        return field.value_and_jac_chunked(old_mix, spec, test_x,
                                           presorted=True)

    @torch.no_grad()
    def test_fn(params, alive, stop, test_x, test_ref):
        mix = mixture_of(params, alive)
        v, j = field.value_and_jac_chunked(mix, spec, test_x,
                                           presorted=True)
        rv, rj = test_ref
        b = test_x.shape[0]
        lv = (v - rv).abs().mean(-1).sum() / b
        lg = (j - rj).abs().mean((-1, -2)).sum() / b
        la = losses.aniso_loss(params["scalings"], alive & ~stop)
        lvl = losses.volume_loss(params["scalings"], alive)
        return torch.stack([lv, lg, la, lvl])

    return Runner(epoch, chunk_inputs, target_grid_fn, test_ref_fn, test_fn)


def clone_velocity_field(old_mix: GaussianMixture, spec: FieldSpec, *,
                         lo, hi, test_x, gen: torch.Generator, seed: int = 0,
                         d: int = 2, lrs: Optional[Dict[str, float]] = None,
                         batch_size: int = 512, max_epoch: int = 3000,
                         patience: int = 500, check_iter: int = 100,
                         verbose: int = 1, target_grid_res: int = 0):
    """Split + freeze + re-fit to the old field. Returns (new mixture,
    the last test metrics {loss, loss_grad, loss_aniso, loss_vol} — empty
    when nothing was split). ``target_grid_res`` > 0 interpolates the
    frozen old field's [val, jac] from a res^d grid over (lo, hi),
    computed once (opt-in; the test metrics stay exact); otherwise the
    exact targets are hoisted where the JAX package's gate
    (``loop.hoist_default``) holds."""
    rng = np.random.RandomState(seed)
    dev = old_mix.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    if d == 2:
        new_mix, stop_np, n_split = split_gaussians_2d(old_mix, spec, rng)
        if lrs is None:
            lrs = dict(DEFAULT_LRS_CLONE_2D)
    else:
        new_mix, stop_np, n_split = split_gaussians_3d(old_mix, spec, rng)
        if lrs is None:
            lrs = dict(DEFAULT_LRS_CLONE_3D)
    if n_split == 0:
        return new_mix, {}
    stop = _unfreeze_neighbors(new_mix, spec, stop_np)
    if verbose:
        print(f"[clone] Add {n_split} particles.")

    tg = (int(target_grid_res),) * d if target_grid_res else None
    runner = _clone_runner(spec, batch_size, tuple(lo), tuple(hi), tg)
    old_padded = _repad_like(old_mix, new_mix.capacity, spec)
    params = new_mix.params()
    carry = (params, optim.init(params, lrs, patience=50), new_mix.alive,
             stop, old_padded)
    tgt = runner.target_grid_fn(old_padded) if tg else None
    hoist = hoist_default(test_x) and tgt is None
    test_ref = runner.test_ref_fn(old_padded, test_x)
    names = ("loss", "loss_grad", "loss_aniso", "loss_vol")
    last = {}

    def metrics(c):
        return runner.test_fn(c[0], c[2], c[3], test_x, test_ref).tolist()

    if verbose:
        lv, lg, la, lvl = metrics(carry)
        print(f"[clone] loss: {lv}, loss_grad: {lg}, loss_aniso: {la}, "
              f"loss_vol: {lvl}")

    pat_v, pat_g = (Patience(t) for t in PATIENCE_REL_CLONE)
    st = time.time()

    def dispatch(c, n):
        c = runner.run_chunk(c, gen, n, hoist, tgt)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(names, mh))
        lv, lg, la, lvl = mh
        if verbose:
            print(f"[clone] loss: {lv}, loss_grad: {lg}, loss_aniso: {la}, "
                  f"loss_vol: {lvl}, time: {time.time() - st}")
            st = time.time()
        pat_v.update(lv, n)
        pat_g.update(lg, n)
        return pat_v.iters >= patience and pat_g.iters >= patience

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "clone")
    return new_mix.with_params(carry[0]), last
