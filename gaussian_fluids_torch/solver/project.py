"""Projection: the per-frame PDE solve (2D and 3D).

Drives the advected field toward the transported vorticity target with
zero divergence, boundary constraints and shape regularizers, as a
first-order Adam optimization — the JAX package's ``solver/project.py``.
Each epoch: sample batch -> RK4 covector target -> one forward and one
dual-cotangent backward kernel for the vorticity and divergence heads ->
PCGrad conflict projection -> regularizer and boundary gradients ->
4-group Adam. The host reads test metrics only every ``check_iter``
epochs, for the patience-based early stop. In 3D the covector target also
carries the helicity, which joins the vorticity head, and the boundary
term is free-slip on the domain box.

Each chunk of epochs takes its covector targets in one of the JAX
package's three modes (``loop.run_chunk``): exact, in every epoch; exact and
hoisted, the default on the card (the chunk's sample batches drawn
first, in the same generator order, sorted, and their targets computed in
a few large sweeps of ``sweep_group`` batches before the epochs run); or
interpolated from a grid of exact targets computed once a projection
(``target_grid_res``, opt-in).
"""

from __future__ import annotations

import math
import time
from typing import Dict, NamedTuple, Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field, interp
from gaussian_fluids_torch.ops import spatial
from gaussian_fluids_torch.scenes import get_scene_2d, get_scene_3d
from gaussian_fluids_torch.solver import covector, losses, optim
from gaussian_fluids_torch.solver.fit import grads_of, uniform_batch
from gaussian_fluids_torch.solver.loop import (Patience, Runner,
                                               hoist_default, run_chunked,
                                               sorted_batches, swept)
from gaussian_fluids_torch.utils.grids import default_chunk, grid_nodes

TEST_CHUNK = 4096


class ProjectWeights(NamedTuple):
    """Loss weights; 2D advance uses (1, 1, 10, 10, .5); 3D adds hel=1,
    val_reg=0 with delta_pos=0."""
    vor: float = 1.0
    div: float = 1.0
    aniso: float = 10.0
    vol: float = 10.0
    delta_pos: float = 0.5
    hel: float = 1.0
    val_reg: float = 0.0


PATIENCE_REL_2D = (1e-3, 1e-2)            # (vor, div)
PATIENCE_REL_3D = (1e-3, 1e-3, 1e-3)      # (vor, hel, div)
DEFAULT_LRS_2D = {"positions": 1e-4, "scalings": 1e-4, "rotations": 1e-4,
                  "values": 1e-4}
DEFAULT_LRS_3D = {"positions": 3e-4, "scalings": 1e-5, "rotations": 3e-4,
                  "values": 1e-5}


def _scaled_box(adv, sf):
    lo = torch.stack([adv[0], adv[2]]) * sf
    hi = torch.stack([adv[1], adv[3]]) * sf
    return lo, hi


def _sorted_by_x(pts, *rest):
    o = torch.argsort(pts[:, 0], stable=True)
    return (pts[o],) + tuple(r[o] for r in rest)


def _chunked(fn, x):
    """``fn`` over ``x`` in ``default_chunk`` chunks, outputs concatenated
    (a tensor or a tuple of tensors)."""
    c = default_chunk(x)
    parts = [fn(x[i:i + c]) for i in range(0, x.shape[0], c)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _runner_2d(spec: FieldSpec, scene_name: str, w: ProjectWeights,
               boundary_lambda: float, batch_size: int,
               target_grid: Optional[tuple] = None):
    """The ``loop.Runner`` of one projection config.

    ``epoch(carry, xs, presorted=False)`` takes the epoch's inputs as one
    tuple xs = (data, ref_vor | None, bnd1 | None, bnd2 | None): the
    sample batch, its covector target (computed here when None) and the
    boundary batches of the scene's samplers; ``presorted`` says data and
    target come sorted, as the hoist hands them in. ``sample(gen, adv)``
    draws them; the tests feed the JAX package's draws instead. carry =
    (params, opt_state, alive, positions_org, old_mix, adv, dt).
    ``chunk_inputs(carry, gen, n, hoist, tgt)`` draws a chunk's inputs
    in one of the three target modes (``loop.run_chunk``), ``tgt`` the
    grid ``target_grid_fn(old_mix, adv, dt)`` computes once a
    projection."""
    scene = get_scene_2d(scene_name)
    bs1, bs2 = scene.boundary_sampler_1, scene.boundary_sampler_2
    sf = scene.scaling_factor

    def sample(gen, adv):
        lo, hi = _scaled_box(adv, sf)
        data = uniform_batch(gen, batch_size, lo, hi)
        use = boundary_lambda > 0.0
        b1 = bs1(gen, batch_size, adv) if use and bs1 is not None else None
        b2 = bs2(gen, batch_size, adv) if use and bs2 is not None else None
        return data, None, b1, b2

    def boundary_terms(m, b1, b2, sorting):
        """(c1 + c2) Dirichlet and flux boundary losses (0 if none)."""
        bc = torch.zeros((), device=m.device)
        if b1 is not None:
            bd, bval = _sorted_by_x(*b1) if sorting else b1
            bc = bc + losses.boundary_dirichlet_loss(
                field.value(m, spec, bd, presorted=True, need_dx=False),
                bval)
        if b2 is not None:
            bd, bn, bnr = _sorted_by_x(*b2) if sorting else b2
            bc = bc + losses.boundary_flux_loss(
                field.value(m, spec, bd, presorted=True, need_dx=False), bn,
                bnr)
        return bc

    def epoch(carry, xs, presorted=False):
        params, opt_state, alive, positions_org, old_mix, adv, dt = carry
        data, ref_vor, b1, b2 = xs
        lo, hi = _scaled_box(adv, sf)
        # sort once per epoch (losses are batch means); on the dense path
        # the order is irrelevant and the sort pure overhead
        sorting = field._use_kernel(data)
        if sorting and not presorted:
            data, *r = _sorted_by_x(data, *(() if ref_vor is None
                                             else (ref_vor,)))
            ref_vor = r[0] if r else None
        if ref_vor is None:
            ref_vor = covector.advected_vorticity_2d(
                old_mix, spec, data, dt, lo, hi, presorted=True)

        def head_vor(val, jac):
            return w.vor * losses.vorticity_loss_2d(jac, ref_vor)

        def head_div(val, jac):
            return w.div * losses.divergence_loss(jac)

        # both heads are jac-only: the kernel skips the value cotangents
        (l_vor, l_div), (g_vor, g_div) = field.two_head_grads(
            params, alive, spec, data, head_vor, head_div)

        def rest(p):
            total = (w.aniso * losses.aniso_loss(p["scalings"], alive)
                     + w.vol * losses.volume_loss(p["scalings"], alive)
                     + w.delta_pos * losses.delta_pos_loss(
                         p["positions"], positions_org, alive))
            bc = boundary_terms(mixture_of(p, alive), b1, b2, sorting)
            return total + boundary_lambda * bc, bc

        l_rest, bc, g_rest = grads_of(rest, params)
        g_data = losses.pcgrad_combine(g_vor, g_div)
        grads = {k: g_rest[k] + g_data[k] for k in params}
        loss_tot = l_vor + l_div + l_rest
        params, opt_state = optim.step(opt_state, params, grads, loss_tot)
        carry = (params, opt_state, alive, positions_org, old_mix, adv, dt)
        return carry, torch.stack([l_vor, l_div, bc])

    def chunk_inputs(carry, gen, n, hoist=False, tgt=None):
        old_mix, adv, dt = carry[4:7]
        lo, hi = _scaled_box(adv, sf)
        draws = [sample(gen, adv) for _ in range(n)]
        if tgt is not None:
            return [(d, interp.bilinear_interp(
                tgt, d, (lo[0], hi[0], lo[1], hi[1])), b1, b2)
                for d, _, b1, b2 in draws]
        if not hoist:
            return draws
        data = sorted_batches(torch.stack([x[0] for x in draws]))
        with torch.no_grad():
            vor = swept(lambda c: covector.advected_vorticity_2d(
                old_mix, spec, c, dt, lo, hi, presorted=True), data)
        return [(data[i], vor[i], b1, b2)
                for i, (_, _, b1, b2) in enumerate(draws)]

    @torch.no_grad()
    def target_grid_fn(old_mix, adv, dt):
        """Exact covector targets on an (nx, ny) grid over the scaled
        advance box, x-major (coordinate 0 ascends: presorted)."""
        lo, hi = _scaled_box(adv, sf)
        u = [torch.linspace(0.0, 1.0, r, dtype=torch.float32,
                            device=adv.device) for r in target_grid]
        pts = lo + torch.stack(torch.meshgrid(*u, indexing="ij"),
                               -1).reshape(-1, 2) * (hi - lo)
        return _chunked(lambda c: covector.advected_vorticity_2d(
            old_mix, spec, c, dt, lo, hi, presorted=True),
            pts).reshape(target_grid)

    @torch.no_grad()
    def test_ref_fn(old_mix, test_x, adv, dt):
        """Backtraced target vorticity on the test grid, constant over the
        whole projection."""
        lo, hi = _scaled_box(adv, sf)
        return torch.cat([
            covector.advected_vorticity_2d(old_mix, spec,
                                           test_x[i:i + TEST_CHUNK], dt, lo,
                                           hi, presorted=True)
            for i in range(0, test_x.shape[0], TEST_CHUNK)])

    @torch.no_grad()
    def test_fn(params, alive, positions_org, adv, test_x, ref_vor, gen):
        mix = mixture_of(params, alive)
        _, jac = field.value_and_jac_chunked(mix, spec, test_x, TEST_CHUNK,
                                             presorted=True)
        lv = (losses.curl2d(jac) - ref_vor).abs()
        ld = losses.divergence(jac) ** 2
        b = test_x.shape[0]
        la = losses.aniso_loss(params["scalings"], alive)
        lvl = losses.volume_loss(params["scalings"], alive)
        ldp = losses.delta_pos_loss(params["positions"], positions_org,
                                    alive)
        _, _, b1, b2 = sample(gen, adv)
        bc = boundary_terms(mix, b1, b2, field._use_kernel(test_x))
        return torch.stack([lv.sum() / b, ld.sum() / b, ld.max(), la, lvl,
                            ldp, bc])

    return Runner(epoch, chunk_inputs, target_grid_fn, test_ref_fn, test_fn,
                  sample)


METRIC_NAMES = ("loss_vor", "loss_div", "loss_div_max", "loss_aniso",
                "loss_vol", "loss_delta_pos", "boundary_constraint")


def project_2d(mix: GaussianMixture, spec: FieldSpec,
               old_mix: GaussianMixture, dt: float, *, scene, adv_domain,
               test_x, gen: torch.Generator,
               weights: ProjectWeights = ProjectWeights(),
               boundary_lambda: float = 1.0,
               lrs: Optional[Dict[str, float]] = None,
               batch_size: int = 512, max_epoch: int = 3000,
               patience: int = 500, check_iter: int = 100,
               verbose: int = 1, target_grid_res: int = 0):
    """2D projection. Returns (new mixture, the last test metrics keyed by
    ``METRIC_NAMES``).

    ``target_grid_res`` > 0 takes the covector targets from a res^2 grid
    over the advance box, computed once and bilinearly interpolated each
    epoch (opt-in; the test metrics stay exact). Otherwise the targets are
    exact, hoisted out of the epochs where the JAX package's gate
    (``loop.hoist_default``) holds."""
    if lrs is None:
        lrs = dict(DEFAULT_LRS_2D)
    tg = (int(target_grid_res),) * 2 if target_grid_res else None
    runner = _runner_2d(spec, scene.name, weights, float(boundary_lambda),
                        batch_size, tg)
    dev = mix.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    params = mix.params()
    adv = torch.tensor(adv_domain, dtype=torch.float32, device=dev)
    carry = (params, optim.init(params, lrs, patience=50), mix.alive,
             mix.positions.detach(), old_mix, adv, float(dt))
    tgt = runner.target_grid_fn(old_mix, adv, float(dt)) if tg else None
    hoist = hoist_default(test_x) and tgt is None
    test_ref = runner.test_ref_fn(old_mix, test_x, adv, float(dt))
    last = {}

    def metrics(c):
        return runner.test_fn(c[0], c[2], c[3], c[5], test_x, test_ref,
                              gen).tolist()

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in zip(METRIC_NAMES, mh))

    if verbose:
        print(f"[projection] {line(metrics(carry))}")

    pat_vor, pat_div = (Patience(t) for t in PATIENCE_REL_2D)
    st = time.time()

    def dispatch(c, n):
        c = runner.run_chunk(c, gen, n, hoist, tgt)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(METRIC_NAMES, mh))
        if verbose:
            print(f"[projection] {line(mh)}, time: {time.time() - st}")
            st = time.time()
        pat_vor.update(mh[0], n)
        pat_div.update(mh[1], n)
        return pat_vor.iters >= patience and pat_div.iters >= patience

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "projection")
    return mix.with_params(carry[0]), last


# --------------------------------------------------------------------------
# 3D
# --------------------------------------------------------------------------

def _sorted_by_key(pts, *rest, lo=None, hi=None):
    """``pts`` and the rows of ``rest`` in ``spatial.sort_key`` order over
    the lattice bounds (lo, hi)."""
    o = torch.argsort(spatial.sort_key(pts, lo, hi), stable=True)
    return (pts[o],) + tuple(r[o] for r in rest)


def _runner_3d(spec: FieldSpec, scene_name: Optional[str],
               w: ProjectWeights, boundary_lambda: float, batch_size: int,
               lo: tuple, hi: tuple, target_grid: Optional[tuple] = None):
    """The ``loop.Runner`` of one 3D projection config.

    ``epoch(carry, xs, presorted=False)`` takes xs = (data, ref_vor |
    None, ref_hel | None, bnd | None): the sample batch, its covector
    targets (computed here when None) and the free-slip boundary batch
    (points, normals). ``sample(gen)`` draws them. carry = (params,
    opt_state, alive, old_mix, dt). ``chunk_inputs`` and
    ``target_grid_fn`` are the 2D runner's, the grid a (nx, ny, nz, 4)
    array [vor, hel] over the box (lo, hi)."""
    sampler = None
    if scene_name is not None:
        sampler = get_scene_3d(scene_name).boundary_sampler
    use_bnd = boundary_lambda > 0.0 and sampler is not None
    domain6 = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])

    def box(dev):
        return (torch.tensor(lo, dtype=torch.float32, device=dev),
                torch.tensor(hi, dtype=torch.float32, device=dev))

    def sample(gen):
        lo_t, hi_t = box(gen.device)
        data = uniform_batch(gen, batch_size, lo_t, hi_t)
        return data, None, None, sampler(gen, batch_size) if use_bnd \
            else None

    def boundary_term(m, bnd, sorting):
        if bnd is None:
            return torch.zeros((), device=m.device)
        bd, bn = _sorted_by_key(*bnd, lo=lo, hi=hi) if sorting else bnd
        return losses.boundary_freeslip_loss(
            field.value(m, spec, bd, presorted=True, need_dx=False), bn)

    def epoch(carry, xs, presorted=False):
        params, opt_state, alive, old_mix, dt = carry
        data, ref_vor, ref_hel, bnd = xs
        # sort once per epoch (losses are batch means); on the dense path
        # the order is irrelevant and the sort pure overhead
        sorting = field._use_kernel(data)
        if sorting and not presorted:
            data, *r = _sorted_by_key(data, *(() if ref_vor is None
                                               else (ref_vor, ref_hel)),
                                      lo=lo, hi=hi)
            if r:
                ref_vor, ref_hel = r
        if ref_vor is None:
            ref_vor, ref_hel = covector.advected_vorticity_3d(
                old_mix, spec, data, dt, presorted=True)

        # helicity accumulates into the vorticity PCGrad bucket
        def head_vorhel(val, jac):
            return (w.vor * losses.vorticity_loss_3d(jac, ref_vor)
                    + w.hel * losses.helicity_loss(val, jac, ref_hel))

        def head_div(val, jac):
            return w.div * losses.divergence_loss(jac)

        (l_vorhel, l_div), (g_vor, g_div) = field.two_head_grads(
            params, alive, spec, data, head_vorhel, head_div)

        def rest(p):
            total = (w.aniso * losses.aniso_loss(p["scalings"], alive)
                     + w.vol * losses.volume_loss(p["scalings"], alive)
                     + w.val_reg * losses.value_reg_loss(p["values"], alive))
            bc = boundary_term(mixture_of(p, alive), bnd, sorting)
            return total + boundary_lambda * bc, bc

        l_rest, bc, g_rest = grads_of(rest, params)
        g_data = losses.pcgrad_combine(g_vor, g_div)
        grads = {k: g_rest[k] + g_data[k] for k in params}
        loss_tot = l_vorhel + l_div + l_rest
        params, opt_state = optim.step(opt_state, params, grads, loss_tot)
        carry = (params, opt_state, alive, old_mix, dt)
        return carry, torch.stack([l_vorhel, l_div, bc])

    def chunk_inputs(carry, gen, n, hoist=False, tgt=None):
        old_mix, dt = carry[3], carry[4]
        draws = [sample(gen) for _ in range(n)]
        if tgt is not None:
            refs = [interp.multi_channel_interp(tgt, x[0], domain6)
                    for x in draws]
            return [(x[0], r[:, :3], r[:, 3], x[3])
                    for x, r in zip(draws, refs)]
        if not hoist:
            return draws
        data = sorted_batches(torch.stack([x[0] for x in draws]), lo, hi)
        with torch.no_grad():
            vor, hel = swept(lambda c: covector.advected_vorticity_3d(
                old_mix, spec, c, dt, presorted=True), data)
        return [(data[i], vor[i], hel[i], x[3])
                for i, x in enumerate(draws)]

    @torch.no_grad()
    def target_grid_fn(old_mix, dt):
        """Exact covector targets on the (nx, ny, nz) grid over the box,
        as one (nx, ny, nz, 4) array [vor_x, vor_y, vor_z, hel]; the nodes
        x-major (presorted)."""
        pts = grid_nodes(domain6, target_grid, old_mix.device)
        vor, hel = _chunked(lambda c: covector.advected_vorticity_3d(
            old_mix, spec, c, dt, presorted=True), pts)
        return torch.cat([vor, hel[:, None]], -1) \
            .reshape(tuple(target_grid) + (4,))

    @torch.no_grad()
    def test_ref_fn(old_mix, test_x, dt):
        """Backtraced (vorticity, helicity) targets on the test grid,
        constant over the whole projection."""
        return _chunked(lambda c: covector.advected_vorticity_3d(
            old_mix, spec, c, dt, presorted=True), test_x)

    @torch.no_grad()
    def test_fn(params, alive, test_x, test_ref, gen):
        mix = mixture_of(params, alive)
        ref_vor, ref_hel = test_ref
        val, jac = field.value_and_jac_chunked(mix, spec, test_x,
                                               presorted=True)
        vor = losses.curl3d(jac)
        b = test_x.shape[0]
        lv = (vor - ref_vor).abs().mean(-1)
        lh = ((val * vor).sum(-1) - ref_hel).abs()
        ld = losses.divergence(jac) ** 2
        la = losses.aniso_loss(params["scalings"], alive)
        lvl = losses.volume_loss(params["scalings"], alive)
        lvr = losses.value_reg_loss(params["values"], alive)
        # a fresh boundary batch per test, printed unweighted
        bnd = sampler(gen, batch_size) if use_bnd else None
        bc = boundary_term(mix, bnd, field._use_kernel(test_x))
        return torch.stack([lv.sum() / b, lh.sum() / b, ld.sum() / b,
                            ld.max(), la, lvl, lvr, bc])

    return Runner(epoch, chunk_inputs, target_grid_fn, test_ref_fn, test_fn,
                  sample)


METRIC_NAMES_3D = ("loss_vor", "loss_hel", "loss_div", "loss_div_max",
                   "loss_aniso", "loss_vol", "loss_val_reg",
                   "boundary_constraint")


def project_3d(mix: GaussianMixture, spec: FieldSpec,
               old_mix: GaussianMixture, dt: float, *, domain, test_x,
               gen: torch.Generator, scene_name: Optional[str] = None,
               weights: ProjectWeights = ProjectWeights(delta_pos=0.0),
               boundary_lambda: float = 10.0,
               lrs: Optional[Dict[str, float]] = None,
               batch_size: int = 8192, max_epoch: int = 3000,
               patience: int = 500, check_iter: int = 100,
               verbose: int = 1, target_grid_res: int = 0,
               collect_curves: bool = False):
    """3D projection. Returns (new mixture, the last test metrics keyed by
    ``METRIC_NAMES_3D``, curves). ``target_grid_res`` and the hoist as in
    :func:`project_2d`, the grid res^3 and trilinear. The curves are None,
    or with ``collect_curves`` those of the reference's loss_{frame}.png
    as the JAX package collects them: per epoch ``train_vor``,
    ``train_div`` and ``log_lr``
    (the natural log of the scalings group's lr at the chunk's end), per
    chunk ``test_vor`` and ``test_div``."""
    if lrs is None:
        lrs = dict(DEFAULT_LRS_3D)
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    tg = (int(target_grid_res),) * 3 if target_grid_res else None
    runner = _runner_3d(spec, scene_name, weights, float(boundary_lambda),
                        batch_size, (x_min, y_min, z_min),
                        (x_max, y_max, z_max), tg)
    dev = mix.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]   # presorted test chunks
    params = mix.params()
    carry = (params, optim.init(params, lrs, patience=50), mix.alive,
             old_mix, float(dt))
    tgt = runner.target_grid_fn(old_mix, float(dt)) if tg else None
    hoist = hoist_default(test_x) and tgt is None
    test_ref = runner.test_ref_fn(old_mix, test_x, float(dt))
    last = {}

    def metrics(c):
        return runner.test_fn(c[0], c[2], test_x, test_ref, gen).tolist()

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in zip(METRIC_NAMES_3D, mh))

    if verbose:
        print(f"[projection] {line(metrics(carry))}")

    pats = [Patience(t) for t in PATIENCE_REL_3D]
    curves = {"train_vor": [], "train_div": [], "log_lr": [],
              "test_vor": [], "test_div": []}
    st = time.time()

    def dispatch(c, n):
        auxes = [] if collect_curves else None
        c = runner.run_chunk(c, gen, n, hoist, tgt, auxes)
        if collect_curves:
            aux = torch.stack(auxes).cpu().numpy()
            curves["train_vor"].extend(aux[:, 0].tolist())
            curves["train_div"].extend(aux[:, 1].tolist())
            lr = float(c[1].groups["scalings"].lr)
            curves["log_lr"].extend([math.log(lr)] * n)
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(METRIC_NAMES_3D, mh))
        if collect_curves:
            curves["test_vor"].append(float(mh[0]))
            curves["test_div"].append(float(mh[2]))
        if verbose:
            print(f"[projection] {line(mh)}, time: {time.time() - st}")
            st = time.time()
        for pat, v in zip(pats, (mh[0], mh[1], mh[2])):
            pat.update(v, n)
        return all(pat.iters >= patience for pat in pats)

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "projection")
    return mix.with_params(carry[0]), last, (curves if collect_curves
                                             else None)
