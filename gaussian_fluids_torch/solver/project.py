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
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.ops import spatial
from gaussian_fluids_torch.scenes import get_scene_2d, get_scene_3d
from gaussian_fluids_torch.solver import covector, losses, optim
from gaussian_fluids_torch.solver.fit import grads_of, uniform_batch
from gaussian_fluids_torch.solver.loop import Patience, run_chunked
from gaussian_fluids_torch.utils.grids import default_chunk

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
    o = torch.argsort(pts[:, 0])
    return (pts[o],) + tuple(r[o] for r in rest)


def _runner_2d(spec: FieldSpec, scene_name: str, w: ProjectWeights,
               boundary_lambda: float, batch_size: int):
    """(epoch, sample, test_ref_fn, test_fn) for one projection config.

    ``epoch(carry, xs)`` takes the epoch's inputs as one tuple
    xs = (data, ref_vor | None, bnd1 | None, bnd2 | None): the sample
    batch, its covector target (computed here when None) and the boundary
    batches of the scene's samplers. ``sample(gen, adv)`` draws them; the
    tests feed the JAX package's draws instead. carry = (params,
    opt_state, alive, positions_org, old_mix, adv, dt)."""
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

    def epoch(carry, xs):
        params, opt_state, alive, positions_org, old_mix, adv, dt = carry
        data, ref_vor, b1, b2 = xs
        lo, hi = _scaled_box(adv, sf)
        # sort once per epoch (losses are batch means); on the dense path
        # the order is irrelevant and the sort pure overhead
        sorting = field._use_kernel(data)
        if sorting:
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

    return epoch, sample, test_ref_fn, test_fn


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
               verbose: int = 1):
    """2D projection. Returns (new mixture, the last test metrics keyed by
    ``METRIC_NAMES``)."""
    if lrs is None:
        lrs = dict(DEFAULT_LRS_2D)
    epoch, sample, test_ref_fn, test_fn = _runner_2d(
        spec, scene.name, weights, float(boundary_lambda), batch_size)
    dev = mix.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]
    params = mix.params()
    adv = torch.tensor(adv_domain, dtype=torch.float32, device=dev)
    carry = (params, optim.init(params, lrs, patience=50), mix.alive,
             mix.positions.detach(), old_mix, adv, float(dt))
    test_ref = test_ref_fn(old_mix, test_x, adv, float(dt))
    last = {}

    def metrics(c):
        return test_fn(c[0], c[2], c[3], c[5], test_x, test_ref,
                       gen).tolist()

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in zip(METRIC_NAMES, mh))

    if verbose:
        print(f"[projection] {line(metrics(carry))}")

    pat_vor, pat_div = (Patience(t) for t in PATIENCE_REL_2D)
    st = time.time()

    def dispatch(c, n):
        for _ in range(n):
            c, _ = epoch(c, sample(gen, adv))
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

def _sorted_by_key(pts, *rest):
    o = torch.argsort(spatial.sort_key(pts))
    return (pts[o],) + tuple(r[o] for r in rest)


def _runner_3d(spec: FieldSpec, scene_name: Optional[str],
               w: ProjectWeights, boundary_lambda: float, batch_size: int,
               lo: tuple, hi: tuple):
    """(epoch, sample, test_ref_fn, test_fn) for one 3D projection config.

    ``epoch(carry, xs)`` takes xs = (data, ref_vor | None, ref_hel | None,
    bnd | None): the sample batch, its covector targets (computed here
    when None) and the free-slip boundary batch (points, normals).
    ``sample(gen)`` draws them. carry = (params, opt_state, alive,
    old_mix, dt)."""
    sampler = None
    if scene_name is not None:
        sampler = get_scene_3d(scene_name).boundary_sampler
    use_bnd = boundary_lambda > 0.0 and sampler is not None

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
        bd, bn = _sorted_by_key(*bnd) if sorting else bnd
        return losses.boundary_freeslip_loss(
            field.value(m, spec, bd, presorted=True, need_dx=False), bn)

    def epoch(carry, xs):
        params, opt_state, alive, old_mix, dt = carry
        data, ref_vor, ref_hel, bnd = xs
        # sort once per epoch (losses are batch means); on the dense path
        # the order is irrelevant and the sort pure overhead
        sorting = field._use_kernel(data)
        if sorting:
            data, *r = _sorted_by_key(data, *(() if ref_vor is None
                                               else (ref_vor, ref_hel)))
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

    @torch.no_grad()
    def test_ref_fn(old_mix, test_x, dt):
        """Backtraced (vorticity, helicity) targets on the test grid,
        constant over the whole projection."""
        c = default_chunk(test_x)
        parts = [covector.advected_vorticity_3d(old_mix, spec,
                                                test_x[i:i + c], dt,
                                                presorted=True)
                 for i in range(0, test_x.shape[0], c)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

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

    return epoch, sample, test_ref_fn, test_fn


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
               verbose: int = 1):
    """3D projection. Returns (new mixture, the last test metrics keyed by
    ``METRIC_NAMES_3D``)."""
    if lrs is None:
        lrs = dict(DEFAULT_LRS_3D)
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    epoch, sample, test_ref_fn, test_fn = _runner_3d(
        spec, scene_name, weights, float(boundary_lambda), batch_size,
        (x_min, y_min, z_min), (x_max, y_max, z_max))
    dev = mix.device
    test_x = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    test_x = test_x[torch.argsort(test_x[:, 0])]   # presorted test chunks
    params = mix.params()
    carry = (params, optim.init(params, lrs, patience=50), mix.alive,
             old_mix, float(dt))
    test_ref = test_ref_fn(old_mix, test_x, float(dt))
    last = {}

    def metrics(c):
        return test_fn(c[0], c[2], test_x, test_ref, gen).tolist()

    def line(mh):
        return ", ".join(f"{k}: {v}" for k, v in zip(METRIC_NAMES_3D, mh))

    if verbose:
        print(f"[projection] {line(metrics(carry))}")

    pats = [Patience(t) for t in PATIENCE_REL_3D]
    st = time.time()

    def dispatch(c, n):
        for _ in range(n):
            c, _ = epoch(c, sample(gen))
        return c, metrics(c)

    def on_chunk(mh, n):
        nonlocal st
        last.update(zip(METRIC_NAMES_3D, mh))
        if verbose:
            print(f"[projection] {line(mh)}, time: {time.time() - st}")
            st = time.time()
        for pat, v in zip(pats, (mh[0], mh[1], mh[2])):
            pat.update(v, n)
        return all(pat.iters >= patience for pat in pats)

    carry, _ = run_chunked(carry, dispatch, max_epoch, check_iter, on_chunk,
                           "projection")
    return mix.with_params(carry[0]), last
