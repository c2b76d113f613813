"""Projection: the per-frame PDE solve (2D).

Drives the advected field toward the transported vorticity target with
zero divergence, boundary constraints and shape regularizers, as a
first-order Adam optimization — the JAX package's ``solver/project.py``.
Each epoch: sample batch -> RK4 covector target -> one forward and one
dual-cotangent backward kernel for the vorticity and divergence heads ->
PCGrad conflict projection -> regularizer and boundary gradients ->
4-group Adam. The host reads test metrics only every ``check_iter``
epochs, for the patience-based early stop.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.solver import covector, losses, optim
from gaussian_fluids_torch.solver.fit import grads_of, uniform_batch
from gaussian_fluids_torch.solver.loop import Patience, run_chunked

TEST_CHUNK = 4096


class ProjectWeights(NamedTuple):
    """Loss weights; 2D advance uses (1, 1, 10, 10, .5)."""
    vor: float = 1.0
    div: float = 1.0
    aniso: float = 10.0
    vol: float = 10.0
    delta_pos: float = 0.5


PATIENCE_REL_2D = (1e-3, 1e-2)            # (vor, div)
DEFAULT_LRS_2D = {"positions": 1e-4, "scalings": 1e-4, "rotations": 1e-4,
                  "values": 1e-4}


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
                field.value(m, spec, bd, presorted=True), bval)
        if b2 is not None:
            bd, bn, bnr = _sorted_by_x(*b2) if sorting else b2
            bc = bc + losses.boundary_flux_loss(
                field.value(m, spec, bd, presorted=True), bn, bnr)
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
