"""Karman's projection epochs in plain PyTorch.

The 2D epoch of ``reference/projection.py`` (the RK4 covector target,
the vorticity and divergence heads, PCGrad, the regularizers with the
delta_pos term, Adam) with Karman's two boundary terms in place of the
free-slip walls, each on its own batch drawn in the program's order after
the data batch:

  * Dirichlet u = 0 on the cylinder: n points at angles 2 pi u, the loss
    the mean of |u| over the points' two components;
  * the normal flux on five edges: n points along x on the lower and
    upper edges, n along y on the left and right edges of the advance
    domain and on the left edge of the visualize domain (the same
    fractions for each pair), with the targets 0, 0, +v, -v and +v
    (inflow through the left edges, outflow through the right), the loss
    the mean of |u . n - target|.

The advance domain moves with the inflow: its left edge at frame f is
the initialize domain's moved by f dt v, up to the visualize domain's.
The projection that makes frame f + 1 from the checkpoint of frame f
works on the domain of frame f + 1, for its data batch, its edges and the
target's outside mask alike. Everything here reads the configuration
file; nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import plain
from portbench.reference import projection as base


def advance_domain(cfg: dict, frame: int) -> tuple:
    """The unscaled advance domain (x0, x1, y0, y1) at ``frame``."""
    x0, x1, y0, y1 = (float(v) for v in cfg["initialize_domain"])
    x0 = min(x0 + frame * float(cfg["dt"]) * float(cfg["inflow"]),
             float(cfg["visualize_domain"][0]))
    return (x0, x1, y0, y1)


def setting(cfg: dict, frame: int) -> base.Setting:
    """The projection's setting for the one that makes frame ``frame``
    + 1, on that frame's advance domain."""
    return base.Setting({**cfg, "domain": advance_domain(cfg, frame + 1)})


def cylinder(u, cfg: dict, sf: float):
    """(points, target velocity 0) at angle fractions ``u``, scaled."""
    cx, cy = (float(v) for v in cfg["cylinder"]["center"])
    r = float(cfg["cylinder"]["radius"])
    theta = u * 2.0 * math.pi
    pts = torch.stack([r * torch.cos(theta) + cx, r * torch.sin(theta) + cy],
                      -1)
    return pts * sf, torch.zeros_like(pts)


def edges(u1, u2, adv, cfg: dict, sf: float):
    """(points, inward normals, flux targets) on the five edges, 5n
    points at fractions ``u1`` along x and ``u2`` along y; ``adv`` the
    unscaled advance domain as a (4,) tensor."""
    x0, x1, y0, y1 = adv[0], adv[1], adv[2], adv[3]
    v = float(cfg["inflow"])
    xv = float(cfg["visualize_domain"][0])
    t = u1 * (x1 - x0) + x0
    s = u2 * (y1 - y0) + y0
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    pts = torch.cat([torch.stack([t, y0 * one], -1),
                     torch.stack([t, y1 * one], -1),
                     torch.stack([x0 * one, s], -1),
                     torch.stack([x1 * one, s], -1),
                     torch.stack([xv * one, s], -1)])
    normals = torch.cat([torch.stack([zero, one], -1),
                         torch.stack([zero, -one], -1),
                         torch.stack([one, zero], -1),
                         torch.stack([-one, zero], -1),
                         torch.stack([one, zero], -1)])
    flux = torch.cat([zero, zero, v * one, -v * one, v * one])
    return pts * sf, normals, flux * sf


def draw_epoch(s: base.Setting, cfg: dict, gen):
    """One epoch's (batch, cylinder batch, edge batch), drawn in the
    program's order: the batch, the cylinder's fractions, the edges' x
    fractions, their y fractions."""
    dev = gen.device
    adv = torch.tensor(s.domain, dtype=torch.float32, device=dev)
    lo = torch.stack([adv[0], adv[2]]) * s.sf
    hi = torch.stack([adv[1], adv[3]]) * s.sf
    x = base.box_batch(gen, s.batch, lo, hi)
    n = s.batch
    cyl = cylinder(torch.rand((n,), generator=gen, device=dev), cfg, s.sf)
    u1 = torch.rand((n,), generator=gen, device=dev)
    u2 = torch.rand((n,), generator=gen, device=dev)
    return x, cyl, edges(u1, u2, adv, cfg, s.sf)


def epoch(s: base.Setting, params, opt, old, spec, positions_org, draws,
          pair_dtype=torch.float32, half_batch=False):
    """One projection epoch. Returns (params, opt, loss, grads)."""
    x, (cx, cval), (ex, en, eflux) = draws
    with torch.no_grad():
        vor, _ = base._targets(s, old, spec, x, pair_dtype)
    if half_batch:
        x, vor = x[:x.shape[0] // 2], vor[:x.shape[0] // 2]
        cx, cval = cx[:cx.shape[0] // 2], cval[:cx.shape[0] // 2]
        ex, en, eflux = (a[:ex.shape[0] // 2] for a in (ex, en, eflux))
    b, w = x.shape[0], s.w

    def head_vor(val, jac, sl):
        return w["vor"] * (base.curl2d(jac) - vor[sl]).abs().sum() / b

    def head_div(val, jac, sl):
        return w["div"] * (base.divergence(jac) ** 2).sum() / b

    (l_vor, l_div), (g_vor, g_div) = plain.head_grads(
        params, spec, x, [head_vor, head_div], True, pair_dtype)

    nc, ne = cx.shape[0], ex.shape[0]

    def head_dirichlet(val, jac, sl):
        return (val - cval[sl]).abs().sum() / (nc * val.shape[1])

    def head_flux(val, jac, sl):
        return ((val * en[sl]).sum(-1) - eflux[sl]).abs().sum() / ne

    (bc_d,), (g_d,) = plain.head_grads(params, spec, cx, [head_dirichlet],
                                       False, pair_dtype)
    (bc_f,), (g_f,) = plain.head_grads(params, spec, ex, [head_flux], False,
                                       pair_dtype)

    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        reg = (w["aniso"] * base.aniso(leaves["scalings"])
               + w["vol"] * base.volume(leaves["scalings"])
               + w["delta_pos"] * ((leaves["positions"] - positions_org) ** 2
                                   ).mean(-1).mean())
        g_reg = dict(zip(leaves, torch.autograd.grad(
            reg, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
    lam = s.boundary_lambda
    g_data = base.pcgrad(g_vor, g_div)
    grads = {k: g_reg[k] + lam * (g_d[k] + g_f[k]) + g_data[k]
             for k in params}
    loss = l_vor + l_div + reg.detach() + lam * (bc_d + bc_f)
    params, opt = base.adam(params, opt, grads, s.lrs)
    return params, opt, float(loss), grads


def first_steps(cfg: dict, frame: int, frame_path: str, gen_seed: int,
                device, steps: int = 3, pair_dtype=torch.float32,
                half_batch: bool = False) -> Dict[str, object]:
    """The reference's first ``steps`` epochs of the projection that makes
    frame ``frame`` + 1 from the checkpoint ``frame_path`` of frame
    ``frame``, the batches drawn from a generator seeded with
    ``gen_seed`` on ``device``; as ``projection.first_steps`` returns."""
    s = setting(cfg, frame)
    old, spec = plain.load_checkpoint(frame_path, device)
    start = base.advected_start(old, spec, s.dt, pair_dtype)
    params = dict(start._asdict())
    opt = {"t": 0, "m": {k: torch.zeros_like(p) for k, p in params.items()},
           "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    draws = [draw_epoch(s, cfg, gen) for _ in range(steps)]
    losses: List[float] = []
    first = None
    p = params
    for dr in draws:
        p, opt, loss, grads = epoch(s, p, opt, old, spec,
                                    params["positions"], dr, pair_dtype,
                                    half_batch)
        losses.append(loss)
        if first is None:
            first = grads
    delta = {k: p[k] - params[k] for k in params}
    return {"losses": losses, "grads": first, "delta": delta}
