"""The projection phase's first epochs in plain PyTorch, 2D and 3D.

From a frozen checkpoint (the previous frame's field) it works out the
start of a projection as the frame loop makes it (the Gaussians' centres
advected by RK4 through that field), draws each epoch's batches from a
generator seeded as the program's, and runs the epochs: the covector
target by an RK4 backtrace (in 3D carrying the flow map's deformation
gradient), the vorticity (and helicity) and divergence heads, PCGrad,
the regularizers and the boundary term, and one Adam step per parameter
group. It returns what the optimizer was given and what it made: each
step's loss, the first step's gradients and the parameters after the
last step.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import plain

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
ANISO_RATIO = 1.5


# ---- the flow ----

def rk4_positions(f, x, dt):
    v = f(x)
    v1 = f(x + dt * 0.5 * v)
    v2 = f(x + dt * 0.5 * v1)
    v3 = f(x + dt * v2)
    return x + dt / 6.0 * (v + 2.0 * v1 + 2.0 * v2 + v3)


def rk4_deformation(f, x, dt):
    """(phi, dphi, v(phi), dv(phi)) through f(points) -> (v, dv)."""
    v, dv = f(x)
    phi1 = x + dt * 0.5 * v
    v1, dv1 = f(phi1)
    phi2 = x + dt * 0.5 * v1
    v2, dv2 = f(phi2)
    phi3 = x + dt * v2
    v3, dv3 = f(phi3)
    phi = x + dt / 6.0 * (v + 2.0 * v1 + 2.0 * v2 + v3)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[None]
    dphi1 = eye + dt * 0.5 * dv
    dv1x = dv1 @ dphi1
    dphi2 = eye + dt * 0.5 * dv1x
    dv2x = dv2 @ dphi2
    dphi3 = eye + dt * dv2x
    dphi = eye + dt / 6.0 * (dv + 2.0 * dv1x + 2.0 * dv2x + dv3 @ dphi3)
    vp, dvp = f(phi)
    return phi, dphi, vp, dvp


def curl2d(j):
    return j[:, 1, 0] - j[:, 0, 1]


def curl3d(j):
    return torch.stack([j[:, 2, 1] - j[:, 1, 2], j[:, 0, 2] - j[:, 2, 0],
                        j[:, 1, 0] - j[:, 0, 1]], -1)


def divergence(j):
    return j.diagonal(dim1=-2, dim2=-1).sum(-1)


# ---- the start state ----

@torch.no_grad()
def advected_start(old: plain.Mixture, spec: plain.Spec, dt: float,
                   pair_dtype=torch.float32) -> plain.Mixture:
    """The frame loop's advect: each centre moved by RK4 through the old
    field; in 3D clipped to the padded domain, in 2D those that leave it
    dropped."""
    d = old.positions.shape[1]
    new = rk4_positions(
        lambda p: plain.evaluate_blocks(old, spec, p, False, pair_dtype)[0],
        old.positions, dt)
    lo = torch.tensor(spec.lo, device=new.device)
    hi = torch.tensor(spec.hi, device=new.device)
    if d == 3:
        return old._replace(positions=torch.minimum(torch.maximum(new, lo),
                                                    hi))
    keep = ((new >= lo) & (new <= hi)).all(-1)
    return plain.Mixture(new[keep], old.scalings[keep], old.rotations[keep],
                         old.values[keep])


# ---- the draws ----

def box_batch(gen, n, lo, hi):
    u = torch.rand((n, lo.shape[0]), generator=gen, device=lo.device)
    return u * (hi - lo) + lo


def box_faces(gen, n, domain):
    """n points on the faces of the box ``domain``, by area, with inward
    normals."""
    t, u, v = torch.rand((3, n), generator=gen, device=gen.device)
    x0, x1, y0, y1, z0, z1 = domain
    xs, ys, zs = x1 - x0, y1 - y0, z1 - z0
    areas = torch.tensor([ys * zs, ys * zs, zs * xs, zs * xs, xs * ys,
                          xs * ys], dtype=torch.float32, device=t.device)
    face = torch.searchsorted(torch.cumsum(areas, 0), t * areas.sum())
    full = lambda c: torch.full_like(t, c)   # noqa: E731
    px = torch.where(face == 0, full(x0),
                     torch.where(face == 1, full(x1), u * xs + x0))
    py = torch.where(face <= 1, u * ys + y0,
                     torch.where(face == 2, full(y0),
                                 torch.where(face == 3, full(y1),
                                             v * ys + y0)))
    pz = torch.where(face <= 3, v * zs + z0,
                     torch.where(face == 4, full(z0), full(z1)))
    normals = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                           device=t.device)
    return torch.stack([px, py, pz], -1), normals[face]


def rectangle_walls(gen, n, adv, sf):
    """n points on the walls of the rectangle ``adv`` (a (4,) tensor),
    scaled by ``sf``, with outward normals."""
    u = torch.rand((n,), generator=gen, device=adv.device)
    x0, x1, y0, y1 = adv[0], adv[1], adv[2], adv[3]
    xs, ys = x1 - x0, y1 - y0
    t = u * (xs + ys) * 2.0
    e1 = (t >= xs) & (t < xs + ys)
    e2 = (t >= xs + ys) & (t < 2.0 * xs + ys)
    e3 = t >= 2.0 * xs + ys
    e0 = ~(e1 | e2 | e3)
    px = torch.where(e0, x0 + t, torch.where(e1, x1, torch.where(
        e2, x1 - t + xs + ys, x0)))
    py = torch.where(e0, y0, torch.where(e1, y0 + t - xs, torch.where(
        e2, y1, y1 - t + 2.0 * xs + ys)))
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    nx = torch.where(e1, one, torch.where(e3, -one, zero))
    ny = torch.where(e0, -one, torch.where(e2, one, zero))
    return torch.stack([px, py], -1) * sf, torch.stack([nx, ny], -1)


# ---- the regularizers ----

def aniso(s):
    ratio = torch.exp(s.amax(-1) - s.amin(-1))
    return (ratio.clamp(min=ANISO_RATIO) - ANISO_RATIO).mean()


def volume(s):
    vol = torch.exp(-s.sum(-1))
    return ((vol / vol.mean() - 1.0) ** 2).mean()


def pcgrad(g1, g2):
    out = {}
    for k in g1:
        a, b = g1[k], g2[k]
        dot = (a * b).sum()
        na = a / torch.linalg.vector_norm(a).clamp(min=1e-30)
        nb = b / torch.linalg.vector_norm(b).clamp(min=1e-30)
        a2 = a - (a * nb).sum() * nb
        b2 = b - (b * na).sum() * na
        out[k] = torch.where(dot < 0.0, a2 + b2, a + b)
    return out


# ---- the epochs ----

class Setting:
    """What one cell's projection needs: the configuration's scene
    constants and the traffic's batch."""

    def __init__(self, cfg: dict):
        self.d = int(cfg["d"])
        self.batch = int(cfg["batch"])
        self.dt = float(cfg["dt"])
        self.w = dict(cfg["weights"])
        self.boundary_lambda = float(cfg["boundary_lambda"])
        self.lrs = dict(cfg["lrs"])
        self.domain = tuple(float(v) for v in cfg["domain"])
        self.sf = float(cfg.get("scaling_factor", 1.0))


def _targets(s: Setting, old, spec, x, pair_dtype):
    """The covector targets at x: 2D the vorticity, 3D (vor, hel)."""
    def f(p):
        return plain.evaluate_blocks(old, spec, p, True, pair_dtype)
    if s.d == 3:
        _, dphi, pv, pdv = rk4_deformation(f, x, -s.dt)
        pvor = curl3d(pdv)
        hel = (pv * pvor).sum(-1)
        vor = torch.linalg.solve(dphi, pvor[..., None])[..., 0]
        return vor, hel
    bk = rk4_positions(lambda p: f(p)[0], x, -s.dt)
    _, dv = f(bk)
    vor = curl2d(dv)
    lo = torch.tensor(s.domain[0::2], device=x.device) * s.sf
    hi = torch.tensor(s.domain[1::2], device=x.device) * s.sf
    inside = ((bk >= lo) & (bk <= hi)).all(-1)
    return torch.where(inside, vor, torch.zeros_like(vor)), None


def draw_epoch(s: Setting, gen):
    """One epoch's (batch, boundary points, boundary normals), drawn in
    the program's order."""
    dev = gen.device
    if s.d == 3:
        lo = torch.tensor(s.domain[0::2], dtype=torch.float32, device=dev)
        hi = torch.tensor(s.domain[1::2], dtype=torch.float32, device=dev)
        x = box_batch(gen, s.batch, lo, hi)
        bx, bn = box_faces(gen, s.batch, s.domain)
        return x, bx, bn
    adv = torch.tensor(s.domain, dtype=torch.float32, device=dev)
    lo = torch.stack([adv[0], adv[2]]) * s.sf
    hi = torch.stack([adv[1], adv[3]]) * s.sf
    x = box_batch(gen, s.batch, lo, hi)
    bx, bn = rectangle_walls(gen, s.batch, adv, s.sf)
    return x, bx, bn


def epoch(s: Setting, params, opt, old, spec, positions_org, draws,
          pair_dtype=torch.float32, half_batch=False):
    """One projection epoch. Returns (params, opt, loss, grads)."""
    x, bx, bn = draws
    with torch.no_grad():
        vor, hel = _targets(s, old, spec, x, pair_dtype)
    if half_batch:
        b = x.shape[0] // 2
        x, vor = x[:b], vor[:b]
        hel = None if hel is None else hel[:b]
    b = x.shape[0]
    w = s.w
    if s.d == 3:
        def head_vh(val, jac, sl):
            c = curl3d(jac)
            return (w["vor"] * (c - vor[sl]).abs().sum() / (3 * b)
                    + w["hel"] * ((val * c).sum(-1) - hel[sl]).abs().sum()
                    / b)
    else:
        def head_vh(val, jac, sl):
            return w["vor"] * (curl2d(jac) - vor[sl]).abs().sum() / b

    def head_div(val, jac, sl):
        return w["div"] * (divergence(jac) ** 2).sum() / b

    (l_vh, l_div), (g_vh, g_div) = plain.head_grads(
        params, spec, x, [head_vh, head_div], True, pair_dtype)

    nb = bx.shape[0]
    if s.d == 3:
        def head_bnd(val, jac, sl):
            return (val * bn[sl]).sum(-1).abs().sum() / nb
    else:
        def head_bnd(val, jac, sl):
            return ((val * bn[sl]).sum(-1) - 0.0).abs().sum() / nb
    (bc,), (g_bc,) = plain.head_grads(params, spec, bx, [head_bnd], False,
                                      pair_dtype)

    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        reg = (w["aniso"] * aniso(leaves["scalings"])
               + w["vol"] * volume(leaves["scalings"]))
        if w.get("delta_pos", 0.0):
            reg = reg + w["delta_pos"] * ((leaves["positions"]
                                           - positions_org) ** 2
                                          ).mean(-1).mean()
        g_reg = dict(zip(leaves, torch.autograd.grad(
            reg, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
    lam = s.boundary_lambda
    g_data = pcgrad(g_vh, g_div)
    grads = {k: g_reg[k] + lam * g_bc[k] + g_data[k] for k in params}
    loss = l_vh + l_div + reg.detach() + lam * bc
    params, opt = adam(params, opt, grads, s.lrs)
    return params, opt, float(loss), grads


def adam(params, opt, grads, lrs):
    """One Adam step per group; the plateau schedule cannot act in the
    first steps (its patience is 50), so it is left out."""
    t = opt["t"] + 1
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * opt["m"][k] + (1.0 - BETA1) * g
        v = BETA2 * opt["v"][k] + (1.0 - BETA2) * g * g
        mh = m / (1.0 - BETA1 ** t)
        vh = v / (1.0 - BETA2 ** t)
        new_p[k] = p - lrs[k] * mh / (torch.sqrt(vh) + EPS)
        new_m[k], new_v[k] = m, v
    return new_p, {"t": t, "m": new_m, "v": new_v}


def first_steps(cfg: dict, frame_path: str, gen_seed: int, device,
                steps: int = 3, pair_dtype=torch.float32,
                half_batch: bool = False) -> Dict[str, object]:
    """The reference's first ``steps`` projection epochs from the frozen
    frame ``frame_path``, the batches drawn from a generator seeded with
    ``gen_seed`` on ``device``. Returns {"losses": [...], "grads": the
    first step's, "delta": the parameters' change after the last step}."""
    s = Setting(cfg)
    old, spec = plain.load_checkpoint(frame_path, device)
    start = advected_start(old, spec, s.dt, pair_dtype)
    params = dict(start._asdict())
    opt = {"t": 0, "m": {k: torch.zeros_like(p) for k, p in params.items()},
           "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    draws = [draw_epoch(s, gen) for _ in range(steps)]
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
