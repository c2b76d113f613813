"""2D analytic velocity fields.

Each field is a single-point function ``f(x: (2,)) -> (2,)``; the batched
value and Jacobian come from ``torch.func.vmap`` / ``torch.func.jacfwd``,
as the JAX package takes them from ``jax.vmap`` / ``jax.jacfwd``.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.func import jacfwd, vmap


def batched(single):
    """(2,)->(2,) field -> (value: (B,2)->(B,2), jac: (B,2)->(B,2,2))."""
    return vmap(single), vmap(jacfwd(single))


def vortex_particle_single(x, x0, radius, magnitude):
    eps = 1e-6
    # Python-float offsets: no tensor is built (and copied) per call
    dx = torch.stack([x[0] - x0[0], x[1] - x0[1]])
    r = torch.sqrt((dx * dx).sum())
    exp_term = torch.exp(-(((r + eps) / radius) ** 2))
    coef = magnitude * (r + eps) ** -2.0 * (1.0 - exp_term)
    return coef * torch.stack([-dx[1], dx[0]])


def taylor_green_single(x):
    return torch.stack([torch.sin(x[0]) * torch.cos(x[1]),
                        -torch.cos(x[0]) * torch.sin(x[1])])


def taylor_green_jac_closed(x):
    """Hand-coded Jacobian, a test oracle."""
    g00 = torch.cos(x[:, 0]) * torch.cos(x[:, 1])
    g01 = -torch.sin(x[:, 0]) * torch.sin(x[:, 1])
    return torch.stack([torch.stack([g00, g01], dim=-1),
                        torch.stack([-g01, -g00], dim=-1)], dim=-2)


def taylor_vortex_single(x, info):
    """Two Gaussian vortices (reference 2D/init_cond.py:169-191)."""
    U, a = info["U"], info["a"]
    out = 0.0
    for key in ("vortex_pos1", "vortex_pos2"):
        x0 = info[key]
        dx = torch.stack([x[0] - x0[0], x[1] - x0[1]])
        r2 = (dx * dx).sum()
        coef = U / a * torch.exp(0.5 * (1.0 - r2 / a ** 2))
        out = out + coef * torch.stack([-dx[1], dx[0]])
    return out


def leapfrog_single(x, info):
    """Four regularized point vortices."""
    U, a = info["U"], info["a"]
    out = 0.0
    for key, sgn in (("vortex_pos1", 1.0), ("vortex_pos2", 1.0),
                     ("vortex_pos3", -1.0), ("vortex_pos4", -1.0)):
        out = out + vortex_particle_single(x, info[key], a, sgn * U)
    return out


def karman_single(x, info):
    """Uniform inflow (reference 2D/init_cond.py:252-255)."""
    zero = 0.0 * x[0]
    return torch.stack([zero + info["v_magnitude"], zero])


def make_field(name, info):
    """(value_fn, jac_fn) batched over (B, 2) points."""
    if name == "taylor_green":
        return batched(taylor_green_single)
    if name == "taylor_vortex":
        return batched(partial(taylor_vortex_single, info=info))
    if name == "leapfrog":
        return batched(partial(leapfrog_single, info=info))
    if name == "karman":
        return batched(partial(karman_single, info=info))
    raise KeyError(f"2D field {name!r} is not ported yet")
