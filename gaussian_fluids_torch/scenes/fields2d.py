"""2D analytic velocity fields.

Each field is a single-point function ``f(x: (2,)) -> (2,)``; the batched
value and Jacobian come from ``torch.func.vmap`` / ``torch.func.jacfwd``,
as the JAX package takes them from ``jax.vmap`` / ``jax.jacfwd``.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
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


def vortices_pass_single(x, info):
    """A counter-rotating vortex pair (reference 2D/init_cond.py:204-209)."""
    U, a = info["U"], info["a"]
    return (vortex_particle_single(x, info["vortex_pos1"], a, U)
            + vortex_particle_single(x, info["vortex_pos2"], a, -U))


PARTICLES_OBJ = os.path.join(os.path.dirname(__file__), "..", "..",
                             "assets", "vortices_pass_particles.obj")


def load_vortex_particles(path=PARTICLES_OBJ):
    """((48, 2) positions, (48,) strengths) as f32 numpy arrays from the
    OBJ-style asset: each ``v x z y w`` line gives a vortex at (x, y) of
    strength w (reference 2D/init_cond.py:213-223)."""
    rows = []
    with open(path) as fd:
        for line in fd:
            if line.startswith("v "):
                p = line.split()
                rows.append((float(p[1]), float(p[3]), float(p[4])))
    a = np.asarray(rows, np.float32)
    return a[:, :2].copy(), a[:, 2].copy()


def vortices_pass_particles_single(x, pos, strength):
    """48 point vortices with a softened 1/r^2 kernel (reference
    2D/init_cond.py:225-236)."""
    eps = 0.1
    delta = pos - x[None, :]
    rescaled = (strength[:, None] * delta
                / ((delta ** 2).sum(-1)[:, None] + eps)).sum(0)
    return torch.stack([-rescaled[1], rescaled[0]])


def _particles_field():
    """(value_fn, jac_fn) of the 48-vortex field, its vortices copied to
    each device once, at the first call there."""
    pos, strength = load_vortex_particles()
    on = {}

    def fns(x):
        if x.device not in on:
            on[x.device] = batched(partial(
                vortices_pass_particles_single,
                pos=torch.as_tensor(pos, device=x.device),
                strength=torch.as_tensor(strength, device=x.device)))
        return on[x.device]

    return (lambda x: fns(x)[0](x)), (lambda x: fns(x)[1](x))


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
    if name in ("vortices_pass", "vortices_pass_narrow",
                "vortices_pass_noslip"):
        return batched(partial(vortices_pass_single, info=info))
    if name == "vortices_pass_particles":
        return _particles_field()
    if name == "karman":
        return batched(partial(karman_single, info=info))
    raise KeyError(f"unknown 2D field: {name!r}")
