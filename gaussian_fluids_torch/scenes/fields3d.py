"""3D analytic fields: regularized vortex-ring ensembles, the port of the
JAX package's ``scenes/fields3d.py``. The velocity is a batched sum over
each ring's particles and the Jacobian its hand-derived closed form; the
registry data (domains, particle counts, rings) are the JAX package's."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def ring_particles(center, normal, radius, n):
    """Particle positions x0 (n, 3) and tangent directions w (n, 3) on the
    ring. ``normal`` is deliberately not normalised, as in the reference."""
    center = np.asarray(center, np.float32)
    normal = np.asarray(normal, np.float32)
    axis_x = np.array([1.0, 0.0, 0.0], np.float32)
    if np.linalg.norm(np.cross(axis_x, normal)) < 1e-5:
        axis_x = np.array([0.0, 1.0, 0.0], np.float32)
    axis_y = np.cross(normal, axis_x)
    axis_y /= np.linalg.norm(axis_y)
    axis_x = np.cross(axis_y, normal)
    theta = np.linspace(0.0, 2.0 * np.pi, n + 1, dtype=np.float32)[:-1]
    x0 = (axis_x[None] * np.cos(theta)[:, None]
          + axis_y[None] * np.sin(theta)[:, None]) * radius + center
    w = (axis_x[None] * -np.sin(theta)[:, None]
         + axis_y[None] * np.cos(theta)[:, None])
    return x0, w


def _geometry(x, x0, w, a):
    delta = x[:, None, :] - x0[None, :, :]            # (B, n, 3)
    r = torch.linalg.vector_norm(delta, dim=-1)       # (B, n)
    e = torch.exp(-((r / a) ** 3))
    fr = (1.0 - e) / r ** 3
    wd = torch.linalg.cross(w[None].expand_as(delta), delta, dim=-1)
    return delta, r, e, fr, wd


def vortex_particles_velocity(x, x0, w, U, a):
    """u(x) = sum_j U f(r_j) (w_j x delta_j), f(r) = (1 - e^{-(r/a)^3})/r^3
    (no r = 0 guard, as in the reference)."""
    _, _, _, fr, wd = _geometry(x, x0, w, a)
    return U * torch.einsum("bn,bnk->bk", fr, wd)


def vortex_particles_jacobian(x, x0, w, U, a):
    """d/dx [f(r) W delta] = (f'(r)/r) (W delta) delta^T + f(r) W, with W
    the cross-product matrix of w."""
    delta, r, e, fr, wd = _geometry(x, x0, w, a)
    fr_prime = -3.0 / r ** 4 * (1.0 - e) + 3.0 / (a ** 3 * r) * e
    term1 = ((fr_prime / r)[..., None] * wd).transpose(1, 2) @ delta
    z = torch.zeros_like(w[:, 0])
    W = torch.stack([torch.stack([z, -w[:, 2], w[:, 1]], -1),
                     torch.stack([w[:, 2], z, -w[:, 0]], -1),
                     torch.stack([-w[:, 1], w[:, 0], z], -1)], dim=-2)
    term2 = (fr @ W.reshape(-1, 9)).reshape(-1, 3, 3)
    return U * (term1 + term2)


@dataclasses.dataclass
class Ring:
    center: Tuple[float, float, float]
    normal: Tuple[float, float, float]
    radius: float
    thickness: float
    strength: float
    n: int

    def particle_args(self, device, dtype=torch.float32):
        x0, w = ring_particles(self.center, self.normal, self.radius, self.n)
        return (torch.as_tensor(x0, device=device).to(dtype),
                torch.as_tensor(w * self.strength, device=device).to(dtype),
                self.radius / (2.0 * self.n), self.thickness)


def make_ring_field(rings):
    """(velocity, jacobian) closures over torch tensors (B, 3)."""
    cache: Dict[tuple, list] = {}

    def args(x):
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = [r.particle_args(*key) for r in rings]
        return cache[key]

    def velocity(x):
        out = torch.zeros_like(x)
        for x0, w, U, a in args(x):
            out = out + vortex_particles_velocity(x, x0, w, U, a)
        return out

    def jac(x):
        out = torch.zeros((x.shape[0], 3, 3), dtype=x.dtype, device=x.device)
        for x0, w, U, a in args(x):
            out = out + vortex_particles_jacobian(x, x0, w, U, a)
        return out

    return velocity, jac


# ---- registry data ----

DOMAIN = {
    "leapfrog": (0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
    "single_vortex_ring": (0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
    "ring_collide": (0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
    "ring_with_obstacle": (0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
}

PARTICLE_COUNT = {
    "leapfrog": (10, 10, 10),
    "single_vortex_ring": (40, 40, 40),
    "ring_collide": (40, 40, 40),
    "ring_with_obstacle": (40, 40, 40),
}

VISUALIZE_RES = {name: (128, 128, 128) for name in DOMAIN}

_N = 1.0 / 1.08
OTHER_INFO = {
    "leapfrog": {
        "ring1": Ring((0.75, 0.5, 0.5), (-1.0, 0.0, 0.0), 1.0 / 6,
                      0.12 / 6, 0.1 / 6, 500),
        "ring2": Ring((0.85, 0.5, 0.5), (-1.0, 0.0, 0.0), 0.7 / 6,
                      0.12 / 6, 0.1 / 6, 500),
    },
    "single_vortex_ring": {
        "ring1": Ring((0.5, 0.5, 0.5), (1.0, 0.0, 0.0), 1.0 / 6,
                      0.1 / 6, 0.1 / 6, 500),
    },
    "ring_collide": {
        "ring1": Ring((-0.5 / 6 + 0.5, 0.5, 0.5), (1.0, 0.0, 0.0), 0.3 / 6,
                      0.12 / 6, 0.1 / 6, 500),
        "ring2": Ring((0.5 / 6 + 0.5, 0.5, 0.5), (-1.0, 0.0, 0.0), 0.3 / 6,
                      0.12 / 6, 0.1 / 6, 500),
    },
    # the rings' normal (0.2, 0.2, -1) / 1.08 is not of unit length, as in
    # the reference: the rings are slightly elliptical, their tangents not
    # of unit length
    "ring_with_obstacle": {
        "obj_file": "bunny.obj",
        "scale": 1.0 / 4.8,
        "translate": (0.8225, 0.3150, 0.2650),
        "ring1": Ring((0.475, 0.6, 0.53), (0.2 * _N, 0.2 * _N, -1.0 * _N),
                      0.05, 0.02, 0.2 / 6, 500),
        "ring2": Ring((0.4380, 0.5630, 0.7152),
                      (0.2 * _N, 0.2 * _N, -1.0 * _N),
                      0.05, 0.02, 0.2 / 6, 500),
    },
}


@dataclasses.dataclass
class Scene3D:
    name: str
    domain: Tuple[float, ...]
    particle_count: Tuple[int, int, int]
    visualize_res: Tuple[int, int, int]
    info: Dict
    velocity: Callable
    velocity_jac: Callable
    boundary_sampler: Optional[Callable]  # (gen, n) -> (points, normals)
    mesh_sampler: Optional[object] = None  # scenes.mesh.MeshSampler


def build_scene(name: str) -> Scene3D:
    from gaussian_fluids_torch.scenes import boundaries3d
    if name not in DOMAIN:
        raise KeyError(f"unknown 3D scene {name!r}; valid: {sorted(DOMAIN)}")
    info = OTHER_INFO[name]
    rings = [v for v in info.values() if isinstance(v, Ring)]
    vel, jac = make_ring_field(rings)
    mesh = None
    if "obj_file" in info:
        mesh = boundaries3d.load_obstacle_mesh(info)
    return Scene3D(name=name, domain=DOMAIN[name],
                   particle_count=PARTICLE_COUNT[name],
                   visualize_res=VISUALIZE_RES[name], info=info,
                   velocity=vel, velocity_jac=jac,
                   boundary_sampler=boundaries3d.make_sampler(DOMAIN[name],
                                                              mesh),
                   mesh_sampler=mesh)
