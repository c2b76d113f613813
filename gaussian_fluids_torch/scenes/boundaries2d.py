"""2D boundary samplers: the free-slip domain walls, the obstacle circles
of the ``vortices_pass`` scenes (free-slip, or no-slip Dirichlet), and
Karman's cylinder and inflow/outflow edges.

Two sampler types, in scaled (target) space:
  type-1 Dirichlet:   ``sample(gen, n, adv) -> (points, target velocity)``
  type-2 normal flux: ``sample(gen, n, adv) -> (points, normals, flux)``
``adv`` is the current unscaled advance domain as a (4,) tensor (x_min,
x_max, y_min, y_max); Karman grows it every frame. The random draws come
from the caller's ``torch.Generator``; the functions below the samplers
take them as arguments, so tests can feed the JAX package's draws.
"""

from __future__ import annotations

import math

import torch


def sample_on_domain_boundary_2(u, adv_domain, scaling_factor):
    """Free-slip rectangle walls at perimeter fractions ``u`` in [0, 1)."""
    x_min, x_max, y_min, y_max = (adv_domain[0], adv_domain[1],
                                  adv_domain[2], adv_domain[3])
    x_scale, y_scale = x_max - x_min, y_max - y_min
    t = u * (x_scale + y_scale) * 2.0
    edge1 = (t >= x_scale) & (t < x_scale + y_scale)
    edge2 = (t >= x_scale + y_scale) & (t < 2.0 * x_scale + y_scale)
    edge3 = t >= 2.0 * x_scale + y_scale
    edge0 = ~(edge1 | edge2 | edge3)
    px = torch.where(edge0, x_min + t,
         torch.where(edge1, x_max,
         torch.where(edge2, x_max - t + x_scale + y_scale, x_min)))
    py = torch.where(edge0, y_min,
         torch.where(edge1, y_min + t - x_scale,
         torch.where(edge2, y_max,
                     y_max - t + 2.0 * x_scale + y_scale)))
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    nx = torch.where(edge1, one, torch.where(edge3, -one, zero))
    ny = torch.where(edge0, -one, torch.where(edge2, one, zero))
    data = torch.stack([px, py], dim=-1) * scaling_factor
    normal = torch.stack([nx, ny], dim=-1)
    return data, normal, zero


def sample_on_sphere(u, x, y, r):
    """(points, outward normals) on the circle of centre (x, y) and radius
    r at angle fractions ``u`` in [0, 1)."""
    theta = u * 2.0 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([r * c + x, r * s + y], -1), torch.stack([c, s], -1)


def karman_cylinder(u, info, scaling_factor):
    """Dirichlet u = 0 on the cylinder (reference 2D/init_cond.py:374-375):
    n points at angle fractions ``u``."""
    d, _ = sample_on_sphere(u, *info["obstacle_pos"], info["obstacle_radius"])
    return d * scaling_factor, torch.zeros_like(d)


def karman_edges(u1, u2, adv, info, scaling_factor):
    """The 5-edge flux sampler with signed inflow and outflow (reference
    2D/init_cond.py:377-405): 5n points at fractions ``u1`` along x (lower
    and upper edges) and ``u2`` along y (left and right edges of the advance
    domain and the left edge of the visualize domain)."""
    x_min, x_max, y_min, y_max = adv[0], adv[1], adv[2], adv[3]
    t = u1 * (x_max - x_min) + x_min
    t2 = u2 * (y_max - y_min) + y_min
    vmag = info["v_magnitude"]
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    data = torch.cat([
        torch.stack([t, y_min * ones], -1),                   # lower
        torch.stack([t, y_max * ones], -1),                   # upper
        torch.stack([x_min * ones, t2], -1),                  # left
        torch.stack([x_max * ones, t2], -1),                  # right
        torch.stack([info["visualize_x_min"] * ones, t2], -1),  # viz left
    ])
    normal = torch.cat([
        torch.stack([zeros, ones], -1),
        torch.stack([zeros, -ones], -1),
        torch.stack([ones, zeros], -1),
        torch.stack([-ones, zeros], -1),
        torch.stack([ones, zeros], -1),
    ])
    nval = torch.cat([zeros, zeros, vmag * ones, -vmag * ones, vmag * ones])
    return data * scaling_factor, normal, nval * scaling_factor


def obstacle_circles(u1, u2, info):
    """(points, outward normals) on the two obstacle circles, unscaled: n
    points on each at angle fractions ``u1`` and ``u2``, circle 1 first."""
    r = info["obstacle_radius"]
    d1, n1 = sample_on_sphere(u1, *info["obstacle_pos1"], r)
    d2, n2 = sample_on_sphere(u2, *info["obstacle_pos2"], r)
    return torch.cat([d1, d2]), torch.cat([n1, n2])


def vortices_pass_flux(u1, u2, u3, adv, info, scaling_factor):
    """Free-slip circles and walls (reference 2D/init_cond.py:349-356):
    3n points, the two circles' then the walls' at perimeter fractions
    ``u3``, with zero flux."""
    dc, nc = obstacle_circles(u1, u2, info)
    dw, nw, _ = sample_on_domain_boundary_2(u3, adv, scaling_factor)
    data = torch.cat([dc * scaling_factor, dw])
    return data, torch.cat([nc, nw]), torch.zeros_like(data[:, 0])


def circles_noslip(u1, u2, info, scaling_factor):
    """No-slip circles, target velocity 0 (reference
    2D/init_cond.py:341-347): 2n points."""
    dc, _ = obstacle_circles(u1, u2, info)
    return dc * scaling_factor, torch.zeros_like(dc)


def circles_flux(u1, u2, info, scaling_factor):
    """Free-slip circles without walls (reference 2D/init_cond.py:358-364):
    2n points, zero flux."""
    dc, nc = obstacle_circles(u1, u2, info)
    return dc * scaling_factor, nc, torch.zeros_like(dc[:, 0])


def make_samplers(name, info, scaling_factor):
    """(sampler_1 | None, sampler_2 | None) for a scene."""
    def uniform(gen, n, adv):
        return torch.rand((n,), generator=gen, device=adv.device)

    def domain_only_2(gen, n, adv):
        return sample_on_domain_boundary_2(uniform(gen, n, adv), adv,
                                           scaling_factor)

    if name in ("taylor_green", "taylor_vortex", "leapfrog"):
        return None, domain_only_2
    if name in ("vortices_pass", "vortices_pass_narrow"):
        def s2(gen, n, adv):
            u1, u2 = uniform(gen, n, adv), uniform(gen, n, adv)
            return vortices_pass_flux(u1, u2, uniform(gen, n, adv), adv,
                                      info, scaling_factor)
        return None, s2
    if name == "vortices_pass_noslip":
        def s1(gen, n, adv):
            u1 = uniform(gen, n, adv)
            return circles_noslip(u1, uniform(gen, n, adv), info,
                                  scaling_factor)
        return s1, domain_only_2
    if name == "vortices_pass_particles":
        def s2(gen, n, adv):
            u1 = uniform(gen, n, adv)
            return circles_flux(u1, uniform(gen, n, adv), info,
                                scaling_factor)
        return None, s2
    if name == "karman":
        def s1(gen, n, adv):
            return karman_cylinder(uniform(gen, n, adv), info,
                                   scaling_factor)

        def s2(gen, n, adv):
            u1 = uniform(gen, n, adv)
            return karman_edges(u1, uniform(gen, n, adv), adv, info,
                                scaling_factor)
        return s1, s2
    raise KeyError(f"unknown 2D scene: {name!r}")
