"""2D boundary samplers (the scenes of this port use the free-slip domain
walls only).

A sampler is ``sample(gen, n, adv) -> (points, normals, target flux)`` in
scaled (target) space; ``adv`` is the current unscaled advance domain as a
(4,) tensor (x_min, x_max, y_min, y_max). The random draws come from the
caller's ``torch.Generator``; ``sample_on_domain_boundary_2`` takes them
as an argument, so tests can feed the JAX package's draws.
"""

from __future__ import annotations

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


def make_samplers(name, info, scaling_factor):
    """(sampler_1 | None, sampler_2 | None) for a scene."""
    def domain_only_2(gen, n, adv):
        u = torch.rand((n,), generator=gen, device=adv.device)
        return sample_on_domain_boundary_2(u, adv, scaling_factor)

    if name in ("taylor_green", "taylor_vortex", "leapfrog"):
        return None, domain_only_2
    raise KeyError(f"2D scene {name!r} is not ported yet")
