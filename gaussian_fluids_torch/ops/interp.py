"""Trilinear grid interpolation and the ring density seed of the smoke
replay — the JAX package's ``ops/interp.py`` (reference
3D/advance_density.py:13-50), on the device of the inputs.

The grid is node-centred over the domain with spacing extent / (n - 1),
floor-indexed, with the high neighbour clamped to the last node.
``bilinear_interp`` and ``multi_channel_interp`` serve ``--target_grid``
only and are not ported yet.
"""

from __future__ import annotations

import torch

from gaussian_fluids_torch.utils.grids import axis_nodes


def trilinear_interp(field: torch.Tensor, positions: torch.Tensor,
                     domain) -> torch.Tensor:
    """field: (nx, ny, nz); positions: (..., 3) -> (...)."""
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    nx, ny, nz = field.shape
    dev = positions.device
    lo = torch.tensor([x_min, y_min, z_min], dtype=torch.float32, device=dev)
    dxyz = torch.tensor([(x_max - x_min) / (nx - 1),
                         (y_max - y_min) / (ny - 1),
                         (z_max - z_min) / (nz - 1)], dtype=torch.float32,
                        device=dev)
    p = (positions - lo) / dxyz
    i0 = torch.floor(p).to(torch.int64)
    w = p - i0.to(torch.float32)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int64,
                      device=dev)
    i0 = torch.minimum(torch.clamp(i0, min=0), hi)
    i1 = torch.minimum(i0 + 1, hi)
    flat = field.reshape(-1)

    def g(ix, iy, iz):
        return flat[(ix * ny + iy) * nz + iz]

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    return (g(x0, y0, z0) * (1 - wx) * (1 - wy) * (1 - wz)
            + g(x1, y0, z0) * wx * (1 - wy) * (1 - wz)
            + g(x0, y1, z0) * (1 - wx) * wy * (1 - wz)
            + g(x1, y1, z0) * wx * wy * (1 - wz)
            + g(x0, y0, z1) * (1 - wx) * (1 - wy) * wz
            + g(x1, y0, z1) * wx * (1 - wy) * wz
            + g(x0, y1, z1) * (1 - wx) * wy * wz
            + g(x1, y1, z1) * wx * wy * wz)


def seed_ring_density(shape, domain, center, normal, radius, thickness,
                      device="cpu") -> torch.Tensor:
    """A solid-torus indicator density (the reference's ``ti_set_ring``,
    3D/advance_density.py:13-21), built on ``device``."""
    nx, ny, nz = shape
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    dev = torch.device(device)
    axes = [torch.as_tensor(axis_nodes(a, b, n), device=dev)
            for a, b, n in ((x_min, x_max, nx), (y_min, y_max, ny),
                            (z_min, z_max, nz))]
    pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    c = torch.tensor(center, dtype=torch.float32, device=dev)
    nv = torch.tensor(normal, dtype=torch.float32, device=dev)
    n = nv / torch.linalg.norm(nv)
    radius = torch.tensor(radius, dtype=torch.float32, device=dev)
    thickness = torch.tensor(thickness, dtype=torch.float32, device=dev)
    rel = pos - c
    proj = pos - (rel @ n)[..., None] * n
    rad_vec = proj - c
    rad_len = torch.linalg.norm(rad_vec, dim=-1)
    outside_inner = rad_len >= radius - thickness
    safe = torch.clamp(rad_len, min=1e-12)[..., None]
    nearest = c + rad_vec / safe * radius
    close = torch.linalg.norm(pos - nearest, dim=-1) <= thickness
    return (outside_inner & close).to(torch.float32)
