"""3D boundary sampler: area-weighted points on the six faces of the
domain box with inward normals, the box half of the JAX package's
``scenes/boundaries3d.py`` (the obstacle-mesh sampler is not ported yet).
The random draws come from the caller's ``torch.Generator``;
``sample_on_box`` takes them as arguments, so tests can feed the JAX
package's draws."""

from __future__ import annotations

import torch


def sample_on_box(t, u, v, domain):
    """Points on the box faces and their inward normals from three (n,)
    uniforms in [0, 1): ``t`` picks the face by area, ``u`` and ``v``
    place the point on it."""
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    xs, ys, zs = x_max - x_min, y_max - y_min, z_max - z_min
    areas = torch.tensor([ys * zs, ys * zs, zs * xs, zs * xs, xs * ys,
                          xs * ys], dtype=torch.float32, device=t.device)
    face = torch.searchsorted(torch.cumsum(areas, 0), t * areas.sum())
    # faces 0,1: y from u, z from v; faces 2,3: x from u, z from v;
    # faces 4,5: x from u, y from v
    ux = u * xs + x_min
    uy = u * ys + y_min
    vy = v * ys + y_min
    vz = v * zs + z_min
    full = lambda c: torch.full_like(t, c)   # noqa: E731
    px = torch.where(face == 0, full(x_min),
                     torch.where(face == 1, full(x_max), ux))
    py = torch.where(face <= 1, uy,
                     torch.where(face == 2, full(y_min),
                                 torch.where(face == 3, full(y_max), vy)))
    pz = torch.where(face <= 3, vz,
                     torch.where(face == 4, full(z_min), full(z_max)))
    normals = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                           device=t.device)
    return torch.stack([px, py, pz], -1), normals[face]


def make_sampler(domain):
    """(gen, n) -> (points, normals) on the box faces."""
    def box_sampler(gen, n):
        t, u, v = torch.rand((3, n), generator=gen, device=gen.device)
        return sample_on_box(t, u, v, domain)

    return box_sampler
