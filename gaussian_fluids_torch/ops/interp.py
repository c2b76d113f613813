"""Grid interpolation and the ring density seed of the smoke replay — the
JAX package's ``ops/interp.py`` (reference 3D/advance_density.py:13-50),
on the device of the inputs.

The grid is node-centred over the domain with spacing extent / (n - 1),
floor-indexed, with the high neighbour clamped to the last node.
``trilinear_interp`` serves the replay; ``bilinear_interp`` and
``multi_channel_interp`` the ``--target_grid`` cached targets, whose
``domain`` may hold 0-d tensors (Karman's advance domain moves between
frames). Each corner's product and the sum over corners run in the JAX
package's order.
"""

from __future__ import annotations

import torch

from gaussian_fluids_torch.utils.grids import axis_nodes


def _frame(domain, shape, dev):
    """(lo, spacing, last index) of the grid: f32 from Python floats as
    the JAX package's ``jnp.asarray``, or f32 arithmetic on 0-d tensors."""
    k = len(shape)
    f32 = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (
        [domain[2 * i] for i in range(k)]
        + [(domain[2 * i + 1] - domain[2 * i]) / (n - 1)
           for i, n in enumerate(shape)])]
    last = torch.tensor([n - 1 for n in shape], dtype=torch.int64,
                        device=dev)
    return torch.stack(f32[:k]), torch.stack(f32[k:]), last


def _corners(field, positions, domain, k):
    """(gather(i_0, ..., i_{k-1}), weights w, low and high indices) for a
    field (n_0, ..., n_{k-1}, *channels); the gather gives (..., *channels)
    and w is shaped to broadcast against it."""
    shape = tuple(field.shape[:k])
    lo, step, last = _frame(domain, shape, positions.device)
    p = (positions - lo) / step
    i0 = torch.floor(p).to(torch.int64)
    w = p - i0.to(p.dtype)
    i0 = torch.minimum(torch.clamp(i0, min=0), last)
    i1 = torch.minimum(i0 + 1, last)
    flat = field.reshape((-1,) + tuple(field.shape[k:]))
    ch = field.dim() - k
    ws = [w[..., j].reshape(w.shape[:-1] + (1,) * ch) for j in range(k)]

    def g(*idx):
        lin = idx[0]
        for i, n in zip(idx[1:], shape[1:]):
            lin = lin * n + i
        return flat[lin]

    return g, ws, i0, i1


def trilinear_interp(field: torch.Tensor, positions: torch.Tensor,
                     domain) -> torch.Tensor:
    """field: (nx, ny, nz[, C]); positions: (..., 3) -> (...[, C])."""
    g, (wx, wy, wz), i0, i1 = _corners(field, positions, domain, 3)
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


def bilinear_interp(field: torch.Tensor, positions: torch.Tensor,
                    domain) -> torch.Tensor:
    """The 2D analogue: field (nx, ny[, C]); positions (..., 2) ->
    (...[, C]); ``domain`` is (x_min, x_max, y_min, y_max)."""
    g, (wx, wy), i0, i1 = _corners(field, positions, domain, 2)
    x0, y0 = i0[..., 0], i0[..., 1]
    x1, y1 = i1[..., 0], i1[..., 1]
    return (g(x0, y0) * (1 - wx) * (1 - wy)
            + g(x1, y0) * wx * (1 - wy)
            + g(x0, y1) * (1 - wx) * wy
            + g(x1, y1) * wx * wy)


def multi_channel_interp(field: torch.Tensor, positions: torch.Tensor,
                         domain) -> torch.Tensor:
    """Channels-last bi- or trilinear interpolation: field (nx, ny[, nz],
    C), positions (..., d) -> (..., C), by positions' last dimension."""
    f = bilinear_interp if positions.shape[-1] == 2 else trilinear_interp
    return f(field, positions, domain)


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
