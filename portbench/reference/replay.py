"""One semi-Lagrangian density step in plain PyTorch, at sampled nodes.

A node x of the grid is traced back by RK4 through the frame's velocity
field by -dt, clamped to the domain, and the density before the step is
sampled there trilinearly (node-centred grid, spacing extent / (n - 1),
floor-indexed, the high neighbour clamped to the last node). The velocity
is the plain field over every Gaussian of the frame.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import plain
from portbench.reference.projection import rk4_positions


def node_points(idx: torch.Tensor, shape, domain) -> torch.Tensor:
    """(S, 3) coordinates of the flat node indices ``idx`` of the grid
    (x slowest, z fastest)."""
    nx, ny, nz = shape
    axes = [torch.as_tensor(np.linspace(domain[2 * i], domain[2 * i + 1], n,
                                        dtype=np.float32), device=idx.device)
            for i, n in enumerate(shape)]
    i, j, k = idx // (ny * nz), (idx // nz) % ny, idx % nz
    return torch.stack([axes[0][i], axes[1][j], axes[2][k]], -1)


def trilinear(field: torch.Tensor, pos: torch.Tensor, domain):
    shape = field.shape
    dev = pos.device
    lo = torch.tensor([domain[0], domain[2], domain[4]], dtype=torch.float32,
                      device=dev)
    step = torch.tensor([(domain[2 * a + 1] - domain[2 * a]) / (n - 1)
                         for a, n in enumerate(shape)], dtype=torch.float32,
                        device=dev)
    last = torch.tensor([n - 1 for n in shape], device=dev)
    p = (pos - lo) / step
    i0 = torch.floor(p).to(torch.int64)
    w = p - i0.to(p.dtype)
    i0 = torch.minimum(torch.clamp(i0, min=0), last)
    i1 = torch.minimum(i0 + 1, last)
    flat = field.reshape(-1)

    def g(a, b, c):
        return flat[(a * shape[1] + b) * shape[2] + c]

    wx, wy, wz = w.unbind(-1)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    return (g(x0, y0, z0) * (1 - wx) * (1 - wy) * (1 - wz)
            + g(x1, y0, z0) * wx * (1 - wy) * (1 - wz)
            + g(x0, y1, z0) * (1 - wx) * wy * (1 - wz)
            + g(x1, y1, z0) * wx * wy * (1 - wz)
            + g(x0, y0, z1) * (1 - wx) * (1 - wy) * wz
            + g(x1, y0, z1) * wx * (1 - wy) * wz
            + g(x0, y1, z1) * (1 - wx) * wy * wz
            + g(x1, y1, z1) * wx * wy * wz)


@torch.no_grad()
def step_at(frame_path: str, density: torch.Tensor, idx: torch.Tensor,
            domain, dt: float, pair_dtype=torch.float32) -> torch.Tensor:
    """The advected density at the flat node indices ``idx``."""
    mix, spec = plain.load_checkpoint(frame_path, density.device)
    x = node_points(idx, density.shape, domain)
    bk = rk4_positions(
        lambda p: plain.evaluate_blocks(mix, spec, p, False, pair_dtype)[0],
        x, -dt)
    lo = torch.tensor(domain[0::2], dtype=torch.float32, device=x.device)
    hi = torch.tensor(domain[1::2], dtype=torch.float32, device=x.device)
    bk = torch.minimum(torch.maximum(bk, lo), hi)
    return trilinear(density, bk, domain)


def sample_nodes(densities, n: int, seed: int, margin: int) -> torch.Tensor:
    """``n`` flat node indices drawn from ``seed``: half over the whole
    grid, half inside the box that holds every density's support,
    widened by ``margin`` nodes (where a step moves mass)."""
    shape = densities[0].shape
    gen = torch.Generator().manual_seed(int(seed))
    lo = [s for s in shape]
    hi = [0 for _ in shape]
    for d in densities:
        nz = torch.nonzero(d > 0)
        if nz.shape[0]:
            for a in range(3):
                lo[a] = min(lo[a], int(nz[:, a].min()))
                hi[a] = max(hi[a], int(nz[:, a].max()))
    lo = [max(0, min(l, h) - margin) for l, h in zip(lo, hi)]
    hi = [min(s - 1, h + margin) for s, h in zip(shape, hi)]
    half = n // 2
    total = shape[0] * shape[1] * shape[2]
    uni = torch.randint(0, total, (half,), generator=gen)
    box = [torch.randint(lo[a], hi[a] + 1, (n - half,), generator=gen)
           for a in range(3)]
    near = (box[0] * shape[1] + box[1]) * shape[2] + box[2]
    return torch.cat([uni, near])
