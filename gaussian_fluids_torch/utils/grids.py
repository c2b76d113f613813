"""Grid points with the reference's orderings (2D: meshgrid with 'xy'
indexing, y slowest and x fastest; 3D: 'ij' indexing, x slowest and z
fastest), and the fixed-size chunking of large query sets."""

from __future__ import annotations

import numpy as np
import torch


def sweep_group(n: int, b: int, cap: int = 262144) -> int:
    """Largest divisor g of n with g*b <= cap (min 1): how many epochs'
    sample batches share one batched target sweep."""
    g = max(1, min(n, cap // max(b, 1)))
    while n % g:
        g -= 1
    return g


def axis_nodes(lo: float, hi: float, n: int) -> np.ndarray:
    """(n,) f32 nodes of one grid axis, endpoints included."""
    return np.linspace(lo, hi, n, dtype=np.float32)


def grid_points_2d(x_min, x_max, y_min, y_max, x_n, y_n) -> np.ndarray:
    xs = axis_nodes(x_min, x_max, x_n)
    ys = axis_nodes(y_min, y_max, y_n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    return np.stack([X, Y], axis=-1).reshape(-1, 2)


def grid_points_3d(x_min, x_max, y_min, y_max, z_min, z_max,
                   x_n, y_n, z_n) -> np.ndarray:
    xs = axis_nodes(x_min, x_max, x_n)
    ys = axis_nodes(y_min, y_max, y_n)
    zs = axis_nodes(z_min, z_max, z_n)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3)


def grid_nodes(domain, shape, device="cpu") -> torch.Tensor:
    """(nx * ny * nz, 3) f32 nodes of ``grid_points_3d`` over the
    (x_min, x_max, y_min, y_max, z_min, z_max) ``domain``, built on
    ``device``."""
    axes = [torch.as_tensor(axis_nodes(domain[2 * i], domain[2 * i + 1], n),
                            device=device)
            for i, n in enumerate(shape)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1) \
        .reshape(-1, 3)


def default_chunk(x: torch.Tensor) -> int:
    """The JAX package's chunk of large query sets: 32768 on the
    accelerator (here the card), 4096 elsewhere, where the dense path's
    (chunk, N) kernel matrix bounds it."""
    return 32768 if x.is_cuda else 4096


def pad_chunks(x: torch.Tensor, d: int, b: int, chunk: int = 0):
    """Split (b, d) points into fixed-size chunks: ((nchunk, chunk, d)
    points, (nchunk, chunk) validity weights); ``chunk`` 0 takes
    :func:`default_chunk`."""
    if b == 0:
        raise ValueError("pad_chunks: empty point set (b=0)")
    if chunk == 0:
        chunk = default_chunk(x)
    chunk = min(chunk, b)
    nchunk = -(-b // chunk)
    xp = torch.zeros((nchunk * chunk, d), dtype=torch.float32,
                     device=x.device)
    xp[:b] = x
    valid = (torch.arange(nchunk * chunk, device=x.device) < b) \
        .reshape(nchunk, chunk).float()
    return xp.reshape(nchunk, chunk, d), valid
