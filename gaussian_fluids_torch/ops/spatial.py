"""Spatial sort keys and the flat work lists of the cells kernels — the
port of the JAX package's ``ops/spatial.py``.

The block-sparse kernels cull (query tile x Gaussian tile) pairs by
bounding box, so culling quality is set by the order queries and
Gaussians are sorted in before tiling. The production key is coordinate 0
in 2D and 3D alike. Under ``GF_SPATIAL_KEY=morton`` the 3D key is the
Morton (Z-order) key of a 2^10-per-axis lattice over the caller's bounds,
as in the JAX package, where it is an opt-in measured slower at its
production tiles: a run of consecutive rows is then a compact cube rather
than a thin x-slab.

``flat_work_list`` compacts a boolean tile mask into the (row, col) items
of the live tile pairs, row-sorted, with one keep-alive item per empty
row: a CSR of the mask in disguise, whose runs of equal rows the cells
kernels walk (ops/gsr_cells.py).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from gaussian_fluids_torch.utils import profiling


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each int32 lane 3 apart (Morton 3D)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _spread2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of each int32 lane 2 apart (Morton 2D)."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _as_bound(b, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(b, dtype=torch.float32, device=x.device)


def morton_key(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """(..., ) int32 Z-order key of points ``x`` (..., d) on a lattice of
    2^bits per axis over [lo, hi]: 10 bits in 3D, 15 in 2D (30 bits
    either way, clear of the sign bit). Points outside the box clamp to
    the boundary cells. Bit-identical to the JAX package's key: the same
    f32 scale, clip and truncation."""
    d = x.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"morton_key: d must be 2 or 3, got {d}")
    bits = 10 if d == 3 else 15
    lo, hi = _as_bound(lo, x), _as_bound(hi, x)
    scale = (2.0 ** bits) / torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((x - lo) * scale, 0.0, 2.0 ** bits - 1.0) \
        .to(torch.int32)
    if d == 3:
        return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
                | (_spread3(q[..., 2]) << 2))
    return _spread2(q[..., 0]) | (_spread2(q[..., 1]) << 1)


def morton_on(d: int) -> bool:
    """Whether the spatial key of d-dimensional points is Morton:
    ``GF_SPATIAL_KEY=morton`` in 3D, read at every call as the JAX package
    reads it."""
    return d == 3 and os.environ.get("GF_SPATIAL_KEY") == "morton"


def sort_key(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """The spatial sort key of tiled-kernel inputs: coordinate 0; under
    ``GF_SPATIAL_KEY=morton`` in 3D the Morton key over the lattice bounds
    (``lo``, ``hi``: the box the points were drawn in; where a caller has
    none, the points' own extent over every axis but the last)."""
    if not morton_on(x.shape[-1]):
        return x[..., 0]
    if lo is None or hi is None:
        dims = tuple(range(x.dim() - 1))
        lo, hi = x.amin(dim=dims), x.amax(dim=dims)
    return morton_key(x, lo, hi)


def sort_queries(x: torch.Tensor, lo=None,
                 hi=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_sorted, inverse_permutation) under :func:`sort_key`."""
    order = torch.argsort(sort_key(x, lo, hi))
    return x[order], torch.argsort(order)


def sort_key_np(x) -> np.ndarray:
    """Host-side (numpy) twin of :func:`sort_key`: coordinate 0, Morton in
    3D under ``GF_SPATIAL_KEY=morton`` with the lattice bounds taken from
    ``x``'s own min and max (as the JAX package's: its one caller sorts
    the clone's freshly rebuilt rows, all alive, so the bounds match
    ``GaussianMixture.spatially_sorted``'s alive-masked ones)."""
    x = np.asarray(x)
    if not morton_on(x.shape[-1]):
        return x[..., 0]
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    scale = (2.0 ** 10) / np.maximum(hi - lo, 1e-30)
    q = np.clip((x - lo) * scale, 0.0, 2.0 ** 10 - 1.0).astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(q))
    return (_spread3(t[..., 0]) | (_spread3(t[..., 1]) << 1)
            | (_spread3(t[..., 2]) << 2)).numpy()


def flat_work_list(mask: torch.Tensor, cap: int,
                   count_as: Optional[str] = None):
    """Compact a (R, C) boolean tile mask into a flat work list of length
    ``cap``. Returns (rows, cols, ok):

      rows (cap,) int32: item w touches row ``rows[w]``; row-sorted, and
        every row in [0, R) appears at least once (an empty row gets one
        keep-alive item with ``cols[w] == -1``); items past the list's end
        stay on row R-1 with ``cols == -1``.
      cols (cap,) int32: the live column, or -1 for a keep-alive or
        padding item.
      ok () bool: True iff sum_i max(count_i, 1) <= cap. When False, live
        items are missing and the caller must sweep the whole mask.

    Within a row's run, live items come first in ascending column order,
    so a walker may stop at the first -1. ``count_as`` names the counter
    (``profiling.count``) that takes the rows' live counts against the
    mask's R x C tiles."""
    r, c = mask.shape
    dev = mask.device
    cnt = mask.sum(dim=1)
    if count_as is not None:
        profiling.count(count_as, cnt, r * c)
    cnt1 = cnt.clamp(min=1)                  # keep-alive for empty rows
    total = cnt1.sum()
    starts = torch.cat([torch.zeros((1,), dtype=cnt1.dtype, device=dev),
                        torch.cumsum(cnt1, 0)[:-1]])
    col_ids = torch.arange(c, device=dev).expand(r, c)
    jsorted = torch.sort(torch.where(mask, col_ids, c), dim=1).values
    w = torch.arange(cap, device=dev)
    row = (torch.searchsorted(starts, w, right=True) - 1).clamp(0, r - 1)
    within = w - starts[row]
    j = jsorted[row, within.clamp(0, c - 1)]
    live = (within < cnt[row]) & (w < total) & (j < c)
    rows = torch.where(w < total, row, r - 1).to(torch.int32)
    cols = torch.where(live, j, -1).to(torch.int32)
    return rows, cols, total <= cap
