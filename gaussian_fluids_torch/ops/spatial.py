"""Spatial sort keys and the flat work lists of the cells kernels — the
port of the JAX package's ``ops/spatial.py``.

The block-sparse kernels cull (query tile x Gaussian tile) pairs by
bounding box, so culling quality is set by the order queries and
Gaussians are sorted in before tiling. The production key is coordinate 0
in 2D and 3D alike (the JAX package's Morton key serves only its opt-in
``GF_SPATIAL_KEY=morton`` and is not ported yet).

``flat_work_list`` compacts a boolean tile mask into the (row, col) items
of the live tile pairs, row-sorted, with one keep-alive item per empty
row: a CSR of the mask in disguise, whose runs of equal rows the cells
kernels walk (ops/gsr_cells.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """The spatial sort key of tiled-kernel inputs: coordinate 0 (the JAX
    package's lattice bounds serve only its Morton key)."""
    return x[..., 0]


def sort_queries(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_sorted, inverse_permutation) under :func:`sort_key`."""
    order = torch.argsort(sort_key(x))
    return x[order], torch.argsort(order)


def sort_key_np(x) -> np.ndarray:
    """Host-side (numpy) twin of :func:`sort_key`."""
    return np.asarray(x)[..., 0]


def flat_work_list(mask: torch.Tensor, cap: int):
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
    so a walker may stop at the first -1."""
    r, c = mask.shape
    dev = mask.device
    cnt = mask.sum(dim=1)
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
