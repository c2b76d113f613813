"""The Gaussian mixture state: four parameter tensors plus an alive mask.

Dynamic particle counts (splitting adds Gaussians, leaving the domain
removes them) are handled as in the JAX package, with **padding + an alive
mask**: tensors are padded to a capacity from a geometric ladder of
multiples of 512, so the tile mask and the kernels see few distinct
shapes. Padded (dead) entries have ``values = 0``, sit at the padded
domain corner, and are masked out of every field evaluation and loss.

Training differentiates with respect to the 4-tensor parameter dict
(``params()`` / ``with_params``), one optimizer group each.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.ops.rotations import precision_matrix

PAD_BUCKET = 512  # capacities are multiples of this (kernel tile divisors)

# Capacity ladder growth factor, read at import as the JAX package reads
# it: each crossing adds ~25% headroom by default, so a run re-buckets
# O(log N) times; GF_PAD_GROWTH=1 gives arithmetic 512-buckets.
_PAD_GROWTH = float(os.environ.get("GF_PAD_GROWTH", "1.25"))

PARAM_KEYS = ("positions", "scalings", "rotations", "values")


def _bucket(n: int) -> int:
    cap = PAD_BUCKET
    while cap < n:
        step = max(cap * (_PAD_GROWTH - 1.0), PAD_BUCKET)
        cap = ((cap + int(step) + PAD_BUCKET - 1) // PAD_BUCKET) * PAD_BUCKET
    return cap


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not
                           isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


@dataclasses.dataclass
class GaussianMixture:
    """N anisotropic Gaussians (d = 2 or 3) carrying a ``vdim``-dimensional
    value.

    positions: (N, d) centres mu_i.
    scalings:  (N, d) log *inverse* scales s_i.
    rotations: (N,) angle in 2D, (N, 4) quaternion (r, x, y, z) in 3D.
    values:    (N, vdim) splatted coefficients v_i.
    alive:     (N,) bool — False for padding entries.
    """

    positions: torch.Tensor
    scalings: torch.Tensor
    rotations: torch.Tensor
    values: torch.Tensor
    alive: torch.Tensor

    # ---- basic properties ----

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def d(self) -> int:
        return self.positions.shape[1]

    @property
    def vdim(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def n_alive(self) -> int:
        return int(self.alive.sum())

    # ---- construction ----

    @staticmethod
    def create(positions, spec: FieldSpec,
               device="cuda") -> "GaussianMixture":
        """Initial state at the given centres: scalings =
        spec.initial_scaling, identity rotations, zero values."""
        positions = _f32(positions, device)
        n, d = positions.shape
        cap = _bucket(n)
        pos = torch.empty((cap, d), dtype=torch.float32, device=device)
        pos[:n] = positions
        # park padding at the padded-domain corner (values 0, alive False)
        pos[n:] = torch.tensor(spec.lo, dtype=torch.float32, device=device)
        scalings = torch.full((cap, d), spec.initial_scaling,
                              dtype=torch.float32, device=device)
        if d == 2:
            rotations = torch.zeros((cap,), dtype=torch.float32,
                                    device=device)
        else:
            rotations = torch.zeros((cap, 4), dtype=torch.float32,
                                    device=device)
            rotations[:, 0] = 1.0
        values = torch.zeros((cap, spec.vdim), dtype=torch.float32,
                             device=device)
        alive = torch.zeros((cap,), dtype=torch.bool, device=device)
        alive[:n] = True
        return GaussianMixture(pos, scalings, rotations, values, alive)

    @staticmethod
    def from_arrays(positions, scalings, rotations, values,
                    spec: FieldSpec, min_capacity: int = 0,
                    device="cuda") -> "GaussianMixture":
        """Wrap unpadded parameter arrays, re-padding to a bucket.
        ``min_capacity`` keeps a previous, larger bucket when N shrinks."""
        positions = _f32(positions, device)
        n, d = positions.shape
        cap = max(_bucket(n), min_capacity)

        def _pad(a):
            a = _f32(a, device)
            out = torch.zeros((cap,) + tuple(a.shape[1:]),
                              dtype=torch.float32, device=device)
            out[:n] = a
            return out

        pos = _pad(positions)
        pos[n:] = torch.tensor(spec.lo, dtype=torch.float32, device=device)
        rot = _pad(rotations)
        if d == 3:
            rot[n:, 0] = 1.0   # padded rows: identity quaternions
        alive = torch.zeros((cap,), dtype=torch.bool, device=device)
        alive[:n] = True
        return GaussianMixture(pos, _pad(scalings), rot, _pad(values),
                               alive)

    def _reordered(self, order: torch.Tensor) -> "GaussianMixture":
        return GaussianMixture(self.positions[order], self.scalings[order],
                               self.rotations[order], self.values[order],
                               self.alive[order])

    def spatially_sorted(self) -> "GaussianMixture":
        """Reorder by the spatial key (``ops/spatial.sort_key``), dead rows
        last: coordinate 0, or under ``GF_SPATIAL_KEY=morton`` in 3D the
        Morton key over the live rows' own bounds. Order is semantically
        irrelevant, but the tile mask culls only where tiles are compact.
        The density replay re-sorts its checkpoints (``slab_sorted``)
        whatever this order is."""
        from gaussian_fluids_torch.ops import spatial
        if not spatial.morton_on(self.d):
            return self.x_sorted()
        live = self.alive[:, None]
        lo = torch.where(live, self.positions, float("inf")).amin(dim=0)
        hi = torch.where(live, self.positions, -float("inf")).amax(dim=0)
        # no live row: the JAX package's nan_to_num bounds (0, 1)
        lo = torch.where(torch.isinf(lo), 0.0, lo)
        hi = torch.where(torch.isinf(hi), 1.0, hi)
        key = spatial.morton_key(self.positions, lo, hi)
        key = torch.where(self.alive, key, 1 << 30)
        return self._reordered(torch.argsort(key, stable=True))

    def x_sorted(self) -> "GaussianMixture":
        """Reorder by coordinate 0, dead rows last, whatever the dimension
        and whatever order ``spatially_sorted`` takes: the JAX package's
        order for its banded kernel (``ops/field.value_banded``), where a
        narrow band covers. The density replay takes ``slab_sorted``."""
        key = torch.where(self.alive, self.positions[:, 0], float("inf"))
        return self._reordered(torch.argsort(key, stable=True))

    def slab_sorted(self, clamp: float) -> "GaussianMixture":
        """Reorder slab-major, dead rows last: by x-slab, then y-cell, then
        along the last axis (in 2D by x-slab, then y). Slabs and cells are
        twice the largest live support radius at ``clamp`` wide
        (``ops/field.support_radius``), measured from the smallest live
        coordinate. The density replay's order: a tile of consecutive rows
        is then a short run along z inside one (slab, cell) column, so the
        banded kernel, which walks only the tiles whose box meets a query
        tile's, skips most of an x-slab's tiles; an x-sorted tile spans
        the whole y-z plane. Host-free: every step stays on the device."""
        d = self.d
        r = math.sqrt(-2.0 * math.log(clamp)) \
            * torch.exp(-self.scalings.min(dim=-1).values)
        width = 2.0 * torch.where(self.alive, r, 0.0).amax()
        width = torch.where(width > 0, width, 1.0)
        live = self.alive[:, None]
        lo = torch.where(live, self.positions, float("inf")).amin(dim=0)
        cells = torch.floor((self.positions[:, :d - 1] - lo[:d - 1])
                            / width).long().clamp(0, (1 << 20) - 1)
        key = cells[:, 0]
        for k in range(1, d - 1):
            key = (key << 20) + cells[:, k]
        key = torch.where(self.alive, key, torch.iinfo(torch.int64).max)
        order = torch.argsort(self.positions[:, d - 1], stable=True)
        order = order[torch.argsort(key[order], stable=True)]
        return self._reordered(order)

    def compact(self) -> "GaussianMixture":
        """Drop padding."""
        keep = self.alive
        return GaussianMixture(self.positions[keep], self.scalings[keep],
                               self.rotations[keep], self.values[keep],
                               torch.ones((int(keep.sum()),),
                                          dtype=torch.bool,
                                          device=self.device))

    # ---- differentiable-parameter view ----

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def with_params(self, p: Dict[str, torch.Tensor]) -> "GaussianMixture":
        return GaussianMixture(p["positions"], p["scalings"],
                               p["rotations"], p["values"], self.alive)

    # ---- covariance ----

    def precisions(self) -> torch.Tensor:
        """Sigma^{-1} per Gaussian, (N, d, d)."""
        return precision_matrix(self.scalings, self.rotations, self.d)

    def to_param_dict(self) -> Dict[str, np.ndarray]:
        m = self.compact()
        return {k: getattr(m, k).detach().cpu().numpy() for k in PARAM_KEYS}

    def min_scaling(self) -> torch.Tensor:
        """min over alive entries (drives the dynamic search radius)."""
        return torch.where(self.alive[:, None], self.scalings,
                           float("inf")).min()


def mixture_of(params, alive) -> GaussianMixture:
    """Mixture view over a param dict + alive mask."""
    return GaussianMixture(params["positions"], params["scalings"],
                           params["rotations"], params["values"], alive)


def from_numpy_params(params: Dict[str, np.ndarray], alive: np.ndarray,
                      device="cuda") -> GaussianMixture:
    """The port's mixture over padded parameter arrays taken from the JAX
    package (``np.asarray`` of its ``mix.params()`` and ``mix.alive``), so
    both packages compute on the same state."""
    t = {k: torch.as_tensor(np.array(params[k], np.float32), device=device)
         for k in PARAM_KEYS}
    return mixture_of(t, torch.as_tensor(np.array(alive, bool),
                                         device=device))
