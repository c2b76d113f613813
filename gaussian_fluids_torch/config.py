"""Static field configuration.

The reference stores this state on the ``GaussianSplattingFast`` object
(reference 2D/GSR.py:173-192, 3D/GSR.py:156-177): clamp threshold, padded
domain bounds, ``min_grid_scale`` and the derived static grid dimensions.
Here it is an immutable, hashable spec; the solver caches per-spec
runners on it. Same fields and defaults as the JAX package's FieldSpec,
so a spec built by either package describes the same field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static (compile-time) description of a Gaussian splatting field.

    Attributes:
      d: spatial dimension (2 or 3).
      vdim: dimension of the splatted value (1 for scalars, d for velocity).
      clamp_threshold: compact-support cutoff ``c``; a Gaussian contributes
        ``v * (g - c)`` iff ``g >= c`` (reference 2D/GSR.py:279-281).
      min_grid_scale: base uniform-grid cell size (reference 2D/GSR.py:177,
        3D/GSR.py:160).
      lo, hi: *padded* domain bounds, i.e. already extended by one
        ``min_grid_scale`` on each side (reference 2D/GSR.py:179).
    """

    d: int
    vdim: int
    clamp_threshold: float
    min_grid_scale: float
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]

    # ---- constructors ----

    @staticmethod
    def create(lo, hi, n_gaussians: int, d: int, vdim: int,
               clamp_threshold: float | None = None,
               min_grid_scale: float | None = None) -> "FieldSpec":
        """Build a spec from *unpadded* domain bounds.

        Mirrors the reference constructor defaults:
          2D: min_grid_scale = 3 * sqrt(area / N), clamp 1e-3
              (reference 2D/GSR.py:173,177)
          3D: min_grid_scale = 2 * cbrt(volume / N), clamp 5e-3
              (reference 3D/GSR.py:156,160)
        """
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        assert len(lo) == d and len(hi) == d
        if clamp_threshold is None:
            clamp_threshold = 1e-3 if d == 2 else 5e-3
        if min_grid_scale is None:
            vol = 1.0
            for a, b in zip(lo, hi):
                vol *= (b - a)
            if d == 2:
                min_grid_scale = math.sqrt(vol / n_gaussians) * 3.0
            else:
                min_grid_scale = (vol / n_gaussians) ** (1.0 / 3.0) * 2.0
        pad = min_grid_scale
        return FieldSpec(
            d=d, vdim=vdim,
            clamp_threshold=float(clamp_threshold),
            min_grid_scale=float(min_grid_scale),
            lo=tuple(a - pad for a in lo),
            hi=tuple(b + pad for b in hi),
        )

    # ---- derived quantities ----

    @property
    def grid_size(self) -> Tuple[int, ...]:
        """Static uniform-grid dimensions (reference 2D/GSR.py:188)."""
        return tuple(
            int((b - a) // self.min_grid_scale) + 1
            for a, b in zip(self.lo, self.hi)
        )

    @property
    def initial_scaling(self) -> float:
        """Initial value of every log-inverse-scale entry so each Gaussian's
        support radius at the clamp threshold equals ``min_grid_scale``
        (reference 2D/GSR.py:181, 3D/GSR.py:166)."""
        return 0.5 * math.log(-2.0 * math.log(self.clamp_threshold)) \
            - math.log(self.min_grid_scale)

    def max_reach(self, min_scaling: float) -> float:
        """Dynamic search radius: support radius of the largest Gaussian,
        floored at ``min_grid_scale`` (reference 2D/GSR.py:226)."""
        if self.clamp_threshold <= 0.0:
            return max(b - a for a, b in zip(self.lo, self.hi))
        r = math.sqrt(-2.0 * math.log(self.clamp_threshold)) \
            * math.exp(-min_scaling)
        return max(r, self.min_grid_scale)

    def replace(self, **kw) -> "FieldSpec":
        return dataclasses.replace(self, **kw)
