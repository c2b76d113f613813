"""Covector advection in 2D: move the Gaussian centres by RK4 through the
field's own velocity and drop those that leave the padded domain (N
shrinks; the capacity is kept)."""

from __future__ import annotations

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops.advect import rk4_advect


@torch.no_grad()
def advect_covector_field_2d(mix: GaussianMixture, spec: FieldSpec,
                             dt: float) -> GaussianMixture:
    new_pos = rk4_advect(mix, spec, mix.positions, dt)
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=mix.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=mix.device)
    valid = mix.alive & ((new_pos >= lo) & (new_pos <= hi)).all(dim=-1)
    return GaussianMixture.from_arrays(
        new_pos[valid], mix.scalings[valid], mix.rotations[valid],
        mix.values[valid], spec, min_capacity=mix.capacity,
        device=mix.device).spatially_sorted()
