"""Covector advection: move the Gaussian centres through the flow.

2D: RK4 (or, as an option, the reference's one-step "rk1-backtrace")
through the field's own velocity; Gaussians that leave the padded
domain are dropped (N shrinks; the capacity is kept).

3D: RK4 through the OLD velocity field, clipped to the padded domain (N
unchanged); padded rows stay parked at the domain corner.
"""

from __future__ import annotations

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.ops.advect import rk4_advect


@torch.no_grad()
def advect_covector_field_2d(mix: GaussianMixture, spec: FieldSpec,
                             dt: float, advection_scheme: str = "rk4"
                             ) -> GaussianMixture:
    """``advection_scheme``: "rk4" (the default) or "rk1-backtrace", the
    reference's one forward Euler step x + u(x) dt."""
    if advection_scheme == "rk1-backtrace":
        new_pos = mix.positions + dt * field.value(mix, spec, mix.positions)
    elif advection_scheme == "rk4":
        new_pos = rk4_advect(mix, spec, mix.positions, dt)
    else:
        raise NotImplementedError(advection_scheme)
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=mix.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=mix.device)
    valid = mix.alive & ((new_pos >= lo) & (new_pos <= hi)).all(dim=-1)
    return GaussianMixture.from_arrays(
        new_pos[valid], mix.scalings[valid], mix.rotations[valid],
        mix.values[valid], spec, min_capacity=mix.capacity,
        device=mix.device).spatially_sorted()


@torch.no_grad()
def advect_covector_field_3d(mix: GaussianMixture, vel_mix: GaussianMixture,
                             spec: FieldSpec, dt: float) -> GaussianMixture:
    new_pos = rk4_advect(vel_mix, spec, mix.positions, dt)
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=mix.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=mix.device)
    new_pos = torch.where(mix.alive[:, None],
                          torch.minimum(torch.maximum(new_pos, lo), hi), lo)
    # re-sort by coordinate 0 so the tile bounding boxes stay tight
    return GaussianMixture(new_pos, mix.scalings, mix.rotations, mix.values,
                           mix.alive).spatially_sorted()
