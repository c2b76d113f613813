"""Advected covector-field target for 2D: backtrace x through the old
velocity by -dt with RK4; the target vorticity at x is curl u_old at the
backtraced point, zeroed where the backtrace leaves the advance domain
(2D vorticity is materially conserved). The projection's data loss is
evaluated at the ORIGINAL sample positions, as in the reference.
"""

from __future__ import annotations

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.ops.advect import rk4_pos_stages
from gaussian_fluids_torch.solver import losses


def _finish_2d(bk_x, dv, adv_lo, adv_hi) -> torch.Tensor:
    """Curl at the backtraced points, zeroed outside [adv_lo, adv_hi]."""
    vor = losses.curl2d(dv)
    inside = ((bk_x >= adv_lo) & (bk_x <= adv_hi)).all(dim=-1)
    return torch.where(inside, vor, torch.zeros_like(vor))


@torch.no_grad()
def advected_vorticity_2d(vel_mix: GaussianMixture, spec: FieldSpec,
                          x: torch.Tensor, dt, adv_lo, adv_hi,
                          presorted: bool = False) -> torch.Tensor:
    """Target vorticity at x, (B,); adv_lo/adv_hi are the scaled
    advance-domain bounds as (2,) tensors."""
    bk_x = rk4_pos_stages(
        lambda p: field.value(vel_mix, spec, p, presorted=presorted), x, -dt)
    _, dv = field.value_and_jac(vel_mix, spec, bk_x, presorted=presorted)
    return _finish_2d(bk_x, dv, adv_lo, adv_hi)
