"""Advected covector-field targets.

2D: backtrace x through the old velocity by -dt with RK4; the target
vorticity at x is curl u_old at the backtraced point, zeroed where the
backtrace leaves the advance domain (2D vorticity is materially
conserved); under ``profiling.counting()`` the counter
``covector_outside`` takes those zeroed points against the batch. The
projection's data loss is evaluated at the ORIGINAL sample positions, as
in the reference.

``advected_vorticity_2d_rk1`` is the reference's one-step backtrace,
kept as in the JAX package; no solver path calls it.

3D: the RK4 backtrace carries the deformation gradient dpsi of the flow
map; the vorticity is pulled back through it, omega = (dpsi)^{-1} omega_b,
and the helicity target is hel = v_b . omega_b.

Under ``GF_FUSED_RK4=1`` (read at call time) the 2D target on the card
takes the fused RK4 kernel: the backtrace and the endpoint's Jacobian in
one launch, each stage culled at its own positions, in place of five
tile-culled field evaluations. The default is the staged path, as in the
JAX package.
"""

from __future__ import annotations

import os

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.ops.advect import (rk4_deformation_stages,
                                              rk4_pos_stages)
from gaussian_fluids_torch.solver import losses
from gaussian_fluids_torch.utils import profiling


def _finish_2d(bk_x, dv, adv_lo, adv_hi) -> torch.Tensor:
    """Curl at the backtraced points, zeroed outside [adv_lo, adv_hi]."""
    vor = losses.curl2d(dv)
    inside = ((bk_x >= adv_lo) & (bk_x <= adv_hi)).all(dim=-1)
    if profiling.counters_on():
        profiling.count("covector_outside", ~inside, inside.shape[0])
    return torch.where(inside, vor, torch.zeros_like(vor))


@torch.no_grad()
def advected_vorticity_2d(vel_mix: GaussianMixture, spec: FieldSpec,
                          x: torch.Tensor, dt, adv_lo, adv_hi,
                          presorted: bool = False) -> torch.Tensor:
    """Target vorticity at x, (B,); adv_lo/adv_hi are the scaled
    advance-domain bounds as (2,) tensors."""
    if field._use_kernel(x) and os.environ.get("GF_FUSED_RK4", "0") == "1":
        bk_x, _, dv = field.rk4_valjac_fused(vel_mix, spec, x, -dt)
        return _finish_2d(bk_x, dv, adv_lo, adv_hi)
    bk_x = rk4_pos_stages(
        lambda p: field.value(vel_mix, spec, p, presorted=presorted,
                              need_dx=False), x, -dt)
    _, dv = field.value_and_jac(vel_mix, spec, bk_x, presorted=presorted,
                                need_dx=False)
    return _finish_2d(bk_x, dv, adv_lo, adv_hi)


@torch.no_grad()
def advected_vorticity_2d_rk1(vel_mix: GaussianMixture, spec: FieldSpec,
                              x: torch.Tensor, dt, adv_lo,
                              adv_hi) -> torch.Tensor:
    """The reference's alternative "rk1-backtrace" scheme, which no run
    takes by default: the one-step backtrace x - u(x) dt, then the
    curl there, as ``advected_vorticity_2d``."""
    v = field.value(vel_mix, spec, x, need_dx=False)
    bk_x = x - v * dt
    _, dv = field.value_and_jac(vel_mix, spec, bk_x)
    return _finish_2d(bk_x, dv, adv_lo, adv_hi)


def covector_targets_3d_from(f, x: torch.Tensor, dt):
    """(vor (B, 3), hel (B,)): the RK4 deformation backtrace through
    ``f(points) -> (velocities, jacobians)``, then the vorticity pullback
    (a batched 3x3 solve) and the helicity."""
    _, dpsi, pb_v, pb_dv = rk4_deformation_stages(f, x, -dt)
    pb_vor = losses.curl3d(pb_dv)
    hel = (pb_v * pb_vor).sum(-1)
    vor = torch.linalg.solve(dpsi, pb_vor[..., None])[..., 0]
    return vor, hel


@torch.no_grad()
def advected_vorticity_3d(vel_mix: GaussianMixture, spec: FieldSpec,
                          x: torch.Tensor, dt, presorted: bool = False):
    """(vor (B, 3), hel (B,)) at x through the old field ``vel_mix``."""
    return covector_targets_3d_from(
        lambda p: field.value_and_jac(vel_mix, spec, p, presorted=presorted,
                                      need_dx=False), x, dt)
