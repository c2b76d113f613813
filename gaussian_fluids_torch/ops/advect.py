"""RK4 point advection through the Gaussian velocity field, optionally
with the deformation gradient of the flow map:

    dphi_k = I + dt * c_k * (dv_k @ dphi_{k-1})

Built on the batched field evaluation (value-only kernel mode where the
stages need only the velocity). No gradients flow through advection.
"""

from __future__ import annotations

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field


def rk4_deformation_stages(f, x: torch.Tensor, dt):
    """RK4 with the deformation-gradient tangent chain through
    ``f(points) -> (velocities, jacobians)``. Returns
    (phi, dphi, v_phi, dv_phi)."""
    v, dv = f(x)
    phi1 = x + dt * 0.5 * v
    v1, dv1 = f(phi1)
    phi2 = x + dt * 0.5 * v1
    v2, dv2 = f(phi2)
    phi3 = x + dt * v2
    v3, dv3 = f(phi3)
    phi = x + dt / 6.0 * (v + 2.0 * v1 + 2.0 * v2 + v3)

    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[None]
    dphi1 = eye + dt * 0.5 * dv
    dv1x = dv1 @ dphi1
    dphi2 = eye + dt * 0.5 * dv1x
    dv2x = dv2 @ dphi2
    dphi3 = eye + dt * dv2x
    dphi = eye + dt / 6.0 * (dv + 2.0 * dv1x + 2.0 * dv2x + dv3 @ dphi3)
    v_phi, dv_phi = f(phi)
    return phi, dphi, v_phi, dv_phi


def rk4_pos_stages(f, x: torch.Tensor, dt) -> torch.Tensor:
    """Classic position-only RK4 through ``f(points) -> velocities``."""
    v = f(x)
    v1 = f(x + dt * 0.5 * v)
    v2 = f(x + dt * 0.5 * v1)
    v3 = f(x + dt * v2)
    return x + dt / 6.0 * (v + 2.0 * v1 + 2.0 * v2 + v3)


@torch.no_grad()
def rk4_advect_pos(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                   dt, presorted: bool = False) -> torch.Tensor:
    """Position-only RK4: the stages skip the Jacobian columns."""
    return rk4_pos_stages(
        lambda p: field.value(mix, spec, p, presorted=presorted,
                              need_dx=False), x, dt)


@torch.no_grad()
def rk4_advect(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor, dt,
               with_deformation: bool = False, presorted: bool = False):
    """phi (B, d), or (phi, dphi, v_phi, dv_phi) with ``with_deformation``."""
    if not with_deformation:
        return rk4_advect_pos(mix, spec, x, dt, presorted=presorted)
    return rk4_deformation_stages(
        lambda p: field.value_and_jac(mix, spec, p, presorted=presorted),
        x, dt)
