"""Loss functions, the port of the JAX package's ``solver/losses.py``.

Data terms are means over the query batch; regularizers are masked means
over the alive Gaussians. Per-Gaussian freezing detaches frozen rows of
the parameters before the field evaluation.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

ANISO_RATIO = 1.5


def freeze_params(params: Params, stop_mask: torch.Tensor) -> Params:
    """Rows where ``stop_mask`` is True receive no gradient."""
    def f(p):
        m = stop_mask.reshape((-1,) + (1,) * (p.dim() - 1))
        return torch.where(m, p.detach(), p)
    return {k: f(v) for k, v in params.items()}


# ---- data terms ----

def l1(a, b):
    return (a - b).abs().mean()


def value_loss(val, ref_val):
    return l1(val, ref_val)


def grad_loss(jac, ref_jac):
    return l1(jac, ref_jac)


def curl2d(jac):
    return jac[:, 1, 0] - jac[:, 0, 1]


def curl3d(jac):
    return torch.stack([jac[:, 2, 1] - jac[:, 1, 2],
                        jac[:, 0, 2] - jac[:, 2, 0],
                        jac[:, 1, 0] - jac[:, 0, 1]], dim=-1)


def divergence(jac):
    return jac.diagonal(dim1=-2, dim2=-1).sum(-1)


def vorticity_loss_2d(jac, ref_vor):
    """mean |curl u - ref|."""
    return (curl2d(jac) - ref_vor).abs().mean()


def vorticity_loss_3d(jac, ref_vor):
    """mean |curl u - ref| over (Q, 3)."""
    return (curl3d(jac) - ref_vor).abs().mean()


def helicity_loss(val, jac, ref_hel):
    """mean |u . curl u - ref_hel|."""
    hel = (val * curl3d(jac)).sum(-1)
    return (hel - ref_hel).abs().mean()


def divergence_loss(jac):
    """mean (div u)^2."""
    return (divergence(jac) ** 2).mean()


def boundary_dirichlet_loss(val, ref_val):
    return l1(val, ref_val)


def boundary_flux_loss(val, normals, normal_ref):
    """L1 of the normal flux against its target."""
    return ((val * normals).sum(-1) - normal_ref).abs().mean()


def boundary_freeslip_loss(val, normals):
    """3D free-slip: mean |u . n|."""
    return (val * normals).sum(-1).abs().mean()


# ---- regularizers over Gaussian parameters ----

def _masked_mean(x, mask):
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / denom


def aniso_loss(scalings, mask):
    """mean(max(ratio, r0) - r0), ratio = exp(s_max - s_min), over mask."""
    ratio = torch.exp(scalings.amax(-1) - scalings.amin(-1))
    per = ratio.clamp(min=ANISO_RATIO) - ANISO_RATIO
    return _masked_mean(per, mask)


def volume_loss(scalings, alive, detach_mask=None):
    """mean((vol/mean(vol) - 1)^2), vol = exp(-sum s); rows in
    ``detach_mask`` enter without gradient."""
    s = scalings
    if detach_mask is not None:
        s = torch.where(detach_mask[:, None], scalings.detach(), scalings)
    vol = torch.exp(-s.sum(-1))
    mean_vol = _masked_mean(vol, alive)
    return _masked_mean((vol / mean_vol - 1.0) ** 2, alive)


def delta_pos_loss(positions, positions_org, alive):
    """mse(positions, positions_org) over the alive rows."""
    per = ((positions - positions_org) ** 2).mean(-1)
    return _masked_mean(per, alive)


def value_reg_loss(values, alive):
    """mean |values| over the alive rows."""
    return _masked_mean(values.abs().mean(-1), alive)


# ---- PCGrad conflict-free gradient combination ----

def pcgrad_combine(g1: Params, g2: Params) -> Params:
    """Per-group conflict projection then sum: if <g1, g2> < 0, project
    each out of the other's original direction."""
    out = {}
    for k in g1:
        a, b = g1[k], g2[k]
        dot = (a * b).sum()
        na = a / torch.linalg.vector_norm(a).clamp(min=1e-30)
        nb = b / torch.linalg.vector_norm(b).clamp(min=1e-30)
        a2 = a - (a * nb).sum() * nb
        b2 = b - (b * na).sum() * na
        out[k] = torch.where(dot < 0.0, a2 + b2, a + b)
    return out
