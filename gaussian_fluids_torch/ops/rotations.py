"""Rotation / covariance reparameterisation, the 2D half of the reference's
``ops/rotations.py``.

The mixture stores log *inverse* scales ``s`` and a rotation angle; the
inverse covariance is ``Sigma^{-1} = R diag(exp(2 s)) R^T``. Everything is
elementwise or small-matrix math batched over the leading axis, so torch
autograd differentiates it.
"""

from __future__ import annotations

import torch


def rotation_matrix_2d(angle: torch.Tensor) -> torch.Tensor:
    """(N,) angle -> (N, 2, 2) rotation matrices."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _check_2d(d: int):
    if d != 2:
        raise NotImplementedError(
            f"d={d}: only the 2D rotations are ported so far")


def precision_matrix(scalings: torch.Tensor, rotations: torch.Tensor,
                     d: int) -> torch.Tensor:
    """Inverse covariance Sigma^{-1} = R diag(e^{2s}) R^T, shape (N, d, d)."""
    _check_2d(d)
    R = rotation_matrix_2d(rotations)
    e2s = torch.exp(2.0 * scalings)
    return torch.einsum("nik,nk,njk->nij", R, e2s, R)


def packed_precision_entries(scalings: torch.Tensor, rotations: torch.Tensor,
                             d: int) -> torch.Tensor:
    """(N, 3) upper-triangle entries of Sigma^{-1} in closed form,
    diagonal first then the off-diagonal: [P00, P11, P01] — the packing
    the centered kernels read."""
    _check_2d(d)
    e = torch.exp(2.0 * scalings)
    c, s = torch.cos(rotations), torch.sin(rotations)
    a, b = e[..., 0], e[..., 1]
    return torch.stack([c * c * a + s * s * b,
                        s * s * a + c * c * b,
                        c * s * (a - b)], dim=-1)
