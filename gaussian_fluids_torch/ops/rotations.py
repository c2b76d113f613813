"""Rotation / covariance reparameterisation, the port of the JAX package's
``ops/rotations.py``.

The mixture stores log *inverse* scales ``s`` and a rotation (an angle in
2D, a quaternion (r, x, y, z) in 3D, normalised in-function); the inverse
covariance is ``Sigma^{-1} = R diag(exp(2 s)) R^T``. Everything is
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


def _quat_rows(quat: torch.Tensor):
    """The three rows of the rotation of the normalised quaternion, each a
    tuple of three (N,) tensors."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )


def rotation_matrix_3d(quat: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternion (r, x, y, z) -> (N, 3, 3), normalising first."""
    return torch.stack([torch.stack(row, dim=-1)
                        for row in _quat_rows(quat)], dim=-2)


def rotation_matrix(rotations: torch.Tensor, d: int) -> torch.Tensor:
    if d == 2:
        return rotation_matrix_2d(rotations)
    return rotation_matrix_3d(rotations)


def precision_matrix(scalings: torch.Tensor, rotations: torch.Tensor,
                     d: int) -> torch.Tensor:
    """Inverse covariance Sigma^{-1} = R diag(e^{2s}) R^T, shape (N, d, d)."""
    R = rotation_matrix(rotations, d)
    e2s = torch.exp(2.0 * scalings)
    return torch.einsum("nik,nk,njk->nij", R, e2s, R)


def packed_precision_entries(scalings: torch.Tensor, rotations: torch.Tensor,
                             d: int) -> torch.Tensor:
    """(N, d(d+1)/2) upper-triangle entries of Sigma^{-1} in closed form,
    diagonal first, then the off-diagonals (i < j) in lexicographic order:
    [P00, P11, P01] in 2D, [P00, P11, P22, P01, P02, P12] in 3D — the
    packing the centered kernels read."""
    e = torch.exp(2.0 * scalings)
    if d == 2:
        c, s = torch.cos(rotations), torch.sin(rotations)
        a, b = e[..., 0], e[..., 1]
        return torch.stack([c * c * a + s * s * b,
                            s * s * a + c * c * b,
                            c * s * (a - b)], dim=-1)
    rows = _quat_rows(rotations)
    e0, e1, e2 = e[..., 0], e[..., 1], e[..., 2]

    def pij(i, j):
        ri, rj = rows[i], rows[j]
        return ri[0] * rj[0] * e0 + ri[1] * rj[1] * e1 + ri[2] * rj[2] * e2

    return torch.stack([pij(0, 0), pij(1, 1), pij(2, 2),
                        pij(0, 1), pij(0, 2), pij(1, 2)], dim=-1)
