"""The yardstick's fixed arithmetic: the H100's peaks, the operations a
(query, Gaussian) pair needs, a projection epoch's FLOPs, and the ring
density seed of the replay.

Copied from the program (``gaussian_fluids_torch/utils/roofline.py`` and
``gaussian_fluids_torch/ops/interp.py``) so that a change to the program
cannot move the benchmark's counts. Nothing here imports the program.

Operations are the math per pair, each multiply, add, select and exp one
operation, counted line by line from the field's pair arithmetic: they
describe the work the inputs need, whatever kernel does it. Bytes are
counted on need: each call's inputs read once, its outputs written once.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. The port's
# kernels run f32 on the CUDA cores, so f32 is the peak they are read
# against.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def tile_quantities_flops(d: int) -> int:
    """delta (d) + P delta (d (2d - 1)) + quad (2d) + exp (1) + clamp
    compare (1)."""
    return d + d * (2 * d - 1) + 2 * d + 2


def fwd_flops_per_pair(d: int, vdim: int, njac: int) -> int:
    """A pair of a forward: the tile quantities, the masked selects (3),
    the value contraction (2 vdim) and njac weighted contractions (2 + 2
    vdim each)."""
    return tile_quantities_flops(d) + 3 + 2 * vdim + njac * (2 + 2 * vdim)


def bwd_cotangent_flops(d: int, vdim: int) -> int:
    return 2 * vdim * d + 2 * vdim + 2 * d + 3 + 2 * d + 1


def dxj_flops(d: int) -> int:
    return d * (2 * d + 2)


def bwd_dx_flops_per_pair(d: int, vdim: int) -> int:
    return (tile_quantities_flops(d) + bwd_cotangent_flops(d, vdim)
            + dxj_flops(d) + d)


def bwd_dn_flops_per_pair(d: int, vdim: int) -> int:
    off = d * (d - 1) // 2
    return (tile_quantities_flops(d) + bwd_cotangent_flops(d, vdim)
            + 2 + 2 * vdim * (1 + d) + dxj_flops(d) + d
            + 4 * d + 6 * off + 1)


# Two loss heads sharing one recompute in the dual-cotangent backward.
DUAL_FACTOR = 1.8


def projection_epoch_flops(d: int, b: int, n: int, density: float,
                           rk4_evals: int = 5) -> float:
    """FLOPs of one projection epoch on the pairs the inputs need
    (``density * b * n``): ``rk4_evals`` value and Jacobian forwards of
    the covector target, the heads' forward and dual backward, a
    value-only boundary forward and its backward. Adam and the
    regularizers, O(n), are left out."""
    vdim = d
    f_fwd = fwd_flops_per_pair(d, vdim, d)
    f_dual = DUAL_FACTOR * (bwd_dx_flops_per_pair(d, vdim)
                            + bwd_dn_flops_per_pair(d, vdim))
    f_bnd = (fwd_flops_per_pair(d, vdim, 0)
             + 0.5 * bwd_dn_flops_per_pair(d, vdim))
    return density * b * n * (rk4_evals * f_fwd + f_fwd + f_dual + f_bnd)


def replay_step_flops(nodes: int, n: int, density: float,
                      stages: int = 4) -> float:
    """FLOPs of one density step: ``stages`` value-only evaluations of
    the velocity at every node on the pairs in the support, and the
    trilinear sample (8 corners, 4 operations each, per node)."""
    return (stages * density * nodes * n * fwd_flops_per_pair(3, 3, 0)
            + 32.0 * nodes)


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of ``ops`` at the f32 peak and ``nbytes`` at HBM's."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def seed_ring_density(shape, domain, center, normal, radius, thickness,
                      device="cpu") -> torch.Tensor:
    """A solid-torus indicator density on the node-centred grid (the
    reference's ``ti_set_ring``, 3D/advance_density.py:13-21)."""
    dev = torch.device(device)
    axes = [torch.as_tensor(np.linspace(domain[2 * i], domain[2 * i + 1], n,
                                        dtype=np.float32), device=dev)
            for i, n in enumerate(shape)]
    pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    c = torch.tensor(center, dtype=torch.float32, device=dev)
    nv = torch.tensor(normal, dtype=torch.float32, device=dev)
    n = nv / torch.linalg.norm(nv)
    rel = pos - c
    proj = pos - (rel @ n)[..., None] * n
    del rel
    rad_vec = proj - c
    del proj
    rad_len = torch.linalg.norm(rad_vec, dim=-1)
    outside_inner = rad_len >= float(radius) - float(thickness)
    safe = torch.clamp(rad_len, min=1e-12)[..., None]
    nearest = c + rad_vec / safe * float(radius)
    del rad_vec, safe
    close = torch.linalg.norm(pos - nearest, dim=-1) <= float(thickness)
    return (outside_inner & close).to(torch.float32)

