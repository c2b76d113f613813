"""Checkpoint I/O in the reference's ``gaussian_velocity_{n}.pt`` format,
the same as the JAX package writes: a torch-pickled dict of the four
parameter tensors (alive rows only, on the CPU) plus ``clamp_threshold``,
``min_grid_scale`` and ``domain_range`` (padded bounds interleaved as
(x_min, x_max, y_min, y_max[, z_min, z_max])). Rotations are angles in 2D
and quaternions (r, x, y, z) in 3D. Either package loads the other's
``.pt`` files. Where the ``.pt`` is absent, ``load_checkpoint`` reads the
``gaussian_velocity_{n}.pt.npz`` sidecar that the JAX package writes in
its place when torch is not installed (the same keys, saved by numpy).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture


def _domain_range(spec: FieldSpec):
    out = []
    for a, b in zip(spec.lo, spec.hi):
        out.extend([float(a), float(b)])
    return tuple(out)


def save_checkpoint(path: str, mix: GaussianMixture, spec: FieldSpec) -> None:
    """Write-to-tmp + fsync + atomic rename, so an interrupted write never
    leaves a torn highest-numbered checkpoint for a resume to load."""
    payload = {k: torch.from_numpy(np.array(v, copy=True))
               for k, v in mix.to_param_dict().items()}
    payload |= {"clamp_threshold": spec.clamp_threshold,
                "min_grid_scale": spec.min_grid_scale,
                "domain_range": _domain_range(spec)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as fd:
        torch.save(payload, fd)
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def load_checkpoint(path: str,
                    device="cuda") -> Tuple[GaussianMixture, FieldSpec]:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        data = dict(np.load(path + ".npz"))
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)

    def get(k):
        v = data[k]
        v = v.detach().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, np.float32)

    positions = get("positions")
    d = positions.shape[1]
    values = get("values")
    dr = [float(v) for v in data["domain_range"]]
    spec = FieldSpec(d=d, vdim=values.shape[1],
                     clamp_threshold=float(data["clamp_threshold"]),
                     min_grid_scale=float(data["min_grid_scale"]),
                     lo=tuple(dr[2 * i] for i in range(d)),
                     hi=tuple(dr[2 * i + 1] for i in range(d)))
    # coordinate-0 sort: the tile mask starts with tight bounding boxes
    mix = GaussianMixture.from_arrays(positions, get("scalings"),
                                      get("rotations"), values, spec,
                                      device=device).spatially_sorted()
    return mix, spec
