"""The density replay's semi-Lagrangian step over a (batch, gauss) mesh,
the JAX package's ``parallel/density.py``.

Grid nodes are independent, so each chunk of nodes splits over the batch
axis (contiguous rows: a chunk of the x-major grid stays sorted along x,
as the banded kernel wants its queries); the velocity at each RK4 stage
is a sum over Gaussians, so the mixture splits over the gauss axis with
one sum over the gauss group per stage. The old density is the same on
every rank (every node samples it at an arbitrary backtraced point).

Each rank's stages take the single-device replay's field path on its
shard (``simulate3d._stage_velocity``): on the card the banded value
kernel (``gsr_banded.cu``, the TPU's ``_val_banded_kernel``), its band
suggested for the shard; a contiguous slice of the slab-major mixture is
slab-major itself. On the CPU, the dense field.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import interp
from gaussian_fluids_torch.ops.advect import rk4_pos_stages
from gaussian_fluids_torch.parallel.collectives import gather_batch, psum_g
from gaussian_fluids_torch.parallel.sharding import shard_mixture
from gaussian_fluids_torch.solver.simulate3d import (DENSITY_CHUNK,
                                                     _grid_chunks_device,
                                                     _stage_velocity,
                                                     _suggest_band)


def make_sharded_density_step(spec: FieldSpec, mesh, domain: tuple):
    """``step(shard, xc, density, dt, band)``: one semi-Lagrangian step of
    this rank's nodes ``xc`` (sorted along x) through the gauss-sharded
    velocity field (``shard``, this rank's slice; ``band`` the banded
    kernel's, None on the CPU): the RK4 backtrace with each stage's
    velocity summed over the gauss group, clamped to the domain, and the
    trilinear sample of the (whole) old density there."""
    lo = torch.tensor(domain[0::2], dtype=torch.float32, device=mesh.device)
    hi = torch.tensor(domain[1::2], dtype=torch.float32, device=mesh.device)

    @torch.no_grad()
    def step(shard: GaussianMixture, xc, density, dt, band):
        f = _stage_velocity(shard, spec, band)
        bk = rk4_pos_stages(lambda q: psum_g(f(q), mesh), xc, -dt)
        return interp.trilinear_interp(
            density, torch.minimum(torch.maximum(bk, lo), hi), domain)

    return step


@torch.no_grad()
def advected_density_sharded(density: torch.Tensor, mix: GaussianMixture,
                             spec: FieldSpec, domain, dt, grid_shape, mesh,
                             chunk: int = DENSITY_CHUNK,
                             band: Optional[int] = None) -> torch.Tensor:
    """The sharded ``advected_density``: one step of the (xn, yn, zn)
    density volume over the mesh, the whole volume on every rank. ``mix``
    is the global mixture, slab-major or x-sorted as the single-device
    replay wants it; each rank keeps its contiguous shard. Each grid chunk
    of ``chunk`` nodes (rounded down to a multiple of the batch axis)
    gives every batch rank its contiguous slice; on the CPU the chunk is
    bounded by the capacity as the single-device sweep bounds it. ``band``
    None suggests one for this rank's shard at its slice's size."""
    xn, yn, zn = grid_shape
    dev = mesh.device
    shard = shard_mixture(mix, mesh)
    if dev.type != "cuda":
        cap_chunk = max(4096, (1 << 29) // max(mix.capacity, 1))
        chunk = min(chunk, 1 << (cap_chunk.bit_length() - 1))
    chunk = max(mesh.n_batch, chunk - chunk % mesh.n_batch)
    rows = chunk // mesh.n_batch
    if dev.type == "cuda" and band is None:
        band = _suggest_band(shard, spec, dt, chunk=rows)
    step = make_sharded_density_step(spec, mesh, tuple(domain))
    xcs, n = _grid_chunks_device(tuple(domain), tuple(grid_shape), chunk,
                                 dev)
    density = density.to(dev)
    mine = torch.stack([step(shard, xc[mesh.b * rows:(mesh.b + 1) * rows],
                             density, dt, band) for xc in xcs])
    # (n_batch, chunks, rows) -> chunk-major node order
    vol = gather_batch(mine, mesh).transpose(0, 1).reshape(-1)
    return vol[:n].reshape(xn, yn, zn)
