"""The collectives of the sharded epochs, the JAX package's ``_psum_g``,
``_pmean_b``, ``_global_masked_mean``, ``_aniso_vol_sharded``,
``_clone_reg_sharded`` and ``_pcgrad_sharded`` (``parallel/sharding.py``)
over the mesh's process groups.

Every field evaluation is a sum over Gaussians, so a rank's partial
(val, jac) over its Gaussian shard is summed over its gauss group
(:func:`psum_g`); the sum, and every loss computed from it, is then the
same on every rank of the group. A gradient arriving at such a value is
therefore already the global one on each rank, and :func:`psum_g`'s
backward passes it through unchanged. (``torch.distributed.nn``'s
all-reduce sums the cotangents over the group in its backward: G times
the gradient.) Where a summed value meets per-rank values again (the mean
volume inside the volume loss), its gradient arrives in per-rank parts:
:func:`vary_g` marks that seam and sums them in its backward. Together
they give every rank the gradient of its own shard's parameters.

Only ``all_reduce`` and ``broadcast`` are used: gathering a sharded tensor
is a sum of zero-padded shards (exact: each entry adds zeros), so the
collectives run alike on NCCL and on gloo with CUDA tensors.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from gaussian_fluids_torch.solver.losses import ANISO_RATIO


def _all_reduce(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if n > 1:
        if not t.is_contiguous():   # NCCL refuses it; gloo would not say
            raise ValueError("all-reduce of a non-contiguous tensor")
        dist.all_reduce(t, group=group)
    return t


def _dense_copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _SumOverGauss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(_dense_copy(x), mesh.gauss_group, mesh.n_gauss)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _VaryOverGauss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return _all_reduce(_dense_copy(grad), m.gauss_group,
                           m.n_gauss), None


def psum_g(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the gauss group; the backward is the identity."""
    return _SumOverGauss.apply(x, mesh) if mesh.n_gauss > 1 else x


def vary_g(x: torch.Tensor, mesh) -> torch.Tensor:
    """The identity; the backward sums the gradient over the gauss group.
    For a value that is the same on every gauss rank where it enters a
    computation on the rank's own rows."""
    return _VaryOverGauss.apply(x, mesh) if mesh.n_gauss > 1 else x


def psum_g_many(*ts: torch.Tensor, mesh) -> List[torch.Tensor]:
    """:func:`psum_g` of several tensors in one all-reduce."""
    if mesh.n_gauss == 1:
        return list(ts)
    flat = psum_g(torch.cat([t.reshape(-1) for t in ts]), mesh)
    return [p.reshape(t.shape) for p, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def pmean_b(ts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The mean over the batch group of each tensor, in one all-reduce
    (no gradient): data terms are means over a rank's batch rows, so the
    global batch's gradient is the mean of the rows' gradients."""
    if mesh.n_batch == 1:
        return list(ts)
    flat = torch.cat([t.detach().reshape(-1) for t in ts])
    _all_reduce(flat, mesh.batch_group, mesh.n_batch)
    flat = flat / mesh.n_batch
    return [p.reshape(t.shape) for p, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def pmean_b_dict(tree: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    return dict(zip(tree, pmean_b(list(tree.values()), mesh)))


def global_masked_mean(x: torch.Tensor, mask: torch.Tensor, mesh):
    """The masked mean over the whole gauss-sharded axis, from the
    (sum, count) pairs summed over the gauss group."""
    sc = psum_g(torch.stack([torch.where(mask, x, torch.zeros_like(x)).sum(),
                             mask.sum().to(x.dtype)]), mesh)
    return sc[0] / sc[1].clamp(min=1)


def regularizers(scalings: torch.Tensor, alive: torch.Tensor, mesh,
                 stop=None):
    """(aniso, volume) losses over the whole mixture: the port's
    ``losses.aniso_loss`` / ``volume_loss`` with global masked means. With
    ``stop`` (the clone re-fit's freeze mask), the anisotropy runs over
    the unfrozen alive rows and the frozen rows' volumes enter without
    gradient, as ``_clone_reg_sharded``."""
    ratio = torch.exp(scalings.amax(-1) - scalings.amin(-1))
    per = ratio.clamp(min=ANISO_RATIO) - ANISO_RATIO
    l_aniso = global_masked_mean(per, alive if stop is None
                                 else alive & ~stop, mesh)
    s = scalings if stop is None else \
        torch.where(stop[:, None], scalings.detach(), scalings)
    vol = torch.exp(-s.sum(-1))
    mean_vol = vary_g(global_masked_mean(vol, alive, mesh), mesh)
    l_vol = global_masked_mean((vol / mean_vol - 1.0) ** 2, alive, mesh)
    return l_aniso, l_vol


@torch.no_grad()
def pcgrad_sharded(g1: Dict[str, torch.Tensor], g2: Dict[str, torch.Tensor],
                   mesh) -> Dict[str, torch.Tensor]:
    """``losses.pcgrad_combine`` with each group's dots and norms summed
    over the gauss group (the batch ranks hold the same averaged
    gradients)."""
    keys = list(g1)
    dots = psum_g(torch.stack([torch.stack([
        (g1[k] * g2[k]).sum(), (g1[k] * g1[k]).sum(), (g2[k] * g2[k]).sum()])
        for k in keys]), mesh)
    na = {k: g1[k] / dots[i, 1].sqrt().clamp(min=1e-30)
          for i, k in enumerate(keys)}
    nb = {k: g2[k] / dots[i, 2].sqrt().clamp(min=1e-30)
          for i, k in enumerate(keys)}
    proj = psum_g(torch.stack([torch.stack([(g1[k] * nb[k]).sum(),
                                            (g2[k] * na[k]).sum()])
                               for k in keys]), mesh)
    out = {}
    for i, k in enumerate(keys):
        a, b = g1[k], g2[k]
        a2 = a - proj[i, 0] * nb[k]
        b2 = b - proj[i, 1] * na[k]
        out[k] = torch.where(dots[i, 0] < 0.0, a2 + b2, a + b)
    return out


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor from the gauss group's contiguous row shards: the
    sum of the shards, each zero-padded to its place."""
    if mesh.n_gauss == 1:
        return t
    k = t.shape[0]
    kind = t.dtype
    src = t.to(torch.int32) if kind == torch.bool else t
    buf = src.new_zeros((mesh.n_gauss * k,) + tuple(t.shape[1:]))
    buf[mesh.g * k:(mesh.g + 1) * k] = src
    _all_reduce(buf, mesh.gauss_group, mesh.n_gauss)
    return buf.to(kind) if kind == torch.bool else buf


@torch.no_grad()
def gather_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """(n_batch, *t.shape): every batch rank's ``t`` (of one shape), by
    rank along the batch axis, on every rank."""
    buf = t.new_zeros((mesh.n_batch,) + tuple(t.shape))
    buf[mesh.b] = t
    return _all_reduce(buf, mesh.batch_group, mesh.n_batch)


@torch.no_grad()
def broadcast(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (in place; returned)."""
    if mesh.size == 1:
        return t
    if not t.is_contiguous():
        raise ValueError("broadcast of a non-contiguous tensor")
    kind = t.dtype
    buf = t.to(torch.int32) if kind == torch.bool else t
    dist.broadcast(buf, src=src)
    if kind == torch.bool:
        t.copy_(buf.to(torch.bool))
    return t
