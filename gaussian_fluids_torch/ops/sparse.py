"""Sparse cell-list field evaluation: the reference's uniform-grid culling
as a flat list of (query, Gaussian) pairs, the JAX package's
``ops/sparse.py`` in PyTorch. Opt-in only (``GF_FIELD_BACKEND=sparse``):
the exact oracle of the reference's culling, never on the default path.

    cells     Gaussians counting-sorted by cell id (bincount + cumsum +
              stable argsort, no atomics);
    pairs     one slot per (query, candidate) pair of the query's
              3^d-neighbourhood, ordered by query;
    eval      the per-pair quad form from the packed precision entries,
              exp, clamp mask, contributions summed over the sorted
              per-query segments (``torch.segment_reduce``);
    backward  the pair gathers of the Gaussians' parameters go back
              through ``_GatherRows``, which sums each Gaussian's pair
              cotangents over the pairs sorted by Gaussian: no
              scatter-add, whose CUDA version adds with atomics, so two
              calls give bitwise equal values and gradients.

Exactness: a Gaussian contributes iff g >= clamp, which implies
|x - mu| <= ``field.support_radius``. Where every in-domain Gaussian's
radius fits one cell, the neighbourhood holds every contributor and the
sum equals the dense masked sum up to the order of the additions. Both
guards (the radius fit, and the pair list within ``pair_capacity``) are
read on the host, one synchronisation a call; a call that fails one falls
back as a whole, as the JAX package's ``lax.cond`` does: to the centered
path on the card (the centered kernels), to the chunked dense sweep on the
CPU. ``fallbacks()`` counts those calls. The list is built at its exact
length, and only once its length is known to be within the capacity (the
JAX package pads it to the capacity, a static shape), so an overflowing
list never takes memory.

The grid has one pad-cell ring; queries up to one cell outside the domain
see their neighbours, farther ones clip into the (empty) pad ring. Plain
PyTorch: no kernel of its own.
"""

from __future__ import annotations

import itertools
import os
from typing import Tuple

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import (GaussianMixture,
                                                  mixture_of)
from gaussian_fluids_torch.ops import rotations as rotations_ops

_CELLS_ENV = "GF_SPARSE_CELLS"        # cells along the longest axis
_HEADROOM_ENV = "GF_SPARSE_HEADROOM"  # pair-capacity safety factor
_CHUNK_ENV = "GF_SPARSE_CHUNK"        # most queries a pair list serves
_DEFAULT_CHUNK = 16384
_DENSE_CHUNK = 4096                   # the CPU fallback's sweep chunk

_fallbacks = [0]


def fallbacks() -> int:
    """Calls that failed a guard and took the fallback since the last
    ``reset_fallbacks``."""
    return _fallbacks[0]


def reset_fallbacks() -> None:
    _fallbacks[0] = 0


def query_chunk() -> int:
    return int(os.environ.get(_CHUNK_ENV, str(_DEFAULT_CHUNK)))


def grid_dims(spec: FieldSpec) -> Tuple[Tuple[int, ...],
                                        Tuple[float, ...]]:
    """(cells per axis, cell size per axis), without the pad ring: about
    ``GF_SPARSE_CELLS`` (16) cells along the longest axis, cubic-ish
    cells elsewhere."""
    target = int(os.environ.get(_CELLS_ENV, "16"))
    ext = [hi - lo for lo, hi in zip(spec.lo, spec.hi)]
    h_target = max(ext) / target
    dims = tuple(max(1, int(e / h_target)) for e in ext)
    return dims, tuple(e / g for e, g in zip(ext, dims))


def pair_capacity(b: int, n: int, spec: FieldSpec) -> int:
    """The pair list's capacity: the expected pairs of uniform queries
    (3^d * B * N / cells) with headroom, rounded up to 256k."""
    dims, _ = grid_dims(spec)
    cells = 1
    for g in dims:
        cells *= g
    head = float(os.environ.get(_HEADROOM_ENV, "1.5"))
    est = (3 ** spec.d) * b * n / cells * head
    return max(262_144, int(-(-est // 262_144) * 262_144))


def _cell_ids(pts: torch.Tensor, spec: FieldSpec, dims, pad_query: bool):
    """Integer cell ids on the padded grid (pad ring: 0 and G+1).
    Gaussians clip to the real cells [1, G], queries into the ring too."""
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=pts.device)
    hi = torch.tensor(spec.hi, dtype=torch.float32, device=pts.device)
    g = torch.tensor(dims, dtype=torch.int64, device=pts.device)
    h = (hi - lo) / torch.tensor(dims, dtype=torch.float32,
                                 device=pts.device)
    ci = torch.floor((pts - lo) / h).to(torch.int64) + 1
    if pad_query:
        return torch.clamp(ci, torch.zeros_like(g), g + 1)
    return torch.clamp(ci, torch.ones_like(g), g)


def _linearize(ci: torch.Tensor, dims) -> torch.Tensor:
    lid = ci[..., 0]
    for a in range(1, len(dims)):
        lid = lid * (dims[a] + 2) + ci[..., a]
    return lid


class _GatherRows(torch.autograd.Function):
    """``src[idx]`` whose backward sums the rows' cotangents over the
    pairs sorted by row (``order``, ``lengths`` = pairs per row), in a
    fixed order."""

    @staticmethod
    def forward(ctx, src, idx, order, lengths):
        ctx.save_for_backward(order, lengths)
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        order, lengths = ctx.saved_tensors
        return (torch.segment_reduce(grad[order], "sum", lengths=lengths,
                                     axis=0), None, None, None)


def _pairs(mu, in_dom, x, spec: FieldSpec, cap: int):
    """(q, gid, per-query pair counts, total): the pair list of ``x``
    against the Gaussians at ``mu``, ordered by query. Where ``total``
    exceeds ``cap`` the list is not built: (None, None, None, total)."""
    d = spec.d
    dims, _ = grid_dims(spec)
    n_cells = 1
    for g in dims:
        n_cells *= g + 2
    dev = x.device
    gcell = torch.where(in_dom, _linearize(_cell_ids(mu, spec, dims, False),
                                           dims), n_cells)
    perm = torch.argsort(gcell, stable=True)
    cnt = torch.bincount(gcell, minlength=n_cells + 1)
    cnt[n_cells] = 0        # not-in-domain rows are never enumerated
    off = torch.cumsum(cnt, 0) - cnt
    offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=d)),
                           dtype=torch.int64, device=dev)
    nbr = _cell_ids(x, spec, dims, True)[:, None, :] + offsets[None]
    padded = torch.tensor([g + 2 for g in dims], dtype=torch.int64,
                          device=dev)
    ok = ((nbr >= 0) & (nbr <= padded - 1)).all(dim=-1)
    nbr_id = torch.where(ok, _linearize(nbr, dims), n_cells).reshape(-1)
    counts = cnt[nbr_id]                                # (B * 3^d,)
    starts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    if total > cap:
        return None, None, None, total
    loc = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                  counts, output_size=total)
    within = torch.arange(total, device=dev) - starts[loc]
    gid = perm[off[nbr_id[loc]] + within]
    q = loc // offsets.shape[0]
    return q, gid, counts.reshape(x.shape[0], -1).sum(dim=1), total


def _packed_dot(pk, delta, d):
    """(quad, P @ delta) from the packed entries [diag..., off-diag i<j]."""
    quad = torch.zeros_like(delta[:, 0])
    for a in range(d):
        quad = quad + pk[:, a] * delta[:, a] * delta[:, a]
    k = d
    for i in range(d):
        for j in range(i + 1, d):
            quad = quad + 2.0 * pk[:, k] * delta[:, i] * delta[:, j]
            k += 1
    pd = []
    for i in range(d):
        acc = pk[:, i] * delta[:, i]
        k = d
        for a in range(d):
            for c in range(a + 1, d):
                if a == i:
                    acc = acc + pk[:, k] * delta[:, c]
                elif c == i:
                    acc = acc + pk[:, k] * delta[:, a]
                k += 1
        pd.append(acc)
    return quad, torch.stack(pd, dim=-1)


def _fallback(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
              need_jac: bool):
    """The whole call off the pair list: the centered path on the card
    (its kernels), the dense sweep in chunks on the CPU."""
    from gaussian_fluids_torch.ops import field
    b, d, vdim = x.shape[0], spec.d, spec.vdim
    if field._on_card(x):
        if need_jac:
            return field.value_and_jac_centered(mix, spec, x)
        return field.value_centered(mix, spec, x), x.new_zeros((b, vdim, d))
    vals, jacs = [], []
    for i in range(0, b, _DENSE_CHUNK):
        xc = x[i:i + _DENSE_CHUNK]
        if need_jac:
            v, j = field.value_and_jac_dense(mix, spec, xc)
        else:
            v = field.value_dense(mix, spec, xc)
            j = xc.new_zeros((xc.shape[0], vdim, d))
        vals.append(v)
        jacs.append(j)
    return torch.cat(vals), torch.cat(jacs)


def _sparse_value_jac(params, alive, spec: FieldSpec, x: torch.Tensor,
                      cap: int, need_jac: bool):
    """(val, jac, used_sparse): the core evaluation, differentiable in
    ``params`` (the index math is not)."""
    from gaussian_fluids_torch.ops import field
    d, vdim = spec.d, spec.vdim
    b = x.shape[0]
    mu = params["positions"]
    n = mu.shape[0]
    _, h = grid_dims(spec)
    with torch.no_grad():
        mix0 = mixture_of({k: p.detach() for k, p in params.items()}, alive)
        in_dom = field.in_domain_mask(mix0, spec)
        r = field.support_radius(params["scalings"].detach(),
                                 spec.clamp_threshold)
        r_ok = bool(torch.where(in_dom, r <= min(h), True).all())
        q, gid, per_q, total = _pairs(mu.detach(), in_dom, x.detach(),
                                      spec, cap) if r_ok else (None,) * 4
    if not r_ok or total > cap:
        _fallbacks[0] += 1
        return (*_fallback(mixture_of(params, alive), spec, x, need_jac),
                False)
    with torch.no_grad():
        order = torch.argsort(gid, stable=True)
        per_g = torch.bincount(gid, minlength=n)
    pk = rotations_ops.packed_precision_entries(
        params["scalings"], params["rotations"], d)

    def gather(src):
        return _GatherRows.apply(src, gid, order, per_g)

    delta = x[q] - gather(mu)
    quad, pd = _packed_dot(gather(pk), delta, d)
    g = torch.exp(-0.5 * quad)
    m = g >= spec.clamp_threshold
    vg = gather(params["values"])
    mgv = torch.where(m, g - spec.clamp_threshold, torch.zeros_like(g))
    val = torch.segment_reduce(mgv[:, None] * vg, "sum", lengths=per_q,
                               axis=0)
    if not need_jac:
        return val, x.new_zeros((b, vdim, d)), True
    mg = torch.where(m, g, torch.zeros_like(g))
    contrib = -(mg[:, None, None] * vg[:, :, None] * pd[:, None, :])
    jac = torch.segment_reduce(contrib.reshape(-1, vdim * d), "sum",
                               lengths=per_q, axis=0).reshape(b, vdim, d)
    return val, jac, True


def _chunked(params, alive, spec: FieldSpec, x: torch.Tensor,
             need_jac: bool):
    """Queries through the core in chunks of ``query_chunk()``, so a pair
    list stays bounded at any B."""
    b = x.shape[0]
    chunk = query_chunk()
    n = params["positions"].shape[0]
    cap = pair_capacity(min(b, chunk), n, spec)
    vals, jacs = [], []
    for i in range(0, b, chunk):
        v, j, _ = _sparse_value_jac(params, alive, spec, x[i:i + chunk],
                                    cap, need_jac)
        vals.append(v)
        jacs.append(j)
    if len(vals) == 1:
        return vals[0], jacs[0]
    return torch.cat(vals), torch.cat(jacs)


def value_and_jac_sparse(mix: GaussianMixture, spec: FieldSpec,
                         x: torch.Tensor):
    """(u(x), du/dx) through the pair list (the fallback under the
    guards). Shapes as ``field.value_and_jac``'s."""
    return _chunked(mix.params(), mix.alive, spec, x, True)


def value_sparse(mix: GaussianMixture, spec: FieldSpec,
                 x: torch.Tensor) -> torch.Tensor:
    return _chunked(mix.params(), mix.alive, spec, x, False)[0]


def two_head_grads_sparse(params, alive, spec: FieldSpec, x: torch.Tensor,
                          head1, head2):
    """``field.two_head_grads`` through one pair list (unchunked, as the
    JAX package's): one forward, two autograd pullbacks."""
    from gaussian_fluids_torch.ops import field
    cap = pair_capacity(x.shape[0], params["positions"].shape[0], spec)
    leaves = field._grad_leaves(params)
    with torch.enable_grad():
        val, jac, _ = _sparse_value_jac(leaves, alive, spec, x, cap, True)
        l1, l2 = head1(val, jac), head2(val, jac)
        g1 = field._grads(l1, leaves, retain=True)
        g2 = field._grads(l2, leaves, retain=False)
    return (l1.detach(), l2.detach()), (g1, g2)
