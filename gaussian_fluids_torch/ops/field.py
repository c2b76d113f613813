"""Field evaluation: value and spatial Jacobian of the Gaussian mixture.

Semantics (the same as the JAX package's ``ops/field.py``):

    g_i(x)   = exp(-1/2 (x - mu_i)^T Sigma_i^{-1} (x - mu_i))
    u(x)     = sum_i  1[g_i >= c] * 1[mu_i in padded domain] * v_i (g_i - c)
    du/dx    = sum_i  1[...] * v_i (-g_i) (Sigma_i^{-1} (x - mu_i))^T

Three backends behind ``value`` / ``value_and_jac`` / ``two_head_grads``,
chosen as the JAX package chooses them, with the device of the query
points in place of its TPU test:
  * on the card in 3D, for ``need_dx=False`` evaluations with B >= 256 and
    B*N >= 2^26, the work-list ("cells") path: the exact tile mask
    compacted into flat lists of its live tile pairs (``ops/spatial.py``)
    and the kernels of ``ops/gsr_cells.py``, which walk only those;
  * otherwise on the card, the centered block-sparse path: queries sorted
    along coordinate 0, an exact bounding-box + support-radius tile mask at
    the CUDA kernels' tiles, and the kernels of ``ops/gsr_centered.py``;
  * on the CPU, the dense path: the quadratic form as one (B, F) @ (F, N)
    matmul over polynomial features, as the JAX package's dense backend
    computes it, so CPU runs of both packages agree closely.
That is the default, ``GF_FIELD_BACKEND=auto``. As in the JAX package the
variable forces a path: ``dense`` the dense path, ``pallas`` the centered
path, ``cells`` the work-list path at any d (for the calls the auto rule
would give it: value-only and two-head evaluations), ``sparse`` the
cell-list oracle of ``ops/sparse.py``, on the card as on the CPU.
The centered and cells functions also run on the CPU (through the kernels'
plain twins), which is how the tests hold them against the JAX Pallas
kernels. ``need_dx`` is the JAX signature's: it is False where the caller
never differentiates the query points, which no port path does.

``epoch_heads_grads`` (the projection heads and a boundary head from one
forward and one triple-cotangent backward) and ``rk4_valjac_fused`` (the
RK4 backtrace and the endpoint's value and Jacobian in one launch) are
building blocks of the JAX package's that the port keeps with their
kernels: the first has no caller in either solver, the second serves the
2D covector target under ``GF_FUSED_RK4=1``.

``value_banded`` is the density replay's own path, called by name as in
the JAX package: value only, queries sorted along x and Gaussians
slab-major (x-slab first), each query tile summing a window of ``band``
Gaussian tiles (the kernel of ``ops/gsr_banded.py``, which walks only the
window's tiles whose box meets the query tile's), with a device-side
guard that sweeps the whole axis when a window would miss a tile.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import (GaussianMixture,
                                                  mixture_of)
from gaussian_fluids_torch.ops import (gsr_banded, gsr_cells, gsr_centered,
                                       rk4_fused, sparse, spatial)
from gaussian_fluids_torch.ops import rotations as rotations_ops
from gaussian_fluids_torch.utils.grids import default_chunk

_INF = float("inf")

_MIN_B = 256              # below one TPU query tile the JAX package goes dense
_CELLS_MIN_BN = 1 << 26   # below this B*N, list preparation outweighs


# Backend selection, as the JAX package's: "auto" (the default), or
# "dense", "pallas" (the centered path), "cells" (the work-list path) or
# "sparse" (the cell-list oracle, ops/sparse.py) through GF_FIELD_BACKEND.
_BACKEND_ENV = "GF_FIELD_BACKEND"


def _mode() -> str:
    return os.environ.get(_BACKEND_ENV, "auto")


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on the card: there a kernel path launches its
    CUDA kernels, on the CPU it runs their plain twins."""
    return x.is_cuda


def _use_kernel(x: torch.Tensor) -> bool:
    """Whether this call takes the centered kernel path: the JAX package's
    ``_use_pallas``, with a tensor on the card in place of its TPU test.
    ``pallas`` always, ``dense`` and ``sparse`` never; otherwise (``auto``,
    ``cells``) on the card, at every size. This one decision also gates
    the batches' sorting, the boundary batches' presort and the fused RK4
    target, as the JAX package's call sites do."""
    mode = _mode()
    if mode in ("dense", "sparse"):
        return False
    if mode == "pallas":
        return True
    return _on_card(x)


def _use_sparse(x: torch.Tensor) -> bool:
    """The cell-list oracle: ``GF_FIELD_BACKEND=sparse`` only, never in
    the auto ladder."""
    return _mode() == "sparse"


def _use_cells(x: torch.Tensor, n: int, d: int) -> bool:
    """The JAX package's cells dispatch, with the card in place of its
    TPU test: ``cells`` at any d, on or off the card; in ``auto`` 3D
    on the card with B >= 256 and B*N >= 2^26, unless ``GF_CELLS=0``;
    never in another mode."""
    mode = _mode()
    if mode == "cells":
        return True
    if mode != "auto":
        return False
    b = x.shape[0]
    return (d == 3 and _on_card(x) and b >= _MIN_B and b * n >= _CELLS_MIN_BN
            and os.environ.get("GF_CELLS", "1") == "1")


def _sparse_tiles() -> bool:
    """The centered path's tile mask and query sort; ``GF_SPARSE=0`` turns
    both off, as in the JAX package: the queries stay in the caller's
    order and every tile pair is live (the kernels' per-pair box test,
    a pure skip, stays)."""
    return os.environ.get("GF_SPARSE", "1") != "0"


CELLS_FULL_LIST = 1 << 20   # tile pairs: up to here a list holds them all


def _cells_cap(nbt: int, nnt: int) -> int:
    """Work-list capacity of an (nbt, nnt) tile grid. ``GF_CELLS_CAP``
    unset: the whole grid where it has at most ``CELLS_FULL_LIST`` tile
    pairs (12 MB of lists, which cannot overflow), else 0.3 of it plus
    the keep-alive floor. ``GF_CELLS_CAP`` set: that fraction plus the
    floor at every size; 0.3 is the JAX package's rule. Of the default
    configurations' cells calls, the whole-grid list reaches the hoisted
    Leapfrog-3D sweeps of projection and clone (B = 204,800 against
    N = 1024: 25,600 x 16 tiles, a mask density near 0.5, over the 0.3
    budget); at Ring-Collide (N = 75,776, 1184 Gaussian tiles) only calls
    of 886 to 7080 queries reach it, and the defaults make none. Too
    small is safe: the kernels sweep the whole mask on overflow."""
    frac = os.environ.get("GF_CELLS_CAP")
    if frac is None and nbt * nnt <= CELLS_FULL_LIST:
        return nbt * nnt
    return int(float(frac or 0.3) * nbt * nnt) + max(nbt, nnt)


def _check_queries(mix: GaussianMixture, x: torch.Tensor):
    if x.dim() != 2 or x.shape[1] != mix.d:
        raise ValueError(
            f"query points must have shape (B, {mix.d}); got "
            f"{tuple(x.shape)}")


def in_domain_mask(mix: GaussianMixture, spec: FieldSpec) -> torch.Tensor:
    """(N,) bool: alive and centre inside the padded domain."""
    inside = mix.alive
    # per-coordinate Python bounds: no host-to-device copy (which would
    # synchronise the stream) on the per-epoch path
    for k in range(mix.d):
        p = mix.positions[:, k]
        inside = inside & (p >= spec.lo[k]) & (p <= spec.hi[k])
    return inside


# ---- dense path (CPU) ----

def _quad_features(x: torch.Tensor, d: int) -> torch.Tensor:
    """[x_i^2, 2 x_i x_j (i<j), -2 x_i, 1]: quad = x'Px - 2x.pm + c0 is
    linear in them."""
    cols = [x[:, i] * x[:, i] for i in range(d)]
    for i in range(d):
        for j in range(i + 1, d):
            cols.append(2.0 * x[:, i] * x[:, j])
    for i in range(d):
        cols.append(-2.0 * x[:, i])
    cols.append(torch.ones_like(x[:, 0]))
    return torch.stack(cols, dim=-1)


def _quad_weights(mix: GaussianMixture):
    """(W (N, F), P (N, d, d), pm = P mu (N, d))."""
    d = mix.d
    P = mix.precisions()
    pm = torch.einsum("nij,nj->ni", P, mix.positions)
    c0 = torch.einsum("ni,ni->n", pm, mix.positions)
    cols = [P[:, i, i] for i in range(d)]
    for i in range(d):
        for j in range(i + 1, d):
            cols.append(P[:, i, j])
    for i in range(d):
        cols.append(pm[:, i])
    cols.append(c0)
    return torch.stack(cols, dim=-1), P, pm


def masked_kernel(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor):
    """(mg, mask, P, pm): the masked Gaussian kernel matrix (B, N)."""
    _check_queries(mix, x)
    W, P, pm = _quad_weights(mix)
    quad = _quad_features(x, mix.d) @ W.T
    g = torch.exp(-0.5 * quad)
    mask = (g >= spec.clamp_threshold) & in_domain_mask(mix, spec)[None, :]
    return torch.where(mask, g, torch.zeros_like(g)), mask, P, pm


def value_dense(mix: GaussianMixture, spec: FieldSpec,
                x: torch.Tensor) -> torch.Tensor:
    mg, mask, _, _ = masked_kernel(mix, spec, x)
    mg_val = torch.where(mask, mg - spec.clamp_threshold,
                         torch.zeros_like(mg))
    return mg_val @ mix.values


def value_and_jac_dense(mix: GaussianMixture, spec: FieldSpec,
                        x: torch.Tensor):
    """jac[b,a,k] = -sum_n mg[b,n] v[n,a] (P[n] x[b] - pm[n])[k], as two
    (B, N) @ (N, *) matmuls."""
    d, vdim = mix.d, mix.vdim
    mg, mask, P, pm = masked_kernel(mix, spec, x)
    mg_val = torch.where(mask, mg - spec.clamp_threshold,
                         torch.zeros_like(mg))
    val = mg_val @ mix.values
    vP = torch.einsum("na,nkj->nakj", mix.values, P).reshape(-1, vdim * d * d)
    vpm = torch.einsum("na,nk->nak", mix.values, pm).reshape(-1, vdim * d)
    t1 = (mg @ vP).reshape(-1, vdim, d, d)
    t2 = (mg @ vpm).reshape(-1, vdim, d)
    jac = -(torch.einsum("bakj,bj->bak", t1, x) - t2)
    return val, jac


def coverage(mix: GaussianMixture, spec: FieldSpec,
             x: torch.Tensor) -> torch.Tensor:
    """sum_i (g_i - c) over the support — density-of-coverage diagnostic."""
    mg, mask, _, _ = masked_kernel(mix, spec, x)
    return torch.where(mask, mg - spec.clamp_threshold,
                       torch.zeros_like(mg)).sum(dim=-1)


def value_dense_oracle(mix: GaussianMixture, spec: FieldSpec,
                       x: torch.Tensor) -> torch.Tensor:
    """The reference's slow dense sum, with no clamp truncation: every
    alive Gaussian's v_i g_i, a differential-testing oracle."""
    P = mix.precisions()
    delta = x[:, None, :] - mix.positions[None, :, :]
    quad = torch.einsum("bni,nij,bnj->bn", delta, P, delta)
    g = torch.exp(-0.5 * quad) * mix.alive[None, :]
    return g @ mix.values


def neighbor_mark(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """(N,) bool: Gaussians within ``radius`` of any query point."""
    d2 = ((x[:, None, :] - mix.positions[None, :, :]) ** 2).sum(dim=-1)
    near = (d2 <= radius * radius).any(dim=0)
    return near & in_domain_mask(mix, spec)


# ---- centered block-sparse path (the CUDA kernels) ----

def _pad_axis(a: torch.Tensor, mult: int, fill: float = 0.0) -> torch.Tensor:
    """Pad axis 0 up to a multiple of ``mult``."""
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail], dim=0)


def support_radius(scalings: torch.Tensor, clamp: float) -> torch.Tensor:
    """(N,) support radius: g >= clamp implies |x - mu| <= this."""
    return math.sqrt(-2.0 * math.log(clamp)) \
        * torch.exp(-scalings.min(dim=-1).values)


BOX_MARGIN = 1e-3   # relative, as gsr_banded.support_cut's margin on quad


def _row_support(mix: GaussianMixture, spec: FieldSpec, tn: int,
                 dead=None):
    """(dead, r), each (N_p,) per tn-padded row: dead or padded, and the
    support radius; what the tile mask and the box tests share. ``dead``:
    the rows' ``~in_domain_mask``, when the caller has it."""
    if dead is None:
        dead = ~in_domain_mask(mix, spec)
    dead = _pad_axis(dead, tn, fill=True)
    return dead, support_radius(_pad_axis(mix.scalings, tn),
                                spec.clamp_threshold)


def _dilated(dead: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.where(dead, -1.0, r * (1.0 + BOX_MARGIN)).contiguous()


@torch.no_grad()
def row_radius(mix: GaussianMixture, spec: FieldSpec, tn: int):
    """(N_p,) per tn-padded row: its support radius dilated by
    ``BOX_MARGIN``, -1 on dead and padded rows. A pair with
    |x_k - mu_k| > this on some axis k has g < clamp however f32 rounds
    (quad >= (1 + 2e-3) (-2 ln c) exactly, far beyond f32's error), so a
    kernel's box test on it is a pure skip that never decides the
    support; a dead row fails every test."""
    return _dilated(*_row_support(mix, spec, tn))


def _packed_precisions(mix: GaussianMixture,
                       dead: torch.Tensor) -> torch.Tensor:
    """(N, d(d+1)/2 + 1): P diagonal, P off-diagonals, dead-row bias."""
    pk = rotations_ops.packed_precision_entries(mix.scalings, mix.rotations,
                                                mix.d)
    bias = torch.where(dead, 1e9, 0.0).to(pk.dtype)
    return torch.cat([pk, bias[:, None]], dim=-1)


def _tile_mask(x_p, valid_b, mu_p, dead_n, r_n, tb: int,
               tn: int) -> torch.Tensor:
    """(B//tb, N//tn) int32: 1 where a query tile's bounding box meets a
    Gaussian tile's bounding box, each row dilated by its own support
    radius. Exact: skipped tiles cannot contribute."""
    d = x_p.shape[1]
    nbt, nnt = x_p.shape[0] // tb, mu_p.shape[0] // tn
    xb = x_p.reshape(nbt, tb, d)
    vb = valid_b.reshape(nbt, tb, 1)
    blo = torch.where(vb, xb, _INF).amin(dim=1)
    bhi = torch.where(vb, xb, -_INF).amax(dim=1)
    mun = mu_p.reshape(nnt, tn, d)
    dn = dead_n.reshape(nnt, tn, 1)
    rr = r_n.reshape(nnt, tn, 1)
    nlo = torch.where(dn, _INF, mun - rr).amin(dim=1)
    nhi = torch.where(dn, -_INF, mun + rr).amax(dim=1)
    ok = ((bhi[:, None, :] >= nlo[None, :, :])
          & (blo[:, None, :] <= nhi[None, :, :])).all(dim=-1)
    return ok.to(torch.int32)


def _padded_param_rows(mix: GaussianMixture, spec: FieldSpec, tn: int,
                       dead=None):
    """(mu_p, pp_p, v_p): tn-padded parameter rows with the dead/padded-row
    +1e9 bias — the single differentiable source of the kernels' layout.
    ``dead``: the rows' ``~in_domain_mask``, when the caller has it."""
    if dead is None:
        dead = ~in_domain_mask(mix, spec)
    pp = _packed_precisions(mix, dead)
    mu_p = _pad_axis(mix.positions, tn)
    pp_p = _pad_axis(pp, tn)
    if pp_p.shape[0] > mix.capacity:
        nb = mix.d * (mix.d + 1) // 2
        pad_bias = torch.zeros_like(pp_p)
        pad_bias[mix.capacity:, nb] = 1e9   # padded rows never fire
        pp_p = pp_p + pad_bias
    v_p = _pad_axis(mix.values, tn)
    return mu_p, pp_p, v_p


@torch.no_grad()
def _tile_mask_of(mix: GaussianMixture, spec: FieldSpec, x_p, b: int,
                  tb: int, tn: int, support=None) -> torch.Tensor:
    """The tile mask of tb-padded queries (``b`` real rows) against the
    mixture's tn-padded rows (``support``: ``_row_support``'s, when the
    caller has it)."""
    valid_b = torch.arange(x_p.shape[0], device=x_p.device) < b
    dead_n, r_n = support or _row_support(mix, spec, tn)
    return _tile_mask(x_p, valid_b, _pad_axis(mix.positions, tn), dead_n,
                      r_n, tb, tn)


def _centered_prep(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                   tb: int, tn: int, presorted: bool):
    """Sort (unless presorted), pad, pack, and build the tile mask.
    Returns (x_p, b, inv | None, mu_p, pp_p, v_p, tmask, rad): ``rad`` the
    rows' dilated radii of the forward's box test (``row_radius``, from
    the mask's own radii). The sort is along coordinate 0 whatever the
    spatial key, as the JAX package's; under ``GF_SPARSE=0`` there is no
    sort and the mask is all ones (``_sparse_tiles``)."""
    _check_queries(mix, x)
    b = x.shape[0]
    inv = None
    tiles = _sparse_tiles()
    if tiles and not presorted:
        order = torch.argsort(x[:, 0], stable=True)
        inv = torch.argsort(order)
        x = x[order]
    x_p = _pad_axis(x, tb).contiguous()
    mu_p, pp_p, v_p = _padded_param_rows(mix, spec, tn)
    with torch.no_grad():
        support = _row_support(mix, spec, tn)
        if tiles:
            tmask = _tile_mask_of(mix, spec, x_p, b, tb, tn, support)
        else:
            tmask = torch.ones((x_p.shape[0] // tb, mu_p.shape[0] // tn),
                               dtype=torch.int32, device=x_p.device)
        rad = _dilated(*support)
    return x_p, b, inv, mu_p, pp_p, v_p, tmask, rad


def _split_out(out: torch.Tensor, b: int, d: int, vdim: int):
    val = out[:, :vdim]
    jac = out[:, vdim:].reshape(b, d, vdim).transpose(1, 2)
    return val, jac


def _centered_value_jac(mix: GaussianMixture, spec: FieldSpec,
                        x: torch.Tensor, njac: int, presorted: bool):
    """(val, jac | None) through the centered kernels; differentiable in
    the mixture parameters (the query points are constants)."""
    d, vdim = mix.d, mix.vdim
    x_p, b, inv, mu_p, pp_p, v_p, tmask, rad = _centered_prep(
        mix, spec, x, gsr_centered.TB, gsr_centered.TN, presorted)
    out = gsr_centered.fused_gsr_centered(
        tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
        v_p.contiguous(), spec.clamp_threshold, njac, rad)[:b]
    val, jac = _split_out(out, b, d, vdim) if njac else (out, None)
    if inv is not None:
        val = val[inv]
        jac = jac[inv] if njac else None
    return val, jac


def value_and_jac_centered(mix: GaussianMixture, spec: FieldSpec,
                           x: torch.Tensor, presorted: bool = False):
    """``value_and_jac`` through the centered kernels."""
    return _centered_value_jac(mix, spec, x, mix.d, presorted)


def value_centered(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                   presorted: bool = False) -> torch.Tensor:
    """Value-only variant (no Jacobian columns) — the boundary-loss and
    RK4-stage path."""
    return _centered_value_jac(mix, spec, x, 0, presorted)[0]


# ---- work-list (cells) path (the CUDA cells kernels) ----

def _cells_lists(tmask: torch.Tensor, cap: int):
    """(rows, cols, gtiles, qtiles, ok): the work lists of the mask and of
    its transpose, ok an int32 flag that both fit."""
    m = tmask.bool()
    rows, cols, okf = spatial.flat_work_list(m, cap)
    gtiles, qtiles, okb = spatial.flat_work_list(m.T, cap)
    return rows, cols, gtiles, qtiles, (okf & okb).to(torch.int32)


def _cells_prep(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor):
    """(x_p, b, tmask, lists, rad) for the cells path: ``x`` (presorted by
    ``spatial.sort_key``) padded to the kernels' query tile, the exact tile
    mask at the kernels' tiles, its work lists, and the rows' dilated
    radii of the forward's box test (``row_radius``, from the mask's own
    radii). The capacity's Gaussian rows are a multiple of 512, so the
    Gaussian tile divides them."""
    _check_queries(mix, x)
    with torch.no_grad():
        b = x.shape[0]
        x_p = _pad_axis(x.detach(), gsr_cells.TB).contiguous()
        support = _row_support(mix, spec, gsr_cells.TN)
        tmask = _tile_mask_of(mix, spec, x_p, b, gsr_cells.TB, gsr_cells.TN,
                              support)
        lists = _cells_lists(tmask, _cells_cap(*tmask.shape))
    return x_p, b, tmask, lists, _dilated(*support)


def _cells_value_jac(mix: GaussianMixture, spec: FieldSpec,
                     x: torch.Tensor, njac: int, presorted: bool = True):
    """(val, jac | None) via the work-list kernels, differentiable in the
    mixture parameters (x is a constant)."""
    if x.requires_grad:
        raise NotImplementedError(
            "the cells path gives no gradient for the query points")
    d, vdim = mix.d, mix.vdim
    inv = None
    if not presorted:
        x, inv = spatial.sort_queries(x, spec.lo, spec.hi)
    x_p, b, tmask, lists, rad = _cells_prep(mix, spec, x)
    mu_p, pp_p, v_p = _padded_param_rows(mix, spec, gsr_cells.TN)
    out = gsr_cells.fused_gsr_cells(
        lists, tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
        v_p.contiguous(), rad, spec.clamp_threshold, njac)[:b]
    val, jac = _split_out(out, b, d, vdim) if njac else (out, None)
    if inv is not None:
        val = val[inv]
        jac = jac[inv] if njac else None
    return val, jac


# ---- banded value-only path (the density replay's CUDA kernel) ----

@torch.no_grad()
def gaussian_tile_boxes(mix: GaussianMixture, spec: FieldSpec, tn: int,
                        rad=None):
    """(lo, hi), each (d, nnt): per tn-row Gaussian tile, the box its live
    rows reach, each row dilated by ``row_radius`` (+-inf for a tile with
    no live row; ``gsr_centered.tile_boxes`` of the padded rows). A query
    tile whose box misses a Gaussian tile's holds no pair with g >= c
    there. Host-free: tensors on the mixture's device."""
    if rad is None:
        rad = row_radius(mix, spec, tn)
    return gsr_centered.tile_boxes(_pad_axis(mix.positions, tn).T, rad, tn)


def gaussian_tile_extents(mix: GaussianMixture, spec: FieldSpec, tn: int):
    """(nlo, nhi): the x-ranges of ``gaussian_tile_boxes``, which the
    banded window and its guard use, so that the window holds every tile
    the kernel's box test can let through."""
    lo, hi = gaussian_tile_boxes(mix, spec, tn)
    return lo[0], hi[0]


def band_window(x_p: torch.Tensor, b: int, nlo, nhi, band: int, tb: int):
    """(jlo, ok) of the banded kernel, on the device: per query tile of
    ``x_p`` (``b`` real rows) the first Gaussian tile whose x-range meets
    the tile's, clipped into [0, nnt - band]; ``ok`` (int32, shape (1,))
    is 1 iff every tile that meets a query tile lies in its window — the
    JAX package's band guard (``field.value_banded``)."""
    nbt, nnt = x_p.shape[0] // tb, nlo.shape[0]
    xb = x_p[:, 0].reshape(nbt, tb)
    valid = (torch.arange(x_p.shape[0], device=x_p.device) < b) \
        .reshape(nbt, tb)
    blo = torch.where(valid, xb, _INF).amin(dim=1)
    bhi = torch.where(valid, xb, -_INF).amax(dim=1)
    meet = ((bhi[:, None] >= nlo[None, :])
            & (blo[:, None] <= nhi[None, :])).to(torch.int32)
    jlo = meet.argmax(dim=1).clamp(0, nnt - band)
    jhi = nnt - 1 - meet.flip(1).argmax(dim=1)
    covered = ((meet.amax(dim=1) == 0) | (jhi < jlo + band)).all()
    return jlo.to(torch.int32), covered.to(torch.int32).reshape(1)


def banded_prep(mix: GaussianMixture, spec: FieldSpec):
    """The Gaussian side of ``value_banded``, shared by every call on one
    mixture (the replay's four RK4 stages of every chunk): the kernel's
    transposed, TN-padded rows, each row's dilated radius (``rad``), the
    tiles' boxes (``lo``, ``hi``: (d, nnt)) and their x extents (``nlo``,
    ``nhi``), which set the window."""
    tn = gsr_banded.TN
    with torch.no_grad():
        mu_p, pp_p, v_p = _padded_param_rows(mix, spec, tn)
        rad = row_radius(mix, spec, tn)
        lo, hi = gaussian_tile_boxes(mix, spec, tn, rad)
    return {"muT": mu_p.T.contiguous(), "ppT": pp_p.T.contiguous(),
            "v": v_p.contiguous(), "rad": rad, "lo": lo, "hi": hi,
            "nlo": lo[0], "nhi": hi[0], "d": mix.d,
            "clamp": spec.clamp_threshold}


@torch.no_grad()
def value_banded_prepped(prep, x: torch.Tensor, band: int,
                         presorted: bool = False) -> torch.Tensor:
    """``value_banded`` on a ``banded_prep``."""
    if x.dim() != 2 or x.shape[1] != prep["d"]:
        raise ValueError(f"query points must have shape (B, {prep['d']}); "
                         f"got {tuple(x.shape)}")
    tb = gsr_banded.TB
    b = x.shape[0]
    inv = None
    if not presorted:
        order = torch.argsort(x[:, 0], stable=True)
        inv = torch.argsort(order)
        x = x[order]
    x_p = _pad_axis(x, tb).contiguous()
    band = min(band, prep["nlo"].shape[0])
    jlo, ok = band_window(x_p, b, prep["nlo"], prep["nhi"], band, tb)
    out = gsr_banded.gsr_value_banded(
        jlo, ok, x_p, prep["muT"], prep["ppT"], prep["v"], prep["rad"],
        prep["lo"], prep["hi"], prep["clamp"], band, nvalid=b)[:b]
    return out if inv is None else out[inv]


def value_banded(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                 band: int, presorted: bool = False) -> torch.Tensor:
    """Value through the banded value-only kernel, for huge spatially
    coherent query sets (the density backtrace); no gradients. The
    mixture must be x-sorted (``x_sorted``) or slab-major
    (``slab_sorted``, the replay's order, which lets the kernel skip most
    of a window) for a narrow band to cover.
    Queries are sorted along x here unless ``presorted``; query tile i sums
    the ``band`` Gaussian tiles from its first x-overlapping one. An
    insufficient band is safe: the guard, computed on the device, makes the
    kernel sweep the whole axis for the call (exact, never a dropped
    contribution). Tiles and band are the CUDA kernel's (``gsr_banded.TB``,
    ``TN``), on the CPU too."""
    _check_queries(mix, x)
    return value_banded_prepped(banded_prep(mix, spec), x, band, presorted)


# ---- dispatch ----

def value(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
          presorted: bool = False, need_dx: bool = True) -> torch.Tensor:
    """u(x): (B, vdim). ``presorted`` promises x ascends in coordinate 0
    (an untrue promise only loosens the tile mask, never correctness)."""
    if _use_sparse(x):
        return sparse.value_sparse(mix, spec, x)
    if not need_dx and _use_cells(x, mix.capacity, mix.d):
        return _cells_value_jac(mix, spec, x, 0, presorted=presorted)[0]
    if _use_kernel(x):
        return value_centered(mix, spec, x, presorted=presorted)
    return value_dense(mix, spec, x)


def value_and_jac(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                  presorted: bool = False, need_dx: bool = True):
    """(u(x), du/dx): shapes (B, vdim) and (B, vdim, d)."""
    if _use_sparse(x):
        return sparse.value_and_jac_sparse(mix, spec, x)
    if not need_dx and _use_cells(x, mix.capacity, mix.d):
        return _cells_value_jac(mix, spec, x, mix.d, presorted=presorted)
    if _use_kernel(x):
        return value_and_jac_centered(mix, spec, x, presorted=presorted)
    return value_and_jac_dense(mix, spec, x)


def _grad_leaves(params):
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def _grads(loss, leaves, retain):
    g = torch.autograd.grad(loss, list(leaves.values()), retain_graph=retain,
                            allow_unused=True, materialize_grads=True)
    return dict(zip(leaves, g))


def _heads_on_out(out: torch.Tensor, d: int, vdim: int, heads):
    """(losses, cotangents, use_val) of scalar heads of (val, jac) on the
    forward kernel's rows ``out``: one (rows, (1+d)*vdim) cotangent per
    head, zero in the columns it does not read. The value and Jacobian
    columns are separate leaves, so an unread one gets no gradient (known
    on the host without a sync); ``use_val`` says whether any head reads
    the value."""
    b = out.shape[0]
    cots, losses = [], []
    for head in heads:
        o = [out[:, :vdim].detach().requires_grad_(True),
             out[:, vdim:].detach().requires_grad_(True)]
        with torch.enable_grad():
            loss = head(o[0], o[1].reshape(b, d, vdim).transpose(1, 2))
            cots.append(torch.autograd.grad(loss, o, allow_unused=True))
        losses.append(loss.detach())
    use_val = any(c[0] is not None for c in cots)
    douts = [torch.cat([torch.zeros_like(t) if g is None else g
                        for g, t in zip(c, (out[:, :vdim], out[:, vdim:]))],
                       1) for c in cots]
    return losses, douts, use_val


def _param_grads(prep, leaves, blocks):
    """Each block of kernel cotangents (dmuT, dppT, dv) pulled back
    through the packed-parameter preparation ``prep`` to the parameter
    leaves."""
    grads = []
    for i, t in enumerate(blocks):
        gs = torch.autograd.grad(prep, list(leaves.values()), grad_outputs=t,
                                 retain_graph=i < len(blocks) - 1,
                                 allow_unused=True, materialize_grads=True)
        grads.append(dict(zip(leaves, gs)))
    return tuple(grads)


def _two_head_grads_kernels(params, alive, spec: FieldSpec, x: torch.Tensor,
                            head1, head2, cells: bool):
    """((l1, l2), (g1, g2)): two scalar heads of (val, jac) and their
    parameter gradients from ONE forward kernel and ONE dual-cotangent
    backward kernel (the PCGrad heads need the gradients separately),
    through the cells kernels or the centered ones. When neither head
    reads the value (autograd finds no path to it), the backward kernel
    skips the value cotangents. ``x`` must be presorted in coordinate 0;
    no gradient for x."""
    d, vdim = spec.d, spec.vdim
    b = x.shape[0]
    tb, tn = gsr_centered.TB, gsr_centered.TN
    clamp = spec.clamp_threshold
    mix_sg = mixture_of({k: p.detach() for k, p in params.items()}, alive)
    if cells:
        x_p, _, tmask, (rows, cols, gtiles, qtiles, ok), rad = _cells_prep(
            mix_sg, spec, x)
    else:
        x_p, _, _, _, _, _, tmask, rad = _centered_prep(
            mix_sg, spec, x, tb, tn, presorted=True)
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        mu_p, pp_p, v_p = _padded_param_rows(mixture_of(leaves, alive), spec,
                                             tn)
        prep = (mu_p.T.contiguous(), pp_p.T.contiguous(), v_p.contiguous())
    args = tuple(t.detach() for t in prep)
    if cells:
        out = gsr_cells.cells_fwd(rows, cols, ok, tmask, x_p, *args, clamp,
                                  d, rad)[:b]
    else:
        out = gsr_centered.gsr_fwd(tmask, x_p, *args, clamp, d, rad)[:b]
    losses, douts, use_val = _heads_on_out(out, d, vdim, (head1, head2))
    douts = [_pad_axis(t, tb).contiguous() for t in douts]
    if cells:
        t1, t2 = gsr_cells.cells_bwd_dn2(
            gtiles, qtiles, ok, tmask, x_p, *args, douts[0], douts[1],
            clamp, d, rad, use_val=use_val)
    else:
        t1, t2 = gsr_centered.gsr_bwd_dn2(
            tmask, x_p, *args, douts[0], douts[1], clamp, d, use_val=use_val)
    return tuple(losses), _param_grads(prep, leaves, (t1, t2))


def two_head_grads_centered(params, alive, spec: FieldSpec, x: torch.Tensor,
                            head1, head2):
    """Two-head gradients through the centered kernels."""
    return _two_head_grads_kernels(params, alive, spec, x, head1, head2,
                                   cells=False)


def two_head_grads_cells(params, alive, spec: FieldSpec, x: torch.Tensor,
                         head1, head2):
    """Two-head gradients through the work-list kernels: one forward over
    the live tile pairs and one dual-cotangent walk of the transposed
    list."""
    return _two_head_grads_kernels(params, alive, spec, x, head1, head2,
                                   cells=True)


def two_head_grads(params, alive, spec: FieldSpec, x: torch.Tensor,
                   head1, head2):
    """Backend-dispatching two-head gradients; ``x`` presorted in
    coordinate 0 on the card. On the dense path the two gradients are two
    autograd pullbacks of one forward."""
    cap = params["positions"].shape[0]
    if _use_sparse(x):
        return sparse.two_head_grads_sparse(params, alive, spec, x, head1,
                                            head2)
    if _use_cells(x, cap, spec.d):
        return two_head_grads_cells(params, alive, spec, x, head1, head2)
    if _use_kernel(x):
        return two_head_grads_centered(params, alive, spec, x, head1, head2)
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        val, jac = value_and_jac_dense(mixture_of(leaves, alive), spec, x)
        l1, l2 = head1(val, jac), head2(val, jac)
        g1 = _grads(l1, leaves, retain=True)
        g2 = _grads(l2, leaves, retain=False)
    return (l1.detach(), l2.detach()), (g1, g2)


def epoch_heads_grads_centered(params, alive, spec: FieldSpec,
                               x: torch.Tensor, x_bnd: torch.Tensor, head1,
                               head2, head_bnd):
    """((l1, l2, lb), (g1, g2, gb)) for the fused projection-epoch
    geometry: heads 1 and 2 (the PCGrad buckets) see (val, jac) at the data
    rows ``x``, ``head_bnd`` sees the value at the boundary rows ``x_bnd``.
    One forward over [x padded to the query tile; x_bnd] and one
    triple-cotangent backward replace the separate boundary forward and
    value backward. Both segments presorted in coordinate 0; no gradient
    for the query points. Value use of heads 1 and 2 is found by
    autograd, as in ``two_head_grads``."""
    d, vdim = spec.d, spec.vdim
    tb, tn = gsr_centered.TB, gsr_centered.TN
    clamp = spec.clamp_threshold
    bd_n, bb_n = x.shape[0], x_bnd.shape[0]
    mix_sg = mixture_of({k: p.detach() for k, p in params.items()}, alive)
    x_dp = _pad_axis(x, tb)
    data_rows = x_dp.shape[0]
    x_p, _, _, _, _, _, tmask, rad = _centered_prep(
        mix_sg, spec, torch.cat([x_dp, x_bnd]), tb, tn, presorted=True)
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        mu_p, pp_p, v_p = _padded_param_rows(mixture_of(leaves, alive), spec,
                                             tn)
        prep = (mu_p.T.contiguous(), pp_p.T.contiguous(), v_p.contiguous())
    args = tuple(t.detach() for t in prep)
    out = gsr_centered.gsr_fwd(tmask, x_p, *args, clamp, d, rad)
    bp = x_p.shape[0]
    losses, douts, use_val12 = _heads_on_out(out[:bd_n], d, vdim,
                                             (head1, head2))
    douts = [torch.cat([t, t.new_zeros((bp - bd_n, t.shape[1]))])
             for t in douts]
    vb = out[data_rows:data_rows + bb_n, :vdim].detach().requires_grad_(True)
    with torch.enable_grad():
        lb = head_bnd(vb)
        (gvb,) = torch.autograd.grad(lb, [vb])
    losses.append(lb.detach())
    dout3 = out.new_zeros((bp, vdim))
    dout3[data_rows:data_rows + bb_n] = gvb
    blocks = gsr_centered.gsr_bwd_dn3(tmask, x_p, *args, *douts, dout3,
                                      clamp, d, data_rows,
                                      use_val12=use_val12)
    return tuple(losses), _param_grads(prep, leaves, blocks)


def epoch_heads_grads(params, alive, spec: FieldSpec, x: torch.Tensor,
                      x_bnd: torch.Tensor, head1, head2, head_bnd):
    """Backend-dispatching :func:`epoch_heads_grads_centered`: on the dense
    path three autograd pullbacks of one forward over the same heads. Like
    the JAX package's, no solver runner calls it."""
    if _use_kernel(x):
        return epoch_heads_grads_centered(params, alive, spec, x, x_bnd,
                                          head1, head2, head_bnd)
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        mix = mixture_of(leaves, alive)
        val, jac = value_and_jac_dense(mix, spec, x)
        vb = value_dense(mix, spec, x_bnd)
        ls = (head1(val, jac), head2(val, jac), head_bnd(vb))
        grads = tuple(_grads(l, leaves, retain=i < 2)
                      for i, l in enumerate(ls))
    return tuple(l.detach() for l in ls), grads


def rk4_valjac_fused(mix: GaussianMixture, spec: FieldSpec, x: torch.Tensor,
                     dt):
    """(phi, val, jac): the RK4 endpoint of x through the velocity field
    over ``dt`` and the value and Jacobian at the endpoint, in one launch
    of the fused kernel (``ops/rk4_fused.py``; its plain twin on the CPU),
    which culls each stage on the rows' radii (``row_radius``) and the
    Gaussian tiles' boxes (``gaussian_tile_boxes``, here from the kernel
    layout), computed once with the parameter rows from one dead mask.
    Forward only; velocity fields only (vdim == d)."""
    _check_queries(mix, x)
    d, vdim = mix.d, mix.vdim
    b = x.shape[0]
    tn = rk4_fused.TN
    with torch.no_grad():
        dead = ~in_domain_mask(mix, spec)
        mu_p, pp_p, v_p = _padded_param_rows(mix, spec, tn, dead)
        muT = mu_p.T.contiguous()
        rad = _dilated(*_row_support(mix, spec, tn, dead))
        phi, vj = rk4_fused.fused_rk4(
            x.contiguous(), muT, pp_p.T.contiguous(), v_p.contiguous(),
            float(dt), spec.clamp_threshold, d, rad,
            *gsr_centered.tile_boxes(muT, rad, tn))
    val, jac = _split_out(vj, b, d, vdim)
    return phi, val, jac


# ---- chunked evaluation ----

def value_and_jac_chunked(mix: GaussianMixture, spec: FieldSpec,
                          x: torch.Tensor, chunk: int = 0,
                          presorted: bool = False):
    """(val, jac) on many points in chunks, no gradients; ``chunk`` 0 takes
    the JAX package's (``utils.grids.default_chunk``)."""
    if chunk == 0:
        chunk = default_chunk(x)
    vals, jacs = [], []
    with torch.no_grad():
        for i in range(0, x.shape[0], chunk):
            v, j = value_and_jac(mix, spec, x[i:i + chunk],
                                 presorted=presorted)
            vals.append(v)
            jacs.append(j)
    return torch.cat(vals), torch.cat(jacs)


def eval_on_grid(mix: GaussianMixture, spec: FieldSpec, pts,
                 chunk: int = 0):
    """(val, jac) as numpy arrays on arbitrarily many points."""
    x = torch.as_tensor(np.asarray(pts, np.float32), device=mix.device)
    v, j = value_and_jac_chunked(mix, spec, x, chunk)
    return v.cpu().numpy(), j.cpu().numpy()
