"""Centered Gaussian field kernels: CUDA wrappers and their plain twins.

Ports five Pallas TPU kernels of ``gaussian_fluids_tpu/ops/pallas/
gsr_centered.py`` to CUDA C++ for Hopper (``csrc/gsr_centered.cu``):

  ``gsr_fwd``      <- ``_fwd_kernel``      value + Jacobian forward
  ``gsr_bwd_dn``   <- ``_bwd_dn_kernel``   per-Gaussian cotangents
  ``gsr_bwd_dn2``  <- ``_bwd_dn2_kernel``  the same for two cotangent
                                            blocks sharing one recompute
  ``gsr_bwd_dx``   <- ``_bwd_dx_kernel``   dL/dx per query point
  ``gsr_bwd_dn3``  <- ``_bwd_dn3_kernel``  three cotangent blocks: two on
                                            the data rows, one value-only
                                            on the boundary rows after them

Each wrapper takes the kernels' layout — x (B, d), muT (d, N), packed
precisions ppT (np, N) with the dead-row bias last, values (N, vdim) and
an int32 tile mask (B/tb, N/tn) — and dispatches on the device of ``x``:
a CUDA tensor launches the kernel (after validation; any failure raises),
a CPU tensor runs the plain PyTorch version below, which repeats the
kernel's arithmetic on whole (B, N) planes with the tile mask expanded.
There is no fallback from the kernel to the plain version.

The forward stages each live Gaussian tile once per block and box-tests
every pair on the rows' dilated radii (``rad``, ``field.row_radius``)
before its geometry; where the query tiles are few it splits each query
tile over S blocks of a cluster (``fwd_split`` picks S). The parameter
backwards split each Gaussian tile's live query tiles over W x S threads
a Gaussian (``bwd_split`` picks W and S from the shape and the card's SM
count). ``split=`` forces either in tests and the smoke run.

The kernels take d = 2 or 3 and vdim = 1, 2 or 3 (templates on both).
The shared library is built with ``nvcc`` at first use into
``gaussian_fluids_torch/_build/`` (``ops/cuda_build.py``) and loaded with
``ctypes``: no PyTorch headers, a build of seconds.

``launches`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels.

The autograd function ``fused_gsr_centered`` differentiates the mixture
parameters through ``gsr_bwd_dn`` and, only when the query points need a
gradient (no solver phase asks for one), the query points through
``gsr_bwd_dx``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from gaussian_fluids_torch.ops import cuda_build

# The CUDA kernels' tiles: 8 queries x 64 Gaussians (csrc/gsr_tile.cuh).
# The field's tile mask is built at these sizes on the card.
TB, TN = 8, 64

# The parameter backwards' splits along the query axis
# (csrc/gsr_centered.cu): W workers of TN threads a block, S blocks a
# cluster; each of the W S workers of a Gaussian tile walks an equal share
# of the tile's live query tiles, compacted LIST_CAP at a time (the
# kernel's MAX_W, MAX_S and LIST_CAP).
SPLIT_W = (1, 2, 4, 8)
SPLIT_S = (1, 2, 4, 8)
LIST_CAP = 4096

SOURCE = cuda_build.CSRC / "gsr_centered.cu"

launches: Dict[str, int] = {"gsr_fwd": 0, "gsr_bwd_dn": 0, "gsr_bwd_dn2": 0,
                            "gsr_bwd_dx": 0, "gsr_bwd_dn3": 0}
# the forward's launches by (d, B, N): its paths run it at several shapes
fwd_shapes: Dict[Tuple[int, int, int], int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    fwd_shapes.clear()


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, str]:
    """Compile the kernels if this source has not been built yet. Returns
    (library path, compiler log — ptxas's register and spill report; empty
    when the library was already built)."""
    return cuda_build.build(SOURCE)[SOURCE.stem]


_LIB = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.gsr_tile_sizes.argtypes = [ctypes.POINTER(_I)] * 2
        lib.gsr_tile_sizes.restype = _I
        lib.gsr_fwd.argtypes = [_P] * 7 + [_I] * 5 + [_F, _I, _P]
        lib.gsr_fwd.restype = _I
        lib.gsr_bwd_dn.argtypes = [_P] * 8 + [_I] * 6 + [_F] + [_I] * 2 \
            + [_P]
        lib.gsr_bwd_dn.restype = _I
        lib.gsr_bwd_dn2.argtypes = [_P] * 11 + [_I] * 6 + [_F] + [_I] * 2 \
            + [_P]
        lib.gsr_bwd_dn2.restype = _I
        lib.gsr_bwd_dx.argtypes = [_P] * 7 + [_I] * 5 + [_F, _P]
        lib.gsr_bwd_dx.restype = _I
        lib.gsr_bwd_dn3.argtypes = [_P] * 14 + [_I] * 7 + [_F, _P]
        lib.gsr_bwd_dn3.restype = _I
        tb, tn = _I(), _I()
        lib.gsr_tile_sizes(ctypes.byref(tb), ctypes.byref(tn))
        if (tb.value, tn.value) != (TB, TN):
            raise RuntimeError(f"library tiles {(tb.value, tn.value)} != "
                               f"{(TB, TN)}")
        _LIB = lib
    return _LIB


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# ---------------------------------------------------------------------------
# the backwards' split
# ---------------------------------------------------------------------------

def bwd_split(nbt: int, nnt: int, sm_count: int) -> Tuple[int, int]:
    """(W, S) for a parameter backward over ``nbt`` query tiles and ``nnt``
    Gaussian tiles on a card of ``sm_count`` SMs. W, then S, doubles until
    the launch holds 32 warps an SM (half of what an SM holds; a worker is
    two warps) or both reach 8; then S, then W, halves until every worker
    has at least 16 query tiles (at 10-50% live, 2-8 to walk), and so
    never more workers W S than query tiles. Workers within a block are
    cheaper than blocks of a cluster, which compact the mask again and
    meet at cluster barriers."""
    w = s = 1
    most = SPLIT_W[-1] * SPLIT_S[-1]
    while 2 * nnt * w * s < 32 * sm_count and w * s < most:
        if w < SPLIT_W[-1]:
            w *= 2
        else:
            s *= 2
    while w * s > max(nbt // 16, 1):
        if s > 1:
            s //= 2
        else:
            w //= 2
    return w, s


# The forward's block: TB queries of FWD_SLOTS threads (csrc/gsr_tile.cuh);
# fwd_split aims at FWD_FILL_WARPS warps an SM.
FWD_WARPS = TB * 16 // 32
FWD_FILL_WARPS = 16


def fwd_split(nbt: int, nnt: int, sm_count: int) -> int:
    """S, the blocks of a cluster that share each query tile of the
    forward, over ``nbt`` query tiles and ``nnt`` Gaussian tiles on a card
    of ``sm_count`` SMs. S doubles until the launch holds FWD_FILL_WARPS
    warps an SM (a quarter of what an SM holds) or S reaches 8; then
    halves until every rank has at least 16 Gaussian tiles of its row to
    draw on (at 10-50% live, 2-8 to walk), and so never more ranks than
    Gaussian tiles. On an H100: Leapfrog-2D (64 query tiles) 4, Karman-2D
    8, Leapfrog-3D 1; Ring-Collide 2 at 4096 queries, 1 at 8192 and
    32,768."""
    s = 1
    while nbt * s * FWD_WARPS < FWD_FILL_WARPS * sm_count \
            and s < SPLIT_S[-1]:
        s *= 2
    while s > 1 and nnt < 16 * s:
        s //= 2
    return s


def equal_shares(per_window: torch.Tensor, u: int) -> torch.Tensor:
    """(rows, u) int64: per row, the tiles of each of u workers when each
    window's live tiles (``per_window`` (rows, windows), on the CPU) are
    cut into the split kernels' equal contiguous shares, [w L / u,
    (w + 1) L / u), summed over the windows."""
    k = torch.arange(u + 1)
    bounds = k[None, None, :] * per_window[:, :, None] // u
    return (bounds[..., 1:] - bounds[..., :-1]).sum(1)


def worker_tiles(tmask: torch.Tensor, split: Tuple[int, int]) -> torch.Tensor:
    """(nnt, W S) int64: the live query tiles each worker of each Gaussian
    tile walks under ``split`` — the kernel's equal contiguous shares of
    each LIST_CAP-tile window's compacted live tiles."""
    live = (tmask != 0).to(torch.int64).cpu()
    per_window = torch.stack(
        [live[b:b + LIST_CAP].sum(0)
         for b in range(0, max(live.shape[0], 1), LIST_CAP)], 1)
    return equal_shares(per_window, split[0] * split[1])


def _check_split(split) -> None:
    if split is None:
        return
    if not (isinstance(split, tuple) and len(split) == 2
            and split[0] in SPLIT_W and split[1] in SPLIT_S):
        raise ValueError(f"split must be (W, S) with W in {SPLIT_W} and S in "
                         f"{SPLIT_S}, got {split!r}")


def _check_fwd_split(split) -> None:
    if split is None:
        return
    if not (isinstance(split, int) and not isinstance(split, bool)
            and split in SPLIT_S):
        raise ValueError(f"split must be S in {SPLIT_S}, got {split!r}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_fwd_split(split, x, tmask) -> int:
    """The forced split, or ``fwd_split``'s for this shape on x's card."""
    if split is not None:
        return split
    return fwd_split(tmask.shape[0], tmask.shape[1],
                     _sm_count(x.device.index))


def _launch_split(split, x, tmask) -> Tuple[int, int]:
    """The forced split, or ``bwd_split``'s for this shape on x's card."""
    if split is not None:
        return split
    return bwd_split(tmask.shape[0], tmask.shape[1],
                     _sm_count(x.device.index))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _check(tmask, x, muT, ppT, values, njac, douts=()):
    """Shapes common to both paths; on CUDA also device, dtype, layout and
    the compiled tiles. Returns (d, vdim, B, N)."""
    if x.dim() != 2 or muT.dim() != 2 or ppT.dim() != 2 \
            or values.dim() != 2 or tmask.dim() != 2:
        raise ValueError("x, muT, ppT, values and tmask must be 2-D")
    B, d = x.shape
    N = muT.shape[1]
    vdim = values.shape[1]
    np_ = d * (d + 1) // 2 + 1
    if muT.shape[0] != d or ppT.shape != (np_, N) or values.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, muT {tuple(muT.shape)},"
                         f" ppT {tuple(ppT.shape)}, values "
                         f"{tuple(values.shape)} do not agree")
    nbt, nnt = tmask.shape
    if nbt == 0 or nnt == 0 or B % nbt or N % nnt:
        raise ValueError(f"tile mask {tuple(tmask.shape)} does not tile "
                         f"B={B}, N={N}")
    if njac not in (0, d):
        raise ValueError(f"njac must be 0 or d={d}, got {njac}")
    cols = (1 + njac) * vdim
    for t in douts:
        if tuple(t.shape) != (B, cols):
            raise ValueError(f"cotangent {tuple(t.shape)} != {(B, cols)}")
    if x.is_cuda:
        ts = (tmask, x, muT, ppT, values) + tuple(douts)
        if any(t.device != x.device for t in ts):
            raise ValueError("all kernel operands must be on one device")
        if tmask.dtype != torch.int32 or any(
                t.dtype != torch.float32 for t in ts[1:]):
            raise ValueError("kernel operands: int32 tmask, float32 rest")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("kernel operands must be contiguous")
        if d not in (2, 3) or vdim not in (1, 2, 3):
            raise ValueError(f"the CUDA kernels take d 2 or 3, vdim 1 to 3;"
                             f" got d={d}, vdim={vdim}")
        if (B // nbt, N // nnt) != (TB, TN):
            raise ValueError(f"tile mask built for tiles {(B // nbt, N // nnt)}"
                             f"; the CUDA kernels use {(TB, TN)}")
    return d, vdim, B, N


def check_rad(rad, x, N, staged=()):
    """``rad`` (N,): the rows' dilated radii of a kernel's box test. On
    CUDA also device, dtype, layout, and 16-byte alignment of the rows the
    kernel reads 16 bytes at a time (``staged``, with ``rad``)."""
    if not isinstance(rad, torch.Tensor) or tuple(rad.shape) != (N,):
        got = tuple(rad.shape) if isinstance(rad, torch.Tensor) else rad
        raise ValueError(f"rad must be a ({N},) tensor, got {got!r}")
    if x.is_cuda:
        if rad.device != x.device or rad.dtype != torch.float32 \
                or not rad.is_contiguous():
            raise ValueError("rad: contiguous float32 on the queries' device")
        if any(t.data_ptr() % 16 for t in (rad,) + tuple(staged)):
            raise ValueError("rad and the rows read 16 bytes at a time must "
                             "be 16-byte aligned")


def tile_boxes(muT, rad, tn: int = TN):
    """(lo, hi), each (d, N / tn): per tn-row Gaussian tile of the kernel
    layout (muT (d, N)), the box its live rows reach, each row dilated by
    its radius ``rad`` (-1 on dead and padded rows; +-inf for a tile with
    no live row). A query tile whose box misses a Gaussian tile's holds no
    pair with g >= c there. On the device of ``muT``, with no host read."""
    d, N = muT.shape
    m = muT.reshape(d, N // tn, tn)
    r = rad.reshape(1, N // tn, tn)
    dead = r < 0
    return (torch.where(dead, float("inf"), m - r).amin(dim=2),
            torch.where(dead, float("-inf"), m + r).amax(dim=2))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the card-side reference)
# ---------------------------------------------------------------------------

def _off_pairs(d: int):
    return [(i, j) for i in range(d) for j in range(i + 1, d)]


def _tile_quantities(tmask, x, muT, ppT, d, clamp):
    """delta list, g, m, Pd list — all (B, N); ``m`` includes the expanded
    tile mask, so skipped tile pairs contribute exactly nothing."""
    B, N = x.shape[0], muT.shape[1]
    nbt, nnt = tmask.shape
    live = (tmask != 0).repeat_interleave(B // nbt, 0) \
        .repeat_interleave(N // nnt, 1)
    delta = [x[:, i:i + 1] - muT[i:i + 1, :] for i in range(d)]
    pairs = _off_pairs(d)
    pd = []
    for k in range(d):
        acc = ppT[k:k + 1, :] * delta[k]
        for c, (i, j) in enumerate(pairs):
            if i == k:
                acc = acc + ppT[d + c:d + c + 1, :] * delta[j]
            elif j == k:
                acc = acc + ppT[d + c:d + c + 1, :] * delta[i]
        pd.append(acc)
    nb = d * (d + 1) // 2
    quad = ppT[nb:nb + 1, :] + delta[0] * pd[0]
    for k in range(1, d):
        quad = quad + delta[k] * pd[k]
    g = torch.exp(-0.5 * quad)
    m = (g >= clamp) & live
    return delta, g, m, pd


# The plain versions work on (rows, N) planes of at most this many query
# rows, so that the card-side reference at Ring-Collide width (N = 75,776)
# stays within memory; the backward sums the blocks' contributions.
_PLAIN_ROWS = 1024


def _row_blocks(tmask, x, *douts):
    """(tmask, x, douts) for successive whole query tiles of <= _PLAIN_ROWS
    rows (none for no rows)."""
    if tmask.shape[0] == 0:
        return
    tb = x.shape[0] // tmask.shape[0]
    step = max(tb, _PLAIN_ROWS // tb * tb)
    for s in range(0, x.shape[0], step):
        yield (tmask[s // tb:(s + step) // tb], x[s:s + step],
               [t[s:s + step] for t in douts])


def fwd_plain(tmask, x, muT, ppT, values, clamp: float, njac: int):
    return torch.cat([_fwd_plain_block(tm, xb, muT, ppT, values, clamp, njac)
                      for tm, xb, _ in _row_blocks(tmask, x)])


def _fwd_plain_block(tmask, x, muT, ppT, values, clamp, njac):
    d = x.shape[1]
    _, g, m, pd = _tile_quantities(tmask, x, muT, ppT, d, clamp)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    mg = torch.where(m, g, zero)
    cols = [torch.where(m, g - clamp, zero) @ values]
    for k in range(njac):
        cols.append((-mg * pd[k]) @ values)
    return torch.cat(cols, dim=1)


def _cotangents(q, dout, v, vdim, njac, use_val):
    """(gquad, gpd list, mg): dL/dquad and dL/dPd_k on whole planes — the
    TPU kernels' _bwd_cotangents. ``use_val=False`` promises a zero value
    cotangent."""
    _, g, m, pd = q
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    s2 = [dout[:, (1 + k) * vdim:(2 + k) * vdim] @ v.T for k in range(njac)]
    mg = torch.where(m, g, zero)
    if use_val:
        gg = dout[:, :vdim] @ v.T
        for k in range(njac):
            gg = gg - s2[k] * pd[k]
    else:
        gg = -s2[0] * pd[0]
        for k in range(1, njac):
            gg = gg - s2[k] * pd[k]
    gquad = torch.where(m, -0.5 * g * gg, zero)
    return gquad, [-mg * s2[k] for k in range(njac)], mg


def _dxj(gquad, gpd, pd, ppT, d, jdim):
    """dL/dx_j on whole planes, before the sum over Gaussians — the TPU
    kernels' _dxj_tile (``gpd`` is empty in the value-only mode)."""
    t = gquad * (2.0 * pd[jdim])
    if jdim < len(gpd):
        t = t + gpd[jdim] * ppT[jdim:jdim + 1, :]
    for c, (i, jj) in enumerate(_off_pairs(d)):
        if i == jdim and jj < len(gpd):
            t = t + gpd[jj] * ppT[d + c:d + c + 1, :]
        elif jj == jdim and i < len(gpd):
            t = t + gpd[i] * ppT[d + c:d + c + 1, :]
    return t


def _dn_accumulate(q, ppT, dout, v, d, vdim, clamp, njac, use_val):
    """(dmp (d + np, N), dv (N, vdim)) for one cotangent block — the TPU
    kernels' _bwd_cotangents + _dn_accumulate on whole planes."""
    delta, g, m, pd = q
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gquad, gpd, mg = _cotangents(q, dout, v, vdim, njac, use_val)

    if use_val:
        dv = torch.where(m, g - clamp, zero).T @ dout[:, :vdim]
    else:
        dv = (-mg * pd[0]).T @ dout[:, vdim:2 * vdim]
    for k in range(0 if use_val else 1, njac):
        dv = dv + (-mg * pd[k]).T @ dout[:, (1 + k) * vdim:(2 + k) * vdim]

    pairs = _off_pairs(d)
    # dmu_j = -sum_b dL/dx_j
    rows = [-_dxj(gquad, gpd, pd, ppT, d, j).sum(0) for j in range(d)]
    for k in range(d):                          # diagonal precisions
        t = gquad * delta[k] * delta[k]
        if k < njac:
            t = t + gpd[k] * delta[k]
        rows.append(t.sum(0))
    for ii, jj in pairs:                        # off-diagonal precisions
        t = 2.0 * gquad * delta[ii] * delta[jj]
        if ii < njac:
            t = t + gpd[ii] * delta[jj]
        if jj < njac:
            t = t + gpd[jj] * delta[ii]
        rows.append(t.sum(0))
    rows.append(gquad.sum(0))                   # dead-row bias
    return torch.stack(rows), dv


def _bwd_plain(tmask, x, muT, ppT, values, douts, clamp, njac, use_val):
    """[(dmp, dv) per cotangent], summed over the query-row blocks (zero
    for no rows)."""
    d, vdim = x.shape[1], values.shape[1]
    acc = [(muT.new_zeros((d + ppT.shape[0], muT.shape[1])),
            values.new_zeros(values.shape)) for _ in douts]
    for tm, xb, db in _row_blocks(tmask, x, *douts):
        q = _tile_quantities(tm, xb, muT, ppT, d, clamp)
        part = [_dn_accumulate(q, ppT, dout, values, d, vdim, clamp, njac,
                               use_val) for dout in db]
        acc = [(a[0] + p[0], a[1] + p[1]) for a, p in zip(acc, part)]
    return acc


def bwd_dn_plain(tmask, x, muT, ppT, values, dout, clamp: float, njac: int,
                 use_val: bool = True):
    d = x.shape[1]
    (dmp, dv), = _bwd_plain(tmask, x, muT, ppT, values, (dout,), clamp, njac,
                            use_val)
    return dmp[:d], dmp[d:], dv


def bwd_dn2_plain(tmask, x, muT, ppT, values, dout1, dout2, clamp: float,
                  njac: int, use_val: bool = True):
    d = x.shape[1]
    return tuple((dmp[:d], dmp[d:], dv) for dmp, dv in _bwd_plain(
        tmask, x, muT, ppT, values, (dout1, dout2), clamp, njac, use_val))


def bwd_dn3_plain(tmask, x, muT, ppT, values, dout1, dout2, dout3,
                  clamp: float, njac: int, data_rows: int,
                  use_val12: bool = True):
    """Blocks 1 and 2 over the first ``data_rows`` rows, block 3 (value
    only) over the rest."""
    d = x.shape[1]
    i = data_rows // (x.shape[0] // tmask.shape[0])
    r = slice(0, data_rows), slice(data_rows, None)
    blocks = _bwd_plain(tmask[:i], x[r[0]], muT, ppT, values,
                        (dout1[r[0]], dout2[r[0]]), clamp, njac, use_val12)
    blocks += _bwd_plain(tmask[i:], x[r[1]], muT, ppT, values,
                         (dout3[r[1]],), clamp, 0, True)
    return tuple((dmp[:d], dmp[d:], dv) for dmp, dv in blocks)


def bwd_dx_plain(tmask, x, muT, ppT, values, dout, clamp: float, njac: int):
    """dL/dx (B, d) for the cotangent ``dout`` of the forward's columns."""
    d, vdim = x.shape[1], values.shape[1]
    parts = []
    for tm, xb, (db,) in _row_blocks(tmask, x, dout):
        q = _tile_quantities(tm, xb, muT, ppT, d, clamp)
        gquad, gpd, _ = _cotangents(q, db, values, vdim, njac, True)
        parts.append(torch.stack([_dxj(gquad, gpd, q[3], ppT, d, j).sum(1)
                                  for j in range(d)], 1))
    return torch.cat(parts) if parts else x.new_zeros(x.shape)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def gsr_fwd(tmask, x, muT, ppT, values, clamp: float, njac: int, rad,
            split=None):
    """(B, (1+njac)*vdim) = [val | jac_0 | ... ], jac_k[:, a] = du_a/dx_k.
    ``rad`` (N,): each row's support radius dilated by 1e-3, -1 on dead
    and padded rows (``field.row_radius``), which the kernel's box test
    reads; the plain version does not need it. ``split`` S forces the
    blocks of a cluster that share a query tile, for tests and the smoke
    run only; by default ``fwd_split`` picks it."""
    _check_fwd_split(split)
    d, vdim, B, N = _check(tmask, x, muT, ppT, values, njac)
    check_rad(rad, x, N, (muT, ppT, values))
    if not x.is_cuda:
        return fwd_plain(tmask, x, muT, ppT, values, clamp, njac)
    lib = _lib()
    s = _launch_fwd_split(split, x, tmask)
    out = torch.empty((B, (1 + njac) * vdim), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gsr_fwd(_ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                         _ptr(rad), _ptr(values), _ptr(out), B, N, d, vdim,
                         njac, float(clamp), s, _stream(x))
    _raise_on(rc, "gsr_fwd")
    launches["gsr_fwd"] += 1
    fwd_shapes[(d, B, N)] = fwd_shapes.get((d, B, N), 0) + 1
    return out


def gsr_bwd_dn(tmask, x, muT, ppT, values, dout, clamp: float, njac: int,
               use_val: bool = True, split=None):
    """(dmuT (d, N), dppT (np, N), dv (N, vdim)) for one cotangent.

    ``split`` (W, S) forces the kernel's split along the query axis, for
    tests and the smoke run only; by default ``bwd_split`` picks it."""
    if not use_val and njac == 0:
        raise ValueError("use_val=False needs Jacobian columns")
    _check_split(split)
    d, vdim, B, N = _check(tmask, x, muT, ppT, values, njac, (dout,))
    if not x.is_cuda:
        return bwd_dn_plain(tmask, x, muT, ppT, values, dout, clamp, njac,
                            use_val)
    lib = _lib()
    w, s = _launch_split(split, x, tmask)
    dmp = torch.empty((d + ppT.shape[0], N), dtype=torch.float32,
                      device=x.device)
    dv = torch.empty((N, vdim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gsr_bwd_dn(_ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                            _ptr(values), _ptr(dout), _ptr(dmp), _ptr(dv),
                            B, N, d, vdim, njac, int(use_val), float(clamp),
                            w, s, _stream(x))
    _raise_on(rc, "gsr_bwd_dn")
    launches["gsr_bwd_dn"] += 1
    return dmp[:d], dmp[d:], dv


def gsr_bwd_dn2(tmask, x, muT, ppT, values, dout1, dout2, clamp: float,
                njac: int, use_val: bool = True, split=None):
    """((dmuT1, dppT1, dv1), (dmuT2, dppT2, dv2)) for two cotangent blocks
    in one sweep. ``use_val=False`` promises zero value cotangents;
    ``split`` as for ``gsr_bwd_dn``."""
    if not use_val and njac == 0:
        raise ValueError("use_val=False needs Jacobian columns")
    _check_split(split)
    d, vdim, B, N = _check(tmask, x, muT, ppT, values, njac, (dout1, dout2))
    if not x.is_cuda:
        return bwd_dn2_plain(tmask, x, muT, ppT, values, dout1, dout2,
                             clamp, njac, use_val)
    lib = _lib()
    w, s = _launch_split(split, x, tmask)
    nmp = d + ppT.shape[0]
    dmp1, dmp2 = (torch.empty((nmp, N), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    dv1, dv2 = (torch.empty((N, vdim), dtype=torch.float32, device=x.device)
                for _ in range(2))
    with torch.cuda.device(x.device):
        rc = lib.gsr_bwd_dn2(_ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                             _ptr(values), _ptr(dout1), _ptr(dout2),
                             _ptr(dmp1), _ptr(dv1), _ptr(dmp2), _ptr(dv2),
                             B, N, d, vdim, njac, int(use_val), float(clamp),
                             w, s, _stream(x))
    _raise_on(rc, "gsr_bwd_dn2")
    launches["gsr_bwd_dn2"] += 1
    return (dmp1[:d], dmp1[d:], dv1), (dmp2[:d], dmp2[d:], dv2)


def gsr_bwd_dx(tmask, x, muT, ppT, values, dout, clamp: float, njac: int):
    """dL/dx (B, d) for the cotangent ``dout`` (B, (1+njac)*vdim)."""
    d, vdim, B, N = _check(tmask, x, muT, ppT, values, njac, (dout,))
    if not x.is_cuda:
        return bwd_dx_plain(tmask, x, muT, ppT, values, dout, clamp, njac)
    lib = _lib()
    dx = torch.empty((B, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gsr_bwd_dx(_ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                            _ptr(values), _ptr(dout), _ptr(dx), B, N, d,
                            vdim, njac, float(clamp), _stream(x))
    _raise_on(rc, "gsr_bwd_dx")
    launches["gsr_bwd_dx"] += 1
    return dx


def gsr_bwd_dn3(tmask, x, muT, ppT, values, dout1, dout2, dout3,
                clamp: float, njac: int, data_rows: int,
                use_val12: bool = True):
    """Three (dmuT, dppT, dv) blocks in one sweep over the fused [data;
    boundary] rows: blocks 1 and 2 from the (val, jac) cotangents ``dout1``
    and ``dout2`` on the first ``data_rows`` rows (a multiple of the query
    tile), block 3 from the value-only cotangent ``dout3`` (B, vdim) on the
    rows after them. ``use_val12=False`` promises zero value cotangents in
    blocks 1 and 2."""
    if not use_val12 and njac == 0:
        raise ValueError("use_val12=False needs Jacobian columns")
    d, vdim, B, N = _check(tmask, x, muT, ppT, values, njac, (dout1, dout2))
    _check(tmask, x, muT, ppT, values, 0, (dout3,))
    tb = B // tmask.shape[0]
    if not (0 <= data_rows <= B and data_rows % TB == 0
            and data_rows % tb == 0):
        raise ValueError(f"data_rows {data_rows} must be a multiple of the "
                         f"query tile ({TB}) in [0, B={B}]")
    if not x.is_cuda:
        return bwd_dn3_plain(tmask, x, muT, ppT, values, dout1, dout2,
                             dout3, clamp, njac, data_rows, use_val12)
    lib = _lib()
    nmp = d + ppT.shape[0]
    dmp = [torch.empty((nmp, N), dtype=torch.float32, device=x.device)
           for _ in range(3)]
    dv = [torch.empty((N, vdim), dtype=torch.float32, device=x.device)
          for _ in range(3)]
    with torch.cuda.device(x.device):
        rc = lib.gsr_bwd_dn3(_ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                             _ptr(values), _ptr(dout1), _ptr(dout2),
                             _ptr(dout3), _ptr(dmp[0]), _ptr(dv[0]),
                             _ptr(dmp[1]), _ptr(dv[1]), _ptr(dmp[2]),
                             _ptr(dv[2]), B, N, d, vdim, njac,
                             int(use_val12), int(data_rows), float(clamp),
                             _stream(x))
    _raise_on(rc, "gsr_bwd_dn3")
    launches["gsr_bwd_dn3"] += 1
    return tuple((m[:d], m[d:], v) for m, v in zip(dmp, dv))


class _FusedGsrCentered(torch.autograd.Function):
    """Forward kernel with the backward kernels as its VJP — the port of
    the reference's ``fused_gsr_centered`` custom VJP. The dL/dx kernel
    runs only when x needs a gradient (the reference's static
    ``need_dx``)."""

    @staticmethod
    def forward(ctx, tmask, x, muT, ppT, values, rad, clamp, njac):
        ctx.save_for_backward(tmask, x, muT, ppT, values)
        ctx.clamp, ctx.njac = clamp, njac
        return gsr_fwd(tmask, x, muT, ppT, values, clamp, njac, rad)

    @staticmethod
    def backward(ctx, dout):
        tmask, x, muT, ppT, values = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dmuT = dppT = dv = None
        if ctx.needs_input_grad[1]:
            dx = gsr_bwd_dx(tmask, x, muT, ppT, values, dout, ctx.clamp,
                            ctx.njac)
        if any(ctx.needs_input_grad[2:5]):
            dmuT, dppT, dv = gsr_bwd_dn(tmask, x, muT, ppT, values, dout,
                                        ctx.clamp, ctx.njac)
        return None, dx, dmuT, dppT, dv, None, None, None


def fused_gsr_centered(tmask, x, muT, ppT, values, clamp: float, njac: int,
                       rad):
    """Differentiable in (muT, ppT, values) and in x. ``rad``: the rows'
    dilated radii of the forward's box test (``gsr_fwd``)."""
    return _FusedGsrCentered.apply(tmask, x, muT, ppT, values, rad,
                                   float(clamp), int(njac))
