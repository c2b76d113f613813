"""Work-list ("cells") field kernels: CUDA wrappers and their plain twins.

Ports three Pallas TPU kernels of ``gaussian_fluids_tpu/ops/pallas/
gsr_cells.py`` to CUDA C++ for Hopper (``csrc/gsr_cells.cu``):

  ``cells_fwd``      <- ``_fwd_work_kernel``  value + Jacobian forward
  ``cells_bwd_dn``   <- ``_dn1_work_kernel``  per-Gaussian cotangents
  ``cells_bwd_dn2``  <- ``_dn2_work_kernel``  the same for two cotangent
                                              blocks sharing one recompute

They compute what the centered kernels of ``ops/gsr_centered.py``
compute, over only the live tile pairs of a flat work list
(``ops/spatial.flat_work_list``): ``(rows, cols)`` of the (B/TB, N/TN)
tile mask for the forward, ``(gtiles, qtiles)`` of its transpose for the
backward. ``ok`` (an int32 device scalar) says whether the lists hold
every live pair; where they do not, the kernels sweep the same fine tile
mask instead, on the device, so the result is exact either way and no
host read is needed. ``overflows()`` reads how many launches took that
branch (a device counter, read only when asked).

Each wrapper dispatches on the device of ``x``: a CUDA tensor launches
the kernel (after validation; any failure raises), a CPU tensor runs the
plain PyTorch version below, which evaluates the centered kernels' plain
twins on the mask the lists describe. ``launches`` counts kernel launches
per wrapper.

Every kernel box-tests each pair on the rows' dilated radii (``rad``,
``field.row_radius``) before its geometry; the plain twins do not read
them. The two backwards are one kernel over one or two cotangent blocks:
it splits each Gaussian tile's run over W workers a block and S blocks of
a cluster, as the centered backwards do (``gsr_centered.bwd_split`` picks
them; ``split=`` forces them in tests and the smoke run);
``run_worker_tiles`` gives each worker's share.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from gaussian_fluids_torch.ops import cuda_build
from gaussian_fluids_torch.ops import gsr_centered
from gaussian_fluids_torch.ops.gsr_centered import (_F, _I, _P, _ptr,
                                                    _raise_on, _stream)

TB, TN = gsr_centered.TB, gsr_centered.TN
# the backwards' kernel compacts a run (or a mask column) this many
# candidates at a time and splits each window in equal contiguous shares
# (the kernel's BWD_WINDOW, csrc/gsr_cells.cu)
BWD_WINDOW = 128
SOURCE = cuda_build.CSRC / "gsr_cells.cu"
NAMES = ("cells_fwd", "cells_bwd_dn", "cells_bwd_dn2")

launches: Dict[str, int] = {k: 0 for k in NAMES}
_overflow_counts: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for c in _overflow_counts.values():
        c.zero_()


def overflows() -> Dict[str, int]:
    """Launches per wrapper that swept the whole tile mask because the
    work list overflowed (synchronises with the card)."""
    out = {k: 0 for k in NAMES}
    for c in _overflow_counts.values():
        for k, n in zip(NAMES, c.tolist()):
            out[k] += n
    return out


def _counter(device: torch.device, name: str) -> torch.Tensor:
    if device not in _overflow_counts:
        _overflow_counts[device] = torch.zeros(len(NAMES), dtype=torch.int32,
                                               device=device)
    k = NAMES.index(name)
    return _overflow_counts[device][k:k + 1]


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, str]:
    """Compile the kernels if this source has not been built yet. Returns
    (library path, compiler log; empty when already built)."""
    return cuda_build.build(SOURCE)[SOURCE.stem]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.cells_tile_sizes.argtypes = [ctypes.POINTER(_I)] * 2
        lib.cells_tile_sizes.restype = _I
        lib.cells_fwd.argtypes = [_P, _P, _I] + [_P] * 9 + [_I] * 5 \
            + [_F, _P]
        lib.cells_fwd.restype = _I
        lib.cells_bwd_dn.argtypes = [_P, _P, _I] + [_P] * 11 + [_I] * 6 \
            + [_F, _I, _I, _P]
        lib.cells_bwd_dn.restype = _I
        lib.cells_bwd_dn2.argtypes = [_P, _P, _I] + [_P] * 14 + [_I] * 6 \
            + [_F, _I, _I, _P]
        lib.cells_bwd_dn2.restype = _I
        tb, tn = _I(), _I()
        lib.cells_tile_sizes(ctypes.byref(tb), ctypes.byref(tn))
        if (tb.value, tn.value) != (TB, TN):
            raise RuntimeError(f"library tiles {(tb.value, tn.value)} != "
                               f"{(TB, TN)}")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _check_lists(heads, items, ok, x):
    """A work list: ``heads`` row-sorted, ``items`` the live column or -1,
    ``ok`` one flag."""
    if heads.dim() != 1 or heads.shape != items.shape or heads.numel() < 1:
        raise ValueError(f"work lists {tuple(heads.shape)}, "
                         f"{tuple(items.shape)}: two equal 1-D lists")
    if ok.numel() != 1:
        raise ValueError("ok must hold one element")
    if x.is_cuda:
        ts = (heads, items, ok)
        if any(t.device != x.device for t in ts):
            raise ValueError("all kernel operands must be on one device")
        if any(t.dtype != torch.int32 for t in ts):
            raise ValueError("work lists and ok must be int32")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("work lists must be contiguous")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the card-side reference)
# ---------------------------------------------------------------------------

def list_mask(heads, items, shape) -> torch.Tensor:
    """The (R, C) int32 tile mask a work list describes: 1 at every live
    (heads[w], items[w])."""
    m = torch.zeros(shape, dtype=torch.int32, device=heads.device)
    keep = items >= 0
    m[heads[keep].long(), items[keep].long()] = 1
    return m


def run_worker_tiles(gtiles, qtiles, ok, tmask,
                     split: Tuple[int, int]) -> torch.Tensor:
    """(nnt, W S) int64: the live query tiles each worker of each Gaussian
    tile walks in the backwards' kernel under ``split``: the equal
    contiguous shares of each window of BWD_WINDOW candidates, which are
    the run's items while the lists hold every live pair (all live until
    the run's end) and the tile mask's column on overflow."""
    nbt, nnt = tmask.shape
    if bool(ok):
        live = list_mask(gtiles, qtiles, (nnt, nbt)).sum(1).cpu().long()
        base = torch.arange(0, max(nbt, 1), BWD_WINDOW)
        per_window = (live[:, None] - base[None, :]).clamp(0, BWD_WINDOW)
    else:
        col = (tmask != 0).cpu().long().T
        per_window = torch.stack(
            [col[:, b:b + BWD_WINDOW].sum(1)
             for b in range(0, max(nbt, 1), BWD_WINDOW)], 1)
    return gsr_centered.equal_shares(per_window, split[0] * split[1])


def _fwd_mask(rows, cols, ok, tmask):
    return list_mask(rows, cols, tmask.shape) if bool(ok) else tmask


def _bwd_mask(gtiles, qtiles, ok, tmask):
    if not bool(ok):
        return tmask
    return list_mask(gtiles, qtiles, tmask.T.shape).T.contiguous()


def cells_fwd_plain(rows, cols, ok, tmask, x, muT, ppT, values,
                    clamp: float, njac: int):
    return gsr_centered.fwd_plain(_fwd_mask(rows, cols, ok, tmask), x, muT,
                                  ppT, values, clamp, njac)


def cells_bwd_dn_plain(gtiles, qtiles, ok, tmask, x, muT, ppT, values,
                       dout, clamp: float, njac: int, use_val: bool = True):
    return gsr_centered.bwd_dn_plain(_bwd_mask(gtiles, qtiles, ok, tmask),
                                     x, muT, ppT, values, dout, clamp, njac,
                                     use_val)


def cells_bwd_dn2_plain(gtiles, qtiles, ok, tmask, x, muT, ppT, values,
                        dout1, dout2, clamp: float, njac: int,
                        use_val: bool = True):
    return gsr_centered.bwd_dn2_plain(
        _bwd_mask(gtiles, qtiles, ok, tmask), x, muT, ppT, values, dout1,
        dout2, clamp, njac, use_val)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def cells_fwd(rows, cols, ok, tmask, x, muT, ppT, values, clamp: float,
              njac: int, rad):
    """(B, (1+njac)*vdim) = [val | jac_0 | ... ] over the work list.
    ``rad`` (N,): each row's support radius dilated by 1e-3, -1 on dead
    and padded rows (``field.row_radius``), which the kernel's box test
    reads; the plain version does not need it."""
    d, vdim, B, N = gsr_centered._check(tmask, x, muT, ppT, values, njac)
    _check_lists(rows, cols, ok, x)
    gsr_centered.check_rad(rad, x, N, (muT, ppT, values))
    if not x.is_cuda:
        return cells_fwd_plain(rows, cols, ok, tmask, x, muT, ppT, values,
                               clamp, njac)
    lib = _lib()
    out = torch.empty((B, (1 + njac) * vdim), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.cells_fwd(_ptr(rows), _ptr(cols), rows.numel(), _ptr(ok),
                           _ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT),
                           _ptr(rad), _ptr(values), _ptr(out),
                           _ptr(_counter(x.device, "cells_fwd")), B, N, d,
                           vdim, njac, float(clamp), _stream(x))
    _raise_on(rc, "cells_fwd")
    launches["cells_fwd"] += 1
    return out


def cells_bwd_dn(gtiles, qtiles, ok, tmask, x, muT, ppT, values, dout,
                 clamp: float, njac: int, rad, use_val: bool = True,
                 split=None):
    """(dmuT (d, N), dppT (np, N), dv (N, vdim)) for one cotangent over
    the transposed work list. ``rad`` (N,): the rows' dilated radii
    (``field.row_radius``) of the kernel's box test; the plain version
    does not need it. ``split`` (W, S) forces the kernel's split of each
    run, for tests and the smoke run only; by default
    ``gsr_centered.bwd_split`` picks it."""
    if not use_val and njac == 0:
        raise ValueError("use_val=False needs Jacobian columns")
    gsr_centered._check_split(split)
    d, vdim, B, N = gsr_centered._check(tmask, x, muT, ppT, values, njac,
                                        (dout,))
    _check_lists(gtiles, qtiles, ok, x)
    gsr_centered.check_rad(rad, x, N, (x,))
    if not x.is_cuda:
        return cells_bwd_dn_plain(gtiles, qtiles, ok, tmask, x, muT, ppT,
                                  values, dout, clamp, njac, use_val)
    lib = _lib()
    w, s = gsr_centered._launch_split(split, x, tmask)
    dmp = torch.empty((d + ppT.shape[0], N), dtype=torch.float32,
                      device=x.device)
    dv = torch.empty((N, vdim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.cells_bwd_dn(
            _ptr(gtiles), _ptr(qtiles), gtiles.numel(), _ptr(ok),
            _ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT), _ptr(rad),
            _ptr(values), _ptr(dout), _ptr(dmp), _ptr(dv),
            _ptr(_counter(x.device, "cells_bwd_dn")), B, N, d, vdim, njac,
            int(use_val), float(clamp), w, s, _stream(x))
    _raise_on(rc, "cells_bwd_dn")
    launches["cells_bwd_dn"] += 1
    return dmp[:d], dmp[d:], dv


def cells_bwd_dn2(gtiles, qtiles, ok, tmask, x, muT, ppT, values, dout1,
                  dout2, clamp: float, njac: int, rad, use_val: bool = True,
                  split=None):
    """((dmuT1, dppT1, dv1), (dmuT2, dppT2, dv2)) for two cotangent blocks
    in one walk of the transposed work list. ``use_val=False`` promises
    zero value cotangents; ``rad`` and ``split`` as for
    ``cells_bwd_dn``."""
    if not use_val and njac == 0:
        raise ValueError("use_val=False needs Jacobian columns")
    gsr_centered._check_split(split)
    d, vdim, B, N = gsr_centered._check(tmask, x, muT, ppT, values, njac,
                                        (dout1, dout2))
    _check_lists(gtiles, qtiles, ok, x)
    gsr_centered.check_rad(rad, x, N, (x,))
    if not x.is_cuda:
        return cells_bwd_dn2_plain(gtiles, qtiles, ok, tmask, x, muT, ppT,
                                   values, dout1, dout2, clamp, njac,
                                   use_val)
    lib = _lib()
    w, s = gsr_centered._launch_split(split, x, tmask)
    nmp = d + ppT.shape[0]
    dmp1, dmp2 = (torch.empty((nmp, N), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    dv1, dv2 = (torch.empty((N, vdim), dtype=torch.float32, device=x.device)
                for _ in range(2))
    with torch.cuda.device(x.device):
        rc = lib.cells_bwd_dn2(
            _ptr(gtiles), _ptr(qtiles), gtiles.numel(), _ptr(ok),
            _ptr(tmask), _ptr(x), _ptr(muT), _ptr(ppT), _ptr(rad),
            _ptr(values), _ptr(dout1), _ptr(dout2), _ptr(dmp1), _ptr(dv1),
            _ptr(dmp2), _ptr(dv2), _ptr(_counter(x.device, "cells_bwd_dn2")),
            B, N, d, vdim, njac, int(use_val), float(clamp), w, s,
            _stream(x))
    _raise_on(rc, "cells_bwd_dn2")
    launches["cells_bwd_dn2"] += 1
    return (dmp1[:d], dmp1[d:], dv1), (dmp2[:d], dmp2[d:], dv2)


class _FusedGsrCells(torch.autograd.Function):
    """Work-list forward with the work-list backward as its VJP — the port
    of the JAX package's ``_cells_core`` custom VJP. No gradient for x."""

    @staticmethod
    def forward(ctx, lists, tmask, x, muT, ppT, values, rad, clamp, njac):
        rows, cols, gtiles, qtiles, ok = lists
        ctx.save_for_backward(gtiles, qtiles, ok, tmask, x, muT, ppT,
                              values, rad)
        ctx.clamp, ctx.njac = clamp, njac
        return cells_fwd(rows, cols, ok, tmask, x, muT, ppT, values, clamp,
                         njac, rad)

    @staticmethod
    def backward(ctx, dout):
        gtiles, qtiles, ok, tmask, x, muT, ppT, values, rad = \
            ctx.saved_tensors
        dmuT, dppT, dv = cells_bwd_dn(gtiles, qtiles, ok, tmask, x, muT,
                                      ppT, values, dout.contiguous(),
                                      ctx.clamp, ctx.njac, rad)
        return None, None, None, dmuT, dppT, dv, None, None, None


def fused_gsr_cells(lists, tmask, x, muT, ppT, values, rad, clamp: float,
                    njac: int):
    """Differentiable in (muT, ppT, values); x is a constant (the field's
    cells path refuses queries that require a gradient). ``rad``: the
    rows' dilated radii of the box tests (``cells_fwd``,
    ``cells_bwd_dn``)."""
    return _FusedGsrCells.apply(tuple(lists), tmask, x, muT, ppT, values,
                                rad, float(clamp), int(njac))
