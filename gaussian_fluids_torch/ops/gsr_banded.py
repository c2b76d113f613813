"""Banded value-only Gaussian field kernel: CUDA wrapper and its plain twin.

Ports the Pallas TPU kernel ``_val_banded_kernel`` of
``gaussian_fluids_tpu/ops/pallas/gsr_centered.py`` (launched from
``fused_gsr_value_banded``) to CUDA C++ for Hopper
(``csrc/gsr_banded.cu``):

  ``gsr_value_banded``  <- ``_val_banded_kernel``  value-only forward over
                                                     a window of Gaussian
                                                     tiles per query tile

It serves the density replay's RK4 stages (``ops/field.value_banded``):
queries sorted along x and Gaussians slab-major (``slab_sorted``), query
tile i sums the clamp-subtracted Gaussians of the ``band`` Gaussian tiles
starting at ``jlo[i]``. ``ok`` (an int32 device scalar) says whether
every tile that can reach a query tile lies in its window; where it does
not, the kernel sweeps the whole Gaussian axis in the same launch, so the
result is exact either way and no host read is needed.
``guard_failures()`` reads how many launches took that branch (a device
counter, read only when asked). The kernel walks, of a window, only the
tiles whose box (``lo``, ``hi``) meets the query tile's box, and of their
rows only the pairs inside the row's dilated box (``rad``): pure skips of
pairs with g < c, so the plain version, which sums the whole window,
computes the same function.

The wrapper dispatches on the device of ``x``: a CUDA tensor launches the
kernel (after validation; any failure raises), a CPU tensor runs the plain
PyTorch version below, which computes the same windowed sums in blocks of
query tiles. There is no fallback from the kernel to the plain version.
Both take the kernel's fixed tiles (``TB`` queries, ``TN`` Gaussians).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from gaussian_fluids_torch.ops import cuda_build
from gaussian_fluids_torch.ops.gsr_centered import (_F, _I, _P, _off_pairs,
                                                    _ptr, _raise_on,
                                                    _stream)

# The CUDA kernel's tiles: 128 queries (one thread each) x 64 Gaussians
# staged in shared memory (csrc/gsr_banded.cu). Window starts and the band
# are counted in these tiles on the card.
TB, TN = 128, 64

SOURCE = cuda_build.CSRC / "gsr_banded.cu"

launches: Dict[str, int] = {"gsr_value_banded": 0}
_guard_counts: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    launches["gsr_value_banded"] = 0
    for c in _guard_counts.values():
        c.zero_()


def guard_failures() -> int:
    """Launches that swept the whole Gaussian axis because the band did
    not cover a query tile's window (synchronises with the card)."""
    return sum(int(c.item()) for c in _guard_counts.values())


def _counter(device: torch.device) -> torch.Tensor:
    if device not in _guard_counts:
        _guard_counts[device] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return _guard_counts[device]


def support_cut(clamp: float) -> float:
    """A bound on quad above which g = exp(-quad/2) < clamp for certain,
    with a margin of 1e-3 relative far above f32 exp's error: the kernel
    skips the exp of such pairs and the result does not change."""
    q0 = -2.0 * math.log(clamp)
    return q0 + 1e-3 * max(q0, 1.0)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet. Returns
    (library path, compiler log; empty when already built)."""
    return cuda_build.build(SOURCE)[SOURCE.stem]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.banded_tile_sizes.argtypes = [ctypes.POINTER(_I)] * 2
        lib.banded_tile_sizes.restype = _I
        lib.gsr_value_banded.argtypes = [_P] * 11 + [_I] * 6 \
            + [_F, _F, _P]
        lib.gsr_value_banded.restype = _I
        tb, tn = _I(), _I()
        lib.banded_tile_sizes(ctypes.byref(tb), ctypes.byref(tn))
        if (tb.value, tn.value) != (TB, TN):
            raise RuntimeError(f"library tiles {(tb.value, tn.value)} != "
                               f"{(TB, TN)}")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _check(jlo, ok, x, muT, ppT, values, band):
    """Shapes common to both paths. Returns (d, vdim, B, N)."""
    if x.dim() != 2 or muT.dim() != 2 or ppT.dim() != 2 \
            or values.dim() != 2 or jlo.dim() != 1:
        raise ValueError("x, muT, ppT, values must be 2-D and jlo 1-D")
    B, d = x.shape
    N = muT.shape[1]
    vdim = values.shape[1]
    np_ = d * (d + 1) // 2 + 1
    if muT.shape[0] != d or ppT.shape != (np_, N) or values.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, muT {tuple(muT.shape)},"
                         f" ppT {tuple(ppT.shape)}, values "
                         f"{tuple(values.shape)} do not agree")
    if B % TB or N % TN or N == 0:
        raise ValueError(f"tiles ({TB}, {TN}) do not tile B={B}, N={N}")
    if jlo.shape[0] != B // TB:
        raise ValueError(f"jlo {tuple(jlo.shape)} != ({B // TB},)")
    if ok.numel() != 1:
        raise ValueError("ok must hold one element")
    if not 1 <= band <= N // TN:
        raise ValueError(f"band {band} not in [1, {N // TN}]")
    return d, vdim, B, N


def _check_kernel(jlo, ok, x, muT, ppT, values, rad, lo, hi, d, vdim, N):
    """What only the CUDA kernel reads: device, dtype, layout, the rows'
    radii and the tiles' boxes, and the 16-byte alignment of the rows its
    asynchronous copies stage."""
    if rad.shape != (N,) or lo.shape != (d, N // TN) \
            or hi.shape != lo.shape:
        raise ValueError(f"rad {tuple(rad.shape)}, lo {tuple(lo.shape)}, "
                         f"hi {tuple(hi.shape)}: want ({N},) and "
                         f"({d}, {N // TN})")
    ts = (jlo, ok, x, muT, ppT, rad, values, lo, hi)
    if any(t.device != x.device for t in ts):
        raise ValueError("all kernel operands must be on one device")
    if jlo.dtype != torch.int32 or ok.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in ts[2:]):
        raise ValueError("kernel operands: int32 jlo and ok, float32 "
                         "rest")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (muT, ppT, rad, values)):
        raise ValueError("muT, ppT, rad and values must be 16-byte aligned")
    if d not in (2, 3) or vdim not in (1, 2, 3):
        raise ValueError(f"the CUDA kernel takes d 2 or 3, vdim 1 to 3;"
                         f" got d={d}, vdim={vdim}")


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path and the card-side reference)
# ---------------------------------------------------------------------------

# Query-Gaussian pairs per block of the plain version: bounds its (rows,
# window) planes at the production chunk (262,144 queries x ~10^4 rows).
_PLAIN_PAIRS = 1 << 24


def window_weights(jlo, ok, x, muT, ppT, clamp: float, band: int):
    """Yields, per block of whole query tiles, (rows (t, W): the window's
    Gaussian rows per tile, mgv (t, TB, W): the clamp-subtracted weights,
    0 outside the support) — the quadratic form taken directly, as the
    kernel takes it. ``ok`` false makes every window the whole axis."""
    B, d = x.shape
    nnt = muT.shape[1] // TN
    if bool(ok.reshape(())):
        starts, width = jlo.long().clamp(0, nnt - band), band
    else:
        starts, width = torch.zeros_like(jlo, dtype=torch.long), nnt
    nb = d * (d + 1) // 2
    cols = torch.arange(width * TN, device=x.device)
    step = max(1, _PLAIN_PAIRS // (TB * width * TN))
    for t0 in range(0, B // TB, step):
        rows = starts[t0:t0 + step, None] * TN + cols        # (t, W)
        xb = x[t0 * TB:(t0 + step) * TB].reshape(-1, TB, d)   # (t, TB, d)
        delta = [xb[..., k, None] - muT[k][rows][:, None, :]
                 for k in range(d)]                          # (t, TB, W)
        pp = ppT[:, rows][:, :, None, :]                     # (np, t, 1, W)
        quad = pp[nb] + pp[0] * delta[0] * delta[0]
        for k in range(1, d):
            quad = quad + pp[k] * delta[k] * delta[k]
        for c, (i, j) in enumerate(_off_pairs(d)):
            quad = quad + (2.0 * pp[d + c]) * delta[i] * delta[j]
        g = torch.exp(-0.5 * quad)
        yield rows, torch.where(g >= clamp, g - clamp, torch.zeros_like(g))


def value_banded_plain(jlo, ok, x, muT, ppT, values, clamp: float,
                       band: int):
    """The kernel's windowed sums: ``window_weights`` times the window's
    values, one batched matmul per block of query tiles."""
    vdim = values.shape[1]
    return torch.cat([torch.bmm(mgv, values[rows]).reshape(-1, vdim)
                      for rows, mgv in window_weights(jlo, ok, x, muT, ppT,
                                                      clamp, band)])


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def gsr_value_banded(jlo, ok, x, muT, ppT, values, rad, lo, hi,
                     clamp: float, band: int, nvalid=None):
    """(B, vdim) field values of x-sorted queries over their windows.
    ``rad`` (N,), ``lo`` and ``hi`` (d, N/TN) are the rows' dilated radii
    and the tiles' boxes of ``field.banded_prep``; the first ``nvalid``
    rows of x (all by default) are real queries and set each query tile's
    box."""
    d, vdim, B, N = _check(jlo, ok, x, muT, ppT, values, band)
    if not x.is_cuda:
        return value_banded_plain(jlo, ok, x, muT, ppT, values, clamp, band)
    _check_kernel(jlo, ok, x, muT, ppT, values, rad, lo, hi, d, vdim, N)
    nvalid = B if nvalid is None else int(nvalid)
    lib = _lib()
    out = torch.empty((B, vdim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gsr_value_banded(
            _ptr(jlo), _ptr(ok), _ptr(x), _ptr(muT), _ptr(ppT), _ptr(rad),
            _ptr(values), _ptr(lo), _ptr(hi), _ptr(out),
            _ptr(_counter(x.device)), B, nvalid, N, d, vdim, int(band),
            float(clamp), support_cut(clamp), _stream(x))
    _raise_on(rc, "gsr_value_banded")
    launches["gsr_value_banded"] += 1
    return out
