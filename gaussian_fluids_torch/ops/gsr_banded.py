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

Without ``jlo`` and ``ok`` each query tile takes its own window by the
same rule (``tile_windows``) and sweeps the whole axis only where that
window does not cover it; under ``profiling.counting()`` the counter
``banded_swept_tiles`` takes those tiles against all. With ``rk4`` (an
``RK4Stage``) the launch is a whole stage of the replay's position-only
RK4 (``advect.rk4_pos_stages``) on its own window: it returns the next
stage's points, and the last stage clamps its end points to the domain
and samples the old density there (``interp.trilinear_interp``) straight
into the output volume. The replay's chunk is then four launches.

The wrapper dispatches on the device of ``x``: a CUDA tensor launches the
kernel (after validation; any failure raises), a CPU tensor runs the plain
PyTorch version below, which computes the same windowed sums in blocks of
query tiles and the stage's arithmetic as the eager chain writes it.
There is no fallback from the kernel to the plain version. Both take the
kernel's fixed tiles (``TB`` queries, ``TN`` Gaussians). ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaussian_fluids_torch.ops import cuda_build, interp
from gaussian_fluids_torch.ops.gsr_centered import (_F, _I, _P, _off_pairs,
                                                    _ptr, _raise_on,
                                                    _stream)
from gaussian_fluids_torch.utils import profiling

# The CUDA kernel's tiles: 128 queries (one thread each) x 64 Gaussians
# staged in shared memory (csrc/gsr_banded.cu). Window starts and the band
# are counted in these tiles on the card.
TB, TN = 128, 64

SOURCE = cuda_build.CSRC / "gsr_banded.cu"

launches: Dict[str, int] = {"gsr_value_banded": 0}
_guard_counts: Dict[torch.device, torch.Tensor] = {}


class RK4Stage(NamedTuple):
    """Stage ``k`` (0-3) of ``advect.rk4_pos_stages(f, x0, dt)`` as the
    kernel's epilogue, the launch's ``x`` being that stage's points.
    ``total`` (shaped as ``x0``) holds v + 2 v1 + 2 v2 as the stages go
    (written at stage 0). The last stage samples ``density`` over ``domain`` at
    the clamped end points into the flat volume ``out`` from node
    ``offset`` on (nodes past its end are dropped)."""
    k: int
    dt: float
    x0: torch.Tensor
    total: torch.Tensor
    density: Optional[torch.Tensor] = None
    domain: tuple = ()
    out: Optional[torch.Tensor] = None
    offset: int = 0


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
        lib.gsr_value_banded.argtypes = [_P] * 12 + [_I] * 6 \
            + [_F, _F, _P]
        lib.gsr_value_banded.restype = _I
        lib.gsr_value_banded_rk4.argtypes = [_P] * 12 + [_I] * 5 \
            + [_F] * 3 + [ctypes.c_longlong] * 2 + [_P] * 3
        lib.gsr_value_banded_rk4.restype = _I
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
            or values.dim() != 2:
        raise ValueError("x, muT, ppT, values must be 2-D")
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
    if (jlo is None) != (ok is None):
        raise ValueError("give both jlo and ok, or neither")
    if jlo is not None:
        if jlo.dim() != 1 or jlo.shape[0] != B // TB:
            raise ValueError(f"jlo {tuple(jlo.shape)} != ({B // TB},)")
        if ok.numel() != 1:
            raise ValueError("ok must hold one element")
    if not 1 <= band <= N // TN:
        raise ValueError(f"band {band} not in [1, {N // TN}]")
    return d, vdim, B, N


def _check_rk4(rk: "RK4Stage", x, d, vdim, jlo):
    """What a stage launch takes: the kernel's own window, d = vdim = 3,
    ``x0`` and ``total`` shaped as ``x``, and at the last stage an f32
    density over a 3D domain and a flat f32 volume."""
    if jlo is not None or d != 3 or vdim != 3 or not 0 <= rk.k <= 3:
        raise ValueError("an RK4 stage takes stage 0-3 at d = vdim = 3, "
                         "on its own window (no jlo)")
    ts = (x, rk.x0, rk.total)
    if rk.k == 3:
        if rk.density is None or rk.density.dim() != 3 or rk.out is None \
                or rk.out.dim() != 1 or len(rk.domain) != 6 \
                or not 0 <= rk.offset < rk.out.shape[0]:
            raise ValueError("the last stage takes a (nx, ny, nz) density, "
                             "a 3D domain, a flat volume and an offset in "
                             "it")
        ts += (rk.density, rk.out)
    if rk.x0.shape != x.shape or rk.total.shape != x.shape:
        raise ValueError(f"x0 {tuple(rk.x0.shape)}, total "
                         f"{tuple(rk.total.shape)} != x {tuple(x.shape)}")
    if any(t.device != x.device or t.dtype != torch.float32
           or not t.is_contiguous() for t in ts):
        raise ValueError("an RK4 stage's tensors: contiguous float32 on "
                         "the device of x")


def _check_kernel(jlo, ok, x, muT, ppT, values, rad, lo, hi, d, vdim, N):
    """What only the CUDA kernel reads: device, dtype, layout, the rows'
    radii and the tiles' boxes, and the 16-byte alignment of the rows its
    asynchronous copies stage."""
    if rad.shape != (N,) or lo.shape != (d, N // TN) \
            or hi.shape != lo.shape:
        raise ValueError(f"rad {tuple(rad.shape)}, lo {tuple(lo.shape)}, "
                         f"hi {tuple(hi.shape)}: want ({N},) and "
                         f"({d}, {N // TN})")
    ts = (x, muT, ppT, rad, values, lo, hi)
    window = () if jlo is None else (jlo, ok)
    if any(t.device != x.device for t in ts + window):
        raise ValueError("all kernel operands must be on one device")
    if any(t.dtype != torch.int32 for t in window) or any(
            t.dtype != torch.float32 for t in ts):
        raise ValueError("kernel operands: int32 jlo and ok, float32 "
                         "rest")
    if not all(t.is_contiguous() for t in ts + window):
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


def tile_windows(x, b: int, nlo, nhi, band: int, tb: int = TB):
    """Each query tile's window, the rule the kernel follows for its own
    (``field.band_window`` reduces it to one guard): of ``x`` sorted along
    x with ``b`` real rows, per tile of ``tb`` the first Gaussian tile
    whose x extent (``nlo``, ``nhi``) meets the tile's x range, clipped
    into [0, nnt - band] (int32 ``jlo``), and whether every tile that
    meets it lies in the window (``covered``)."""
    nbt, nnt = x.shape[0] // tb, nlo.shape[0]
    xb = x[:, 0].reshape(nbt, tb)
    valid = (torch.arange(x.shape[0], device=x.device) < b).reshape(nbt, tb)
    blo = torch.where(valid, xb, math.inf).amin(dim=1)
    bhi = torch.where(valid, xb, -math.inf).amax(dim=1)
    meet = ((bhi[:, None] >= nlo[None, :])
            & (blo[:, None] <= nhi[None, :])).to(torch.int32)
    jlo = meet.argmax(dim=1).clamp(0, nnt - band)
    jhi = nnt - 1 - meet.flip(1).argmax(dim=1)
    covered = (meet.amax(dim=1) == 0) | (jhi < jlo + band)
    return jlo.to(torch.int32), covered


def value_banded_own(x, muT, ppT, values, lo, hi, clamp: float, band: int,
                     nvalid: int):
    """The kernel's sums with each query tile on its own window: the sums
    of ``value_banded_plain`` over the window where it covers the tile,
    over the whole axis where it does not. Returns (sums, covered)."""
    jlo, covered = tile_windows(x, nvalid, lo[0], hi[0], band)
    one = torch.ones(1, dtype=torch.int32, device=x.device)
    out = value_banded_plain(jlo, one, x, muT, ppT, values, clamp, band)
    if not bool(covered.all()):
        d, vdim = x.shape[1], values.shape[1]
        sel = torch.nonzero(~covered)[:, 0]
        xs = x.reshape(-1, TB, d)[sel].reshape(-1, d)
        out.view(-1, TB, vdim)[sel] = value_banded_plain(
            jlo[sel], torch.zeros_like(one), xs, muT, ppT, values, clamp,
            band).view(-1, TB, vdim)
    return out, covered


def rk4_stage_plain(v, rk: RK4Stage):
    """The stage epilogue on the velocities ``v`` of stage ``rk.k``,
    written as ``advect.rk4_pos_stages``, the clamp and
    ``interp.trilinear_interp`` write it: the next stage's points, or
    (last stage) ``rk.out`` with the sampled density in place."""
    k, dt = rk.k, rk.dt
    if k == 0:
        rk.total.copy_(v)
    elif k < 3:
        rk.total.copy_(rk.total + 2.0 * v)
    if k < 3:
        return rk.x0 + (dt * 0.5 if k < 2 else dt) * v
    phi = rk.x0 + dt / 6.0 * (rk.total + v)
    lo, hi = (torch.tensor(rk.domain[i::2], dtype=torch.float32,
                           device=phi.device) for i in (0, 1))
    bk = torch.minimum(torch.maximum(phi, lo), hi)
    m = min(bk.shape[0], rk.out.shape[0] - rk.offset)
    rk.out[rk.offset:rk.offset + m] = interp.trilinear_interp(
        rk.density, bk[:m], rk.domain)
    return rk.out


def _rk4_args(rk: RK4Stage):
    """(output, coefficient, shape, frame) of a stage launch: the next
    points, or the volume; the stage's f32 coefficient and the last
    stage's grid (``interp._frame``'s lo and spacing, the clamp's hi) from
    the host's doubles."""
    dt = float(rk.dt)
    coef = (dt * 0.5, dt * 0.5, dt, dt / 6.0)[rk.k]
    shape = (ctypes.c_int * 3)(1, 1, 1)
    frame = (ctypes.c_float * 9)()
    if rk.k < 3:
        return torch.empty_like(rk.x0), coef, shape, frame
    n = rk.density.shape
    shape[:] = list(n)
    frame[:] = ([rk.domain[2 * i] for i in range(3)]
                + [rk.domain[2 * i + 1] for i in range(3)]
                + [(rk.domain[2 * i + 1] - rk.domain[2 * i]) / (n[i] - 1)
                   for i in range(3)])
    return rk.out, coef, shape, frame


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def gsr_value_banded(jlo, ok, x, muT, ppT, values, rad, lo, hi,
                     clamp: float, band: int, nvalid=None,
                     rk4: Optional[RK4Stage] = None):
    """(B, vdim) field values of x-sorted queries over their windows, or
    with ``rk4`` the stage's output: the next stage's (B, 3) points, or
    at the last stage the volume it sampled into.
    ``rad`` (N,), ``lo`` and ``hi`` (d, N/TN) are the rows' dilated radii
    and the tiles' boxes of ``field.banded_prep``; the first ``nvalid``
    rows of x (all by default) are real queries and set each query tile's
    box. ``jlo`` and ``ok`` None: each tile on its own window. ``rk4``: the
    launch is that RK4 stage (own window), and returns its output instead
    (see the module's note)."""
    d, vdim, B, N = _check(jlo, ok, x, muT, ppT, values, band)
    if rk4 is not None:
        _check_rk4(rk4, x, d, vdim, jlo)
    nvalid = B if nvalid is None else int(nvalid)
    counted = jlo is None and profiling.counters_on()
    if not x.is_cuda:
        if jlo is not None:
            out = value_banded_plain(jlo, ok, x, muT, ppT, values, clamp,
                                     band)
        else:
            out, covered = value_banded_own(x, muT, ppT, values, lo, hi,
                                            clamp, band, nvalid)
            if counted:
                profiling.count("banded_swept_tiles",
                                (~covered).to(torch.int32), B // TB)
        return out if rk4 is None else rk4_stage_plain(out, rk4)
    _check_kernel(jlo, ok, x, muT, ppT, values, rad, lo, hi, d, vdim, N)
    lib = _lib()
    swept = torch.empty(B // TB, dtype=torch.int32, device=x.device) \
        if counted else None
    sp = None if swept is None else _ptr(swept)
    with torch.cuda.device(x.device):
        if rk4 is None:
            out = torch.empty((B, vdim), dtype=torch.float32,
                              device=x.device)
            rc = lib.gsr_value_banded(
                None if jlo is None else _ptr(jlo),
                None if ok is None else _ptr(ok), _ptr(x), _ptr(muT),
                _ptr(ppT), _ptr(rad), _ptr(values), _ptr(lo), _ptr(hi),
                _ptr(out), _ptr(_counter(x.device)), sp, B, nvalid, N, d,
                vdim, int(band), float(clamp), support_cut(clamp),
                _stream(x))
        else:
            out, coef, shape, frame = _rk4_args(rk4)
            rc = lib.gsr_value_banded_rk4(
                _ptr(x), _ptr(muT), _ptr(ppT), _ptr(rad), _ptr(values),
                _ptr(lo), _ptr(hi), _ptr(out), sp, _ptr(rk4.x0),
                _ptr(rk4.total),
                None if rk4.density is None else _ptr(rk4.density), B,
                nvalid, N, int(band), rk4.k, float(clamp),
                support_cut(clamp), coef, rk4.offset,
                0 if rk4.out is None else rk4.out.shape[0], shape, frame,
                _stream(x))
    _raise_on(rc, "gsr_value_banded")
    launches["gsr_value_banded"] += 1
    if swept is not None:
        profiling.count("banded_swept_tiles", swept, B // TB)
    return out
