"""Fused RK4 backtrace kernel: CUDA wrapper and its plain twin.

Ports the Pallas TPU kernel ``_rk4_kernel`` of ``gaussian_fluids_tpu/ops/
pallas/rk4_fused.py`` (launched from ``fused_rk4``) to CUDA C++ for Hopper
(``csrc/rk4_fused.cu``):

  ``fused_rk4``  <- ``_rk4_kernel``  the four RK4 stages through a velocity
                                      field and (value, Jacobian) at the
                                      endpoint, in one launch

It serves the 2D covector target under ``GF_FUSED_RK4=1``
(``ops/field.rk4_valjac_fused``). The field is the clamp-subtracted
Gaussian sum of the centered kernels. The kernel culls at each stage's own
positions: a query tile of TB queries walks only the Gaussian tiles whose
boxes (``gsr_centered.tile_boxes``, as ``field.gaussian_tile_boxes``) meet
the tile's box there, and box-tests every pair on the rows' dilated radii
(``rad``, ``field.row_radius``); both tests skip only pairs outside the
support, so the plain twin, which reads neither, computes the same
function. Dead and padded Gaussian rows drop out through the +1e9 bias of
the packed precisions. Forward only; velocity fields only (vdim == d). S
blocks of a cluster share a query tile (``split``; ``gsr_centered.
fwd_split`` picks S from the shape by default).

The wrapper dispatches on the device of ``x``: a CUDA tensor launches the
kernel (after validation; any failure raises) on the queries padded to a
multiple of TB with copies of the last one (``pad_queries``), a CPU tensor
runs the plain PyTorch version below, which takes the same stages through
the centered forward's plain twin with every tile live. There is no
fallback from the kernel to the plain version. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from gaussian_fluids_torch.ops import cuda_build, gsr_centered
from gaussian_fluids_torch.ops.gsr_centered import (_F, _I, _P, _ptr,
                                                    _raise_on, _stream,
                                                    check_rad, fwd_plain,
                                                    tile_boxes)

SOURCE = cuda_build.CSRC / "rk4_fused.cu"
# the kernel's query tile and Gaussian tile (csrc/gsr_tile.cuh)
TB, TN = gsr_centered.TB, gsr_centered.TN

launches: Dict[str, int] = {"rk4_fused": 0}
# launches by (B, N), B the padded query count
shapes: Dict[Tuple[int, int], int] = {}


def reset_launches() -> None:
    launches["rk4_fused"] = 0
    shapes.clear()


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet. Returns
    (library path, compiler log; empty when already built)."""
    return cuda_build.build(SOURCE)[SOURCE.stem]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.rk4_tile_sizes.argtypes = [ctypes.POINTER(_I)] * 2
        lib.rk4_tile_sizes.restype = _I
        lib.rk4_fused.argtypes = [_P] * 9 + [_I] * 4 + [_F, _F, _I, _P]
        lib.rk4_fused.restype = _I
        tb, tn = _I(), _I()
        lib.rk4_tile_sizes(ctypes.byref(tb), ctypes.byref(tn))
        if (tb.value, tn.value) != (TB, TN):
            raise RuntimeError(f"library tiles {(tb.value, tn.value)} != "
                               f"{(TB, TN)}")
        _LIB = lib
    return _LIB


def _check(x, muT, ppT, values, njac):
    """Shapes common to both paths; on CUDA also device, dtype and
    layout. Returns (d, B, N)."""
    if x.dim() != 2 or muT.dim() != 2 or ppT.dim() != 2 or values.dim() != 2:
        raise ValueError("x, muT, ppT and values must be 2-D")
    B, d = x.shape
    N = muT.shape[1]
    if muT.shape[0] != d or ppT.shape != (d * (d + 1) // 2 + 1, N) \
            or values.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, muT {tuple(muT.shape)},"
                         f" ppT {tuple(ppT.shape)}, values "
                         f"{tuple(values.shape)} do not agree")
    if values.shape[1] != d:
        raise ValueError(f"RK4 advection needs a velocity field (vdim == d);"
                         f" got vdim={values.shape[1]}, d={d}")
    if njac not in (0, d):
        raise ValueError(f"njac must be 0 or d={d}, got {njac}")
    if x.is_cuda:
        ts = (x, muT, ppT, values)
        if any(t.device != x.device for t in ts):
            raise ValueError("all kernel operands must be on one device")
        if any(t.dtype != torch.float32 for t in ts):
            raise ValueError("kernel operands must be float32")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("kernel operands must be contiguous")
        if d not in (2, 3):
            raise ValueError(f"the CUDA kernel takes d 2 or 3, got {d}")
        if N % TN:
            raise ValueError(f"the CUDA kernel takes Gaussian rows in tiles "
                             f"of {TN}, got N={N}")
    return d, B, N


def _check_boxes(lo, hi, x, d, N):
    """lo, hi (d, N / TN); on CUDA also device, dtype and layout."""
    shape = (d, N // TN)
    if N % TN or any(not isinstance(t, torch.Tensor) or tuple(t.shape)
                     != shape for t in (lo, hi)):
        raise ValueError(f"tile boxes must be two {shape} tensors over "
                         f"tiles of {TN} rows")
    if x.is_cuda and any(t.device != x.device or t.dtype != torch.float32
                         or not t.is_contiguous() for t in (lo, hi)):
        raise ValueError("tile boxes: contiguous float32 on the queries' "
                         "device")


def pad_queries(x):
    """x padded to a multiple of TB rows with copies of its last row, so
    that the last query tile's box is its real queries' box."""
    pad = (-x.shape[0]) % TB
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, x.shape[1])])


def rk4_plain(x, muT, ppT, values, dt: float, clamp: float, njac: int):
    """(phi, valjac) with the kernel's arithmetic on whole planes."""
    live = torch.ones((x.shape[0], 1), dtype=torch.int32, device=x.device)

    def vel(p):
        return fwd_plain(live, p, muT, ppT, values, clamp, 0)

    v0 = vel(x)
    v1 = vel(x + 0.5 * dt * v0)
    v2 = vel(x + 0.5 * dt * v1)
    v3 = vel(x + dt * v2)
    phi = x + dt / 6.0 * (v0 + 2.0 * v1 + 2.0 * v2 + v3)
    return phi, fwd_plain(live, phi, muT, ppT, values, clamp, njac)


def fused_rk4(x, muT, ppT, values, dt: float, clamp: float, njac: int,
              rad, lo, hi, split=None):
    """(phi (B, d), valjac (B, (1+njac)*d)): the RK4 endpoint of the
    queries ``x`` through the velocity field (muT, ppT, values) over ``dt``
    (negative for a backtrace), and the (value | jac_0 | ...) columns at
    the endpoint. ``rad`` (N,): the rows' dilated radii of the kernel's
    per-pair box test; ``lo``, ``hi``: its Gaussian tiles' boxes
    (``tile_boxes`` of muT and rad); ``split`` S forces the
    blocks of a cluster that share a query tile, for tests and the smoke
    run only. The plain version reads none of them."""
    gsr_centered._check_fwd_split(split)
    d, B, N = _check(x, muT, ppT, values, njac)
    check_rad(rad, x, N, (muT, ppT, values))
    _check_boxes(lo, hi, x, d, N)
    if not x.is_cuda:
        return rk4_plain(x, muT, ppT, values, dt, clamp, njac)
    lib = _lib()
    x_p = pad_queries(x.contiguous())
    bp = x_p.shape[0]
    s = split if split is not None else gsr_centered.fwd_split(
        bp // TB, N // TN, gsr_centered._sm_count(x.device.index))
    phi = torch.empty((bp, d), dtype=torch.float32, device=x.device)
    vj = torch.empty((bp, (1 + njac) * d), dtype=torch.float32,
                     device=x.device)
    if bp == 0:
        return phi, vj
    with torch.cuda.device(x.device):
        rc = lib.rk4_fused(_ptr(x_p), _ptr(muT), _ptr(ppT), _ptr(rad),
                           _ptr(values), _ptr(lo), _ptr(hi), _ptr(phi),
                           _ptr(vj), bp, N, d, njac, float(dt),
                           float(clamp), s, _stream(x))
    _raise_on(rc, "rk4_fused")
    launches["rk4_fused"] += 1
    shapes[(bp, N)] = shapes.get((bp, N), 0) + 1
    return (phi, vj) if bp == B else (phi[:B], vj[:B])
