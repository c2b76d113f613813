"""The triple-cotangent backward (``gsr_bwd_dn3``) with and without a box
test on the rows' radii before each pair's geometry, timed alternately on
one card at the Karman-2D projection geometry.

    python -m gaussian_fluids_torch.dn3_box_ab [--reps 30]

The kernel walks its pairs unboxed (``csrc/gsr_centered.cu``). This
script builds a second library from the same source with one more kernel,
the same column walk with ``BOXED`` set (``dn_column<D, VDIM, 3, true>``,
reading the prep's radii ``rad``), and at every split (W, S) the kernel
takes, the chosen one first: checks both against the plain twin (1e-4 of
its largest entry) and for two launches bitwise equal, then times them
in the order unboxed, boxed, boxed, unboxed (``utils.timing.time_ms``:
median of ``--reps`` launches queued behind a sleep kernel). Inputs: the seeded Karman-2D state's 512
data rows padded to the query tile, then the scene's 3072 boundary rows
(``utils.seeded_state.karman_boundary_rows``), seeded cotangents, the
value-only heads (``use_val12=False``) as the Karman projection runs them.
Prints one JSON line per split, a summary line, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess

import numpy as np
import torch

from gaussian_fluids_torch.ops import cuda_build
from gaussian_fluids_torch.ops import gsr_centered as gc
from gaussian_fluids_torch.utils.timing import time_ms

TOL = 1e-4

# The boxed kernel, appended to the centered kernels' own source.
_BOXED = r"""
namespace {
template <int D, int VDIM>
__global__ void __launch_bounds__(TN * MAX_W)
gsr_bwd_dn3_boxed_kernel(const int* __restrict__ tmask,
                         const float* __restrict__ x,
                         const float* __restrict__ muT,
                         const float* __restrict__ ppT,
                         const float* __restrict__ v,
                         const float* __restrict__ dout1,
                         const float* __restrict__ dout2,
                         const float* __restrict__ dout3, DnOut out, int B,
                         int N, int njac, int use_val12, int data_tiles,
                         float clamp, const float* __restrict__ rad) {
  dn_column<D, VDIM, 3, true>(tmask, x, muT, ppT, v, dout1, dout2, dout3,
                              out, B, N, njac, use_val12, data_tiles, clamp,
                              rad);
}
}  // namespace

extern "C" int gsr_bwd_dn3_boxed(
    const void* tmask, const void* x, const void* muT, const void* ppT,
    const void* v, const void* dout1, const void* dout2, const void* dout3,
    void* dmp1, void* dv1, void* dmp2, void* dv2, void* dmp3, void* dv3,
    int B, int N, int njac, int use_val12, int data_rows, float clamp,
    int W, int S, const void* rad, void* stream) {
  if (bad_bwd(B, N, 2, 2, njac, use_val12, W, S) || data_rows % TB)
    return cudaErrorInvalidValue;
  const DnOut out{{static_cast<float*>(dmp1), static_cast<float*>(dmp2),
                   static_cast<float*>(dmp3)},
                  {static_cast<float*>(dv1), static_cast<float*>(dv2),
                   static_cast<float*>(dv3)}};
  return launch_cluster(
      gsr_bwd_dn3_boxed_kernel<2, 2>, N / TN, S, TN * W,
      dn_smem_bytes<2, 2, 3>(), static_cast<cudaStream_t>(stream),
      static_cast<const int*>(tmask), static_cast<const float*>(x),
      static_cast<const float*>(muT), static_cast<const float*>(ppT),
      static_cast<const float*>(v), static_cast<const float*>(dout1),
      static_cast<const float*>(dout2), static_cast<const float*>(dout3),
      out, B, N, njac, use_val12, data_rows / TB, clamp,
      static_cast<const float*>(rad));
}
"""


def boxed_library():
    """Build (once per source) and load the boxed kernel's library: the
    centered source included whole, the boxed kernel after it (d = vdim =
    2 only, the Karman shapes)."""
    h = hashlib.sha256(gc.SOURCE.read_bytes() + _BOXED.encode())
    for header in sorted(cuda_build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    src = cuda_build.BUILD_DIR / f"dn3_box_ab_{h.hexdigest()[:16]}.cu"
    lib = src.with_suffix(".so")
    if not lib.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(f'#include "{gc.SOURCE}"\n{_BOXED}')
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    out.gsr_bwd_dn3_boxed.argtypes = [ctypes.c_void_p] * 14 \
        + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 2
    out.gsr_bwd_dn3_boxed.restype = ctypes.c_int
    return out


def geometry(dev):
    """The smoke's row-10 inputs: (args, douts, dout3, clamp, data_rows,
    rad)."""
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.utils.seeded_state import (
        karman_boundary_rows, karman_state)
    mix, spec, x = karman_state(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    xb = karman_boundary_rows(get_scene_2d("karman"), gen, 512, dev)[0]
    x_dp = field._pad_axis(x, gc.TB)
    rows = x_dp.shape[0]
    x_c, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
        mix, spec, torch.cat([x_dp, xb]), gc.TB, gc.TN, presorted=True)
    B = x_c.shape[0]
    rng = np.random.RandomState(5)
    douts = [torch.zeros((B, 6), device=dev) for _ in range(2)]
    for o in douts:
        o[:x.shape[0]] = torch.as_tensor(
            rng.randn(x.shape[0], 6).astype(np.float32) / 512, device=dev)
    dout3 = torch.zeros((B, 2), device=dev)
    dout3[rows:rows + xb.shape[0]] = torch.as_tensor(
        rng.randn(xb.shape[0], 2).astype(np.float32) / xb.shape[0],
        device=dev)
    args = (tmask, x_c, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous())
    return args, douts, dout3, spec.clamp_threshold, rows, rad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dn3_box_ab: needs a CUDA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = boxed_library()
    args, douts, dout3, clamp, rows, rad = geometry(dev)
    tmask, x = args[0], args[1]
    B, N = x.shape[0], args[2].shape[1]
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (*args, *douts, dout3)]

    def boxed(split):
        w, s = split or gc.bwd_split(*tmask.shape, gc._sm_count(0))
        dmp = [torch.empty((2 + 4, N), device=dev) for _ in range(3)]
        dv = [torch.empty((N, 2), device=dev) for _ in range(3)]
        outs = [ctypes.c_void_p(t.data_ptr()) for pair in zip(dmp, dv)
                for t in pair]
        rc = lib.gsr_bwd_dn3_boxed(
            *ptr, *outs, B, N, 2, 0, rows, float(clamp), w, s,
            ctypes.c_void_p(rad.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"gsr_bwd_dn3_boxed: CUDA error {rc}")
        return [t for m, v in zip(dmp, dv) for t in (m[:2], m[2:], v)]

    def unboxed(split):
        return [t for blk in gc.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2,
                                            rows, use_val12=False,
                                            split=split) for t in blk]

    want = [t for blk in gc.bwd_dn3_plain(*args, *douts, dout3, clamp, 2,
                                          rows, use_val12=False)
            for t in blk]
    splits = [None] + [(w, s) for w in gc.SPLIT_W for s in gc.SPLIT_S]
    res = {}
    for sp in splits:
        key = "chosen" if sp is None else f"{sp[0]}x{sp[1]}"
        for name, fn in (("unboxed", unboxed), ("boxed", boxed)):
            got, again = fn(sp), fn(sp)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"{name} at {key}: launches differ")
            for g, w_ in zip(got, want):
                err = float((g.double() - w_.double()).abs().max())
                if err > TOL * float(w_.abs().max()):
                    raise AssertionError(f"{name} at {key}: err {err}")
        ms = {"unboxed": [], "boxed": []}
        for name in ("unboxed", "boxed", "boxed", "unboxed"):
            fn = unboxed if name == "unboxed" else boxed
            ms[name].append(time_ms(lambda: fn(sp), a.reps))
        res[key] = {k: statistics.mean(v) for k, v in ms.items()}
        print(json.dumps({"split": key, **ms}), flush=True)
    print(json.dumps({"summary": res, "boxed_slower_at": sum(
        r["boxed"] > r["unboxed"] for k, r in res.items() if k != "chosen"),
        "splits": len(splits) - 1}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
