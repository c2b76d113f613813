#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gaussian_fluids_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  build       compile csrc/gsr_centered.cu with nvcc into
              gaussian_fluids_torch/_build/ (skipped when already built)
  kernels     each CUDA kernel at Leapfrog-2D shapes (B=512 queries,
              N=6144 Gaussian rows, d=2, vdim=2) against its plain PyTorch
              version on the card; median time over 30 launches
  initialize  the leapfrog scene fitted at 71x71 = 5041 Gaussians through
              the user entry point ``gaussian_fluids_torch.initialize2d``
  advance     two frames (clone -> advect -> project) at dt .025 through
              ``gaussian_fluids_torch.advance2d``; losses and the
              divergence residual per frame
  check       the final field through the kernels against the plain dense
              field evaluation
Then the per-kernel summary (with launch counts from initialize + advance),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Solver output goes to a temporary
directory outside the checkout, deleted at the end. Any failure raises;
without a CUDA device the script exits non-zero before printing results.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

INIT_EPOCHS = 300      # the entry point's default is 10000
ADVANCE_EPOCHS = 300   # per phase and frame; the default is 20000
TIMED_LAUNCHES = 30

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations per query-Gaussian pair, counted from csrc/gsr_centered.cu
# (an FMA counts 2, exp and a compare 1 each, d = vdim = 2): every pair of a
# live tile pays the centered geometry; pairs inside the support (g >= c)
# pay the accumulation too.
OPS_GEOMETRY = 15
OPS_SUPPORT = {"gsr_fwd": 17, "gsr_bwd_dn": 74, "gsr_bwd_dn2": 126}

REPLACES = {
    "gsr_fwd": "gaussian_fluids_tpu/ops/pallas/gsr_centered.py:442",
    "gsr_bwd_dn": "gaussian_fluids_tpu/ops/pallas/gsr_centered.py:497",
    "gsr_bwd_dn2": "gaussian_fluids_tpu/ops/pallas/gsr_centered.py:559",
}
SOURCE = "gaussian_fluids_torch/csrc/gsr_centered.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=TIMED_LAUNCHES):
    """Median device milliseconds of ``fn`` over ``reps`` calls. A sleep
    kernel first keeps the card busy while the host queues every call and
    its events, so host overhead between calls does not enter the gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t   # the host's time to queue one call
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    # ~2e9 cycles a second: sleep for twice the queueing time of all calls
    torch.cuda._sleep(int(min(4e9, 1e7 + 2 * 2e9 * reps * host_s)))
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def compare(name, got, want, tol):
    """(max abs err, max abs err / max |want|); raises beyond ``tol``
    relative to the largest reference entry."""
    got = [g.float() for g in got]
    want = [w.float() for w in want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    rel = err / max(scale, 1e-30)
    if not (rel <= tol and all(torch.isfinite(g).all() for g in got)):
        raise AssertionError(f"{name}: max abs err {err} (relative {rel}) "
                             f"exceeds {tol}")
    return err, rel


def kernel_phase(device):
    from gaussian_fluids_torch.utils.seeded_state import leapfrog_state
    from gaussian_fluids_torch.ops import field, gsr_centered as gc

    mix, spec, x = leapfrog_state(device)
    clamp = spec.clamp_threshold
    x_p, _, _, mu_p, pp_p, v_p, tmask = field._centered_prep(
        mix, spec, x, gc.TB, gc.TN, presorted=True)
    muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                   v_p.contiguous())
    B, N = x_p.shape[0], muT.shape[1]
    rng = np.random.RandomState(1)
    dout = [torch.as_tensor(rng.randn(B, 6).astype(np.float32) / B,
                            device=device) for _ in range(2)]
    dout_val = torch.as_tensor(rng.randn(B, 2).astype(np.float32) / B,
                               device=device)
    # this run's data: pairs in live tiles, and pairs inside the support
    live_pairs = int(tmask.sum()) * gc.TB * gc.TN
    _, _, m, _ = gc._tile_quantities(tmask, x_p, muT, ppT, 2, clamp)
    support_pairs = int(m.sum())
    in_bytes = 4 * (tmask.numel() + x_p.numel() + muT.numel() + ppT.numel()
                    + v.numel())
    tol = 1e-4   # relative to the largest reference entry: f32 sums in
    #              another order and FMA contraction on the card

    cases = {
        "gsr_fwd": (
            [(lambda nj=nj: [gc.gsr_fwd(tmask, x_p, muT, ppT, v, clamp, nj)],
              lambda nj=nj: [gc.fwd_plain(tmask, x_p, muT, ppT, v, clamp,
                                          nj)])
             for nj in (2, 0)],
            B * 6 * 4),
        "gsr_bwd_dn": (
            [(lambda: list(gc.gsr_bwd_dn(tmask, x_p, muT, ppT, v, dout[0],
                                         clamp, 2)),
              lambda: list(gc.bwd_dn_plain(tmask, x_p, muT, ppT, v, dout[0],
                                           clamp, 2))),
             (lambda: list(gc.gsr_bwd_dn(tmask, x_p, muT, ppT, v, dout_val,
                                         clamp, 0)),
              lambda: list(gc.bwd_dn_plain(tmask, x_p, muT, ppT, v,
                                           dout_val, clamp, 0)))],
            4 * (dout[0].numel() + 6 * N + 2 * N)),
        "gsr_bwd_dn2": (
            [(lambda uv=uv: [t for blk in gc.gsr_bwd_dn2(
                tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 2,
                use_val=uv) for t in blk],
              lambda uv=uv: [t for blk in gc.bwd_dn2_plain(
                  tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 2,
                  use_val=uv) for t in blk])
             for uv in (False, True)],
            4 * (2 * dout[0].numel() + 2 * (6 * N + 2 * N))),
    }
    stats = {}
    for name, (variants, extra_bytes) in cases.items():
        errs = [compare(f"{name}[{i}]", k(), p(), tol)
                for i, (k, p) in enumerate(variants)]
        torch.cuda.synchronize()
        kern, plain = variants[0]   # the main path's variant is timed
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        ops = OPS_GEOMETRY * live_pairs + OPS_SUPPORT[name] * support_pairs
        nbytes = in_bytes + extra_bytes
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        stats[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": max(e for e, _ in errs),
            "max_rel_err": max(r for _, r in errs), "tolerance": tol,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "ops": ops, "bytes": nbytes,
        }
    return stats, {"B": B, "N": N, "live_pairs": live_pairs,
                   "support_pairs": support_pairs,
                   "live_tile_fraction": float(tmask.float().mean())}


def check_field(mix, spec):
    """The final field through the kernels vs the dense plain evaluation
    (an independent formulation: the expanded quadratic as one matmul)."""
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.utils.grids import grid_points_2d
    pts = torch.as_tensor(grid_points_2d(-5, 5, -5, 5, 64, 64),
                          device=mix.device)
    with torch.no_grad():
        v, j = field.value_and_jac(mix, spec, pts)
        vd, jd = field.value_and_jac_dense(mix, spec, pts)
    if v.shape != (4096, 2) or j.shape != (4096, 2, 2):
        raise AssertionError(f"field shapes {v.shape}, {j.shape}")
    # the dense reference carries the expanded form's cancellation,
    # ~1e-5 of the largest entry at these scales (docs/KERNELS.md)
    err, rel = compare("final field", [v, j], [vd, jd], 1e-3)
    return {"max_abs_err": err, "max_rel_err": rel, "tolerance": 1e-3,
            "max_abs_velocity": float(vd.abs().max())}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA GPU")
    from gaussian_fluids_torch import advance2d, initialize2d
    from gaussian_fluids_torch.ops import gsr_centered

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    lib, log = gsr_centered.build()
    gsr_centered._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib), "built_now": bool(log),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    t0 = time.perf_counter()
    stats, shapes = kernel_phase(device)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": shapes,
          "kernels": [{k: s[k] for k in ("name", "max_abs_err",
                                         "max_rel_err", "tolerance", "ms",
                                         "plain_ms", "bound_ms")}
                      for s in stats.values()]})

    tmp = tempfile.mkdtemp(prefix="gf_torch_smoke_")
    try:
        gsr_centered.reset_launches()
        t0 = time.perf_counter()
        mix, spec = initialize2d.main(
            ["--init_cond", "leapfrog", "--dir", tmp,
             "--max_epoch", str(INIT_EPOCHS)])
        torch.cuda.synchronize()
        init_launches = dict(gsr_centered.launches)
        emit({"phase": "initialize", "seconds": time.perf_counter() - t0,
              "epochs": INIT_EPOCHS, "n_gaussians": mix.n_alive(),
              "capacity": mix.capacity, "launches": init_launches})

        t0 = time.perf_counter()
        mix, spec, frames = advance2d.main(
            ["--init_cond", "leapfrog", "--dir", tmp, "--dt", ".025",
             "--last_time", ".05", "--max_epoch", str(ADVANCE_EPOCHS)])
        torch.cuda.synchronize()
        launches = dict(gsr_centered.launches)   # initialize + advance
        if len(frames) != 2:
            raise AssertionError(f"expected 2 frames, ran {len(frames)}")
        for f in frames:
            vals = list(f["clone"].values()) + list(f["project"].values())
            if not f["project"] or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"frame {f['frame']}: {f}")
            emit({"phase": "advance", "frame": f["frame"],
                  "seconds": f["seconds"], "n_gaussians": f["n_alive"],
                  "capacity": f["capacity"], "clone": f["clone"],
                  "project": f["project"],
                  "divergence_residual": f["project"]["loss_div"]})
        emit({"phase": "advance", "seconds": time.perf_counter() - t0,
              "frames": len(frames),
              "launches": {k: launches[k] - init_launches[k]
                           for k in launches}})

        t0 = time.perf_counter()
        written = sorted(os.listdir(tmp))
        want = [f"gaussian_velocity_{i}.pt" for i in range(3)]
        if written != want:
            raise AssertionError(f"checkpoints {written} != {want}")
        emit({"phase": "check", "seconds": time.perf_counter() - t0,
              **check_field(mix, spec)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, s in stats.items():
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        s["launches"] = launches[name]
    print(f"total seconds: {time.perf_counter() - t_all:.1f}")
    emit({"kernels": list(stats.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
