#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gaussian_fluids_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  build         compile csrc/gsr_centered.cu, csrc/gsr_cells.cu,
                csrc/gsr_banded.cu and csrc/rk4_fused.cu with nvcc into
                gaussian_fluids_torch/_build/, one nvcc per source, started
                together (skipped when already built)
  kernels       each centered kernel at Leapfrog-2D shapes (B=512 queries,
                N=6144 Gaussian rows, d=2, vdim=2) against its plain
                PyTorch version on the card; median time over 30 launches;
                the forward (row 1) also at every split S of its cluster,
                two launches bitwise equal, each split timed
  kernels_3d    the three centered kernels at d=3 where the 3D path runs
                them (Leapfrog-3D: B=8192, N=1024), timed again at
                Ring-Collide shapes (B=8192, N=75,776) — the parameter
                backwards at both, as at Leapfrog-2D, split along the query
                axis: every split the kernel takes against the plain
                version, two launches bitwise equal, each split timed, the
                chosen split with its blocks and live query tiles per
                worker; the forward at every split at both shapes and at
                the Ring-Collide test grid's other batches (B=4096, the 2D
                projection's test chunk, and 32,768, the 3D path's) — and
                the three work-list (cells) kernels at Ring-Collide shapes,
                d=vdim=3, against their plain versions (the overflow
                branch of the cells forward and of row 6 too), the
                parameter backwards (rows 7 and 6, one kernel over one or
                two cotangent blocks) each at every split (W, S), both
                variants, two launches bitwise equal, each split timed,
                with the live-pair count, the live tile fraction, and the
                box-tested pairs against the pairs whose geometry the box
                tests let through
  kernels_density  the banded value kernel of the density replay at its
                production shapes (one 262,144-node chunk: the 512^3 grid's
                x-plane nearest 0.5, on the seeded Ring-Collide state,
                slab-major as the replay orders it) against its plain
                version, and its guard's full sweep (band 1) against the
                sufficient band's output, bitwise; the window's tiles
                tested against the tiles walked per query tile, and the
                rows the warps walk; then the same chunk on the mixture
                x-sorted, with its own band, timed beside it
  kernels_2d_rest  the dL/dx kernel, the triple-cotangent backward and the
                fused RK4 backtrace at Karman-2D shapes (B=512, N=24,576,
                the seeded Karman state; the triple backward over 512 data
                rows and the scene's 3072 boundary rows), and the dL/dx
                kernel again at Leapfrog-3D shapes (N=1024; B=1024 as the
                path's query_grad runs it, and B=8192), each against its
                plain version; the forward (row 1) at Karman-2D shapes at
                every split; the fused RK4 kernel at every split S, two
                launches bitwise equal, each split timed, with the
                Gaussian tiles its box test lets through at each stage
                and the pairs they hold
  initialize    the leapfrog scene fitted at 71x71 = 5041 Gaussians through
                the entry point ``gaussian_fluids_torch.initialize2d``
  advance       two frames (clone -> advect -> project) at dt .025 through
                ``gaussian_fluids_torch.advance2d``; losses and the
                divergence residual per frame
  check         the final 2D field through the kernels against the plain
                dense field evaluation in float64
  karman_init   the karman scene (400x60 = 24,000 Gaussians, capacity
                24,576, B=512) through ``initialize2d``: the inflow fit and
                the zero-dt projection that carves the cylinder
  karman        one frame at dt .01 through ``advance2d`` with
                GF_FUSED_RK4=1 (the covector target through the fused RK4
                kernel); losses, the divergence residual, the seconds of
                clone, advect and project, the advance domain after the frame
                against ``advance_domain_at(1, dt)``, and the final field
                against the dense one in float64
  covector_fused  on the Karman frame's mixture and one projection batch,
                the covector target with GF_FUSED_RK4=1 against =0 (the
                staged, tile-culled evaluations): agreement and both times
  epoch_heads   ``field.epoch_heads_grads`` at the Karman projection
                geometry (512 data rows, the cylinder's 512 and the edges'
                2560 boundary rows) against ``two_head_grads`` plus a
                separate boundary value backward: losses, gradients, times
  initialize3d  3D scenes fitted through ``gaussian_fluids_torch.initialize3d``:
                leapfrog (10^3 = 1000 Gaussians, the centered kernels at
                d=3) and ring_collide (40^3 = 64,000 Gaussians, capacity
                75,776, B=8192, the cells kernels)
  advance3d     one frame each (clone -> advect -> project) at dt .02
                through ``gaussian_fluids_torch.advance3d`` on the scene's
                128^3 test grid; losses and the divergence residual
  epoch_3d      one Ring-Collide projection epoch (seeded state, B=8192)
                under torch.profiler: device ms per epoch and the cells
                forward's share
  check3d       the final Ring-Collide field through the kernels against
                the dense plain evaluation in float64 on 4096 points
  query_grad    dL/dx through ``field.value_and_jac`` (Jacobian summed) and
                ``field.value`` on the card (the dL/dx kernel) against
                float64 dense autograd: on the Karman frame's mixture (d=2,
                one projection batch of 512 points) and the Leapfrog-3D
                frame's (d=3, 1024 points). dL/dx jumps where a pair crosses
                the support edge g = clamp, and f32 and f64 can place a pair
                within ~1e-6 of the edge on two sides (expected ~0.03 such
                pairs per 1e5 support pairs); the batches are kept at the
                scenes' widths and small in count
  kernels_fitted_3d  the parameter backwards at d=3 on the fitted
                Leapfrog-3D mixture (frame 1) and a seeded batch of 8192
                points in its domain: every split against the plain
                version, each split timed
  kernels_fitted_rc  rows 1, 6 and 7 on the fitted Ring-Collide mixture
                (frame 1): rows 7 and 6 on a seeded training batch of
                8192 points at every split against the plain version,
                each split timed; row 1 on that batch and on the middle
                32,768-node chunk of the scene's 128^3 test grid at every
                split
  density3d     the smoke replay through ``gaussian_fluids_torch.advance_density3d``
                (--density_res_multiplier 1: 128^3 nodes) on ring_collide's
                checkpoints 0 and 1: densities a and b, two steps each, .vti
                and pooled .npz files checked
  check_density the RK4 backtrace of 4096 seeded grid nodes through the
                banded kernel against the dense plain backtrace in float64 on
                frame 1's mixture, and the density sampled there
  density512    one advected_density step of one density at the production
                512^3 grid on frame 1's mixture, timed (fails on a guard
                failure), with the banded kernel's device ms of such a step;
                one timed write of its .vti as the replay writes it; and the
                card's busy share over a 128^3 step (torch.profiler)
Launches are counted per path: each path's counts are set to 0 just
before it and read just after; the 2D lines of the kernel summary carry
the Leapfrog-2D path's launches, the d=3 and cells lines the 3D path's;
the forward's are also counted per shape (d, B, N) on every path
(``launches_by_shape``; the Karman path's under ``karman_2d``).
The run fails if a kernel of a path was not launched there, or if a cells
work list overflowed at the default capacity. The banded kernel's path is
the replay (density3d and density512: its launches are their sum), the
fused RK4 kernel's the Karman frame, the triple backward's epoch_heads,
the dL/dx kernel's query_grad. Then the per-kernel summary (each bound
counted on the pairs the inputs need, those with g >= c, with the bound
of the pairs the kernel walks beside it), the card's name and power
limit, and as the last line
``{"ok": true, "device": {...}}``. Solver output goes to a temporary
directory outside the checkout, deleted at the end. Any failure raises;
without a CUDA device the script exits non-zero before printing results.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

INIT_EPOCHS = 200      # 2D; the entry point's default is 10000
ADVANCE_EPOCHS = 200   # 2D, per phase and frame; the default is 20000
INIT3D_EPOCHS = 200    # the 3D entry point's default is 500
ADVANCE3D_EPOCHS = 200  # 3D, per phase; the default is 20000
TIMED_LAUNCHES = 30
PLAIN_LAUNCHES_3D = 3  # the plain versions take ~0.1-1 s at Ring-Collide
TOL = 1e-4   # relative to the largest reference entry: f32 sums in another
#              order and FMA contraction on the card

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations per query-Gaussian pair, counted from csrc/gsr_tile.cuh (an
# FMA counts 2, exp and a compare 1 each): every pair of a live tile pays
# the centered geometry; pairs inside the support (g >= c) pay the
# accumulation too. d = vdim = 2 as counted for the first slice; d = vdim =
# 3 with njac = 3 and the value cotangents read (the 3D main path's
# variants: the projection's helicity head reads the value).
OPS_GEOMETRY = {2: 15, 3: 27}
OPS_SUPPORT = {(2, "fwd"): 17, (2, "bwd_dn"): 74, (2, "bwd_dn2"): 126,
               (3, "fwd"): 34, (3, "bwd_dn"): 136, (3, "bwd_dn2"): 272}
# The banded kernel (csrc/gsr_banded.cu, d = vdim = 3): a pair's geometry
# is dx (3), the direct quadratic form (6 terms of a multiply and an FMA:
# 18) and the cut compare (1); a pair inside the support also pays
# -quad/2, the exp and the support compare (3), then g - c and 3 FMAs (7).
OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT = 22, 10
# The last three kernels, counted the same way from csrc/gsr_tile.cuh
# (pair_cotangents, pair_dx) and csrc/rk4_fused.cu. dL/dx, per pair in the
# support with njac = d: the value and Jacobian cotangents against v
# (VDIM (1 + d) FMAs), gg (d FMAs), gquad and gpd (2 + d), dx_k (2 + 2 d
# each) and the sums. The triple backward's data tiles pay the dual
# backward's count, its boundary tiles the value-only backward's: s1 (2
# VDIM), gquad (2), dv (1 + 2 VDIM), dmu (3 d), the precisions and the bias
# (3 d + 4 per off-diagonal + 1). The fused RK4 kernel: every pair of
# every stage pays the geometry; in the support a stage pays g - c and
# VDIM FMAs (1 + 2 VDIM), the endpoint's Jacobian stage the forward's.
OPS_SUPPORT.update({(2, "bwd_dx"): 36, (3, "bwd_dx"): 65,
                    (2, "bwd_dn_val"): 28, (3, "bwd_dn_val"): 46,
                    (2, "rk4_stage"): 5, (3, "rk4_stage"): 7})
KARMAN_INIT_EPOCHS = 200     # fit and the zero-dt projection; default 10000
KARMAN_ADVANCE_EPOCHS = 200  # per phase; the default is 20000
KARMAN_DT = 0.01             # the 2D CLI's default
COVECTOR_RTOL, COVECTOR_ATOL = 1e-3, 1e-5  # fused vs staged target, as the
#                                            JAX package's test holds them

DENSITY_DT = 0.02
DENSITY_TOL_POS = 1e-5    # backtrace positions, domain units: f32 grid
#                           coordinates in [0, 1] (spacing 6e-8) moved by
#                           dt = .02 times an f32 velocity
DENSITY_TOL_SAMPLE = 2e-3  # a sampled density: DENSITY_TOL_POS times the
#                            steepest step of an indicator seed, 1 over one
#                            cell of the 128^3 grid (h = 1/127), rounded up
NO_LIBRARY_BANDED = ("no single PyTorch call computes the clamp-masked "
                     "Gaussian sum over a per-query-tile window")

PALLAS = "gaussian_fluids_tpu/ops/pallas/"
REPLACES = {
    "gsr_fwd": PALLAS + "gsr_centered.py:442",
    "gsr_bwd_dn": PALLAS + "gsr_centered.py:497",
    "gsr_bwd_dn2": PALLAS + "gsr_centered.py:559",
    "cells_fwd": PALLAS + "gsr_cells.py:107",
    "cells_bwd_dn": PALLAS + "gsr_cells.py:228",
    "cells_bwd_dn2": PALLAS + "gsr_cells.py:199",
    "gsr_value_banded": PALLAS + "gsr_centered.py:701",
    "gsr_bwd_dx": PALLAS + "gsr_centered.py:473",
    "gsr_bwd_dn3": PALLAS + "gsr_centered.py:400",
    "rk4_fused": PALLAS + "rk4_fused.py:110",
}
SOURCES = {"gsr": "gaussian_fluids_torch/csrc/gsr_centered.cu",
           "cells": "gaussian_fluids_torch/csrc/gsr_cells.cu",
           "banded": "gaussian_fluids_torch/csrc/gsr_banded.cu",
           "rk4": "gaussian_fluids_torch/csrc/rk4_fused.cu"}
NO_LIBRARY = ("no single PyTorch call computes the clamp-masked, "
              "tile-culled Gaussian sum and its Jacobian or cotangents")


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
    for _ in range(min(reps, 3)):
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
    got = [g.double() for g in got]
    want = [w.double() for w in want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    rel = err / max(scale, 1e-30)
    if not (rel <= tol and all(torch.isfinite(g).all() for g in got)):
        raise AssertionError(f"{name}: max abs err {err} (relative {rel}) "
                             f"exceeds {tol}")
    return err, rel


def ptxas_summary(log):
    """['kernel<D,VDIM[,NCOT][,STAGE]>: R registers, S bytes spilled', ...]
    from ptxas's -v report."""
    out, name, spill = [], "?", 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            t = re.search(r"\d([a-z][a-z0-9_]*_kernel)ILi(\d)E(?:Li(\d)E)?"
                          r"(?:Li(\d)E)?(?:Lb(\d)E)?", m.group(1))
            name = (f"{t.group(1)}<{','.join(g for g in t.groups()[1:] if g)}>"
                    if t else m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
    return out


def pair_ops(geometry, support_ops, walked_pairs, support_pairs):
    """(ops the inputs need, ops of the pairs the kernel walks). Counted on
    need, only a pair inside the support (g >= c) does work: its geometry
    and its accumulation; a kernel pays at least the geometry of every
    pair it walks. Every row's bound is the first, so a kernel that culls
    better than its walk can never read faster than its bound."""
    return ((geometry + support_ops) * support_pairs,
            geometry * walked_pairs + support_ops * support_pairs)


def _bound(ops, nbytes):
    """(ms, 'operations' | 'bytes'): the larger of ops over the f32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _entry(name, route_src, errs, ms, plain_ms, ops, nbytes, walked_pairs,
           support_pairs, note=NO_LIBRARY):
    """The summary line of one kernel: ``ops`` is ``pair_ops``'s (need,
    walked) pair; the bound is on need, the walked bound beside it."""
    bound_ms, bound_by = _bound(ops[0], nbytes)
    return {
        "name": name, "route": "cuda", "source": SOURCES[route_src],
        "replaces": REPLACES[name.split("[")[0]],
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": max(r for _, r in errs), "tolerance": TOL,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library_note": note, "ops": ops[0],
        "bytes": nbytes, "support_pairs": support_pairs,
        "walked_pairs": walked_pairs, "walked_ops": ops[1],
        "walked_bound_ms": _bound(ops[1], nbytes)[0],
    }


def _run_cases(cases, d, live_pairs, support_pairs, in_bytes, plain_reps,
               tag=""):
    """Compare every variant of every kernel with its plain version, time
    the main path's variant (the first), and build the summary entries."""
    stats = {}
    for name, (src, key, variants, extra_bytes, walk_bytes) in cases.items():
        errs = [compare(f"{name}{tag}[{i}]", k(), p(), TOL)
                for i, (k, p) in enumerate(variants)]
        torch.cuda.synchronize()
        kern, plain = variants[0]
        ms = time_ms(kern)
        plain_ms = time_ms(plain, plain_reps)
        ops = pair_ops(OPS_GEOMETRY[d], OPS_SUPPORT[(d, key)], live_pairs,
                       support_pairs)
        stats[name + tag] = _entry(name + tag, src, errs, ms, plain_ms, ops,
                                   in_bytes + extra_bytes + walk_bytes,
                                   live_pairs, support_pairs)
    return stats


def _support_pairs(gc, tmask, x_p, muT, ppT, d, clamp):
    n = 0
    for tm, xb, _ in gc._row_blocks(tmask, x_p):
        n += int(gc._tile_quantities(tm, xb, muT, ppT, d, clamp)[2].sum())
    return n


def _split_key(split):
    return "chosen" if split is None else f"{split[0]}x{split[1]}"


def split_reports(cases, tmask, names=("gsr_bwd_dn", "gsr_bwd_dn2")):
    """Rows 2 and 3 at one shape, split along the query axis: every
    variant at the chosen split and at every split the kernel takes
    against its plain twin (TOL), two launches of each bitwise equal; the
    main variant timed at every split in this call; the chosen split, the
    blocks it launches and the live query tiles per worker (mean, max)."""
    from gaussian_fluids_torch.ops import gsr_centered as gc
    splits = [None] + [(w, s) for w in gc.SPLIT_W for s in gc.SPLIT_S]
    chosen = gc.bwd_split(*tmask.shape, gc._sm_count(0))
    shares = gc.worker_tiles(tmask, chosen).double()
    out = {}
    for name in names:
        variants = cases[name][2]
        errs = []
        for i, (kern, plain) in enumerate(variants):
            want = plain()
            for split in splits:
                a, b = kern(split=split), kern(split=split)
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"{name}[{i}] at split {split}: two "
                                         f"launches differ")
                errs.append(compare(f"{name}[{i}, {_split_key(split)}]", a,
                                    want, TOL)[1])
        torch.cuda.synchronize()
        kern = variants[0][0]
        ms = {_split_key(sp): time_ms(lambda sp=sp: kern(split=sp))
              for sp in splits}
        out[name] = {
            "split": list(chosen), "blocks": tmask.shape[1] * chosen[1],
            "threads_per_block": gc.TN * chosen[0],
            "worker_tiles_mean": float(shares.mean()),
            "worker_tiles_max": int(shares.max()),
            "ms": ms["chosen"], "ms_1x1": ms["1x1"], "ms_by_split": ms,
            "splits_checked": len(splits) * len(variants),
            "max_rel_err_splits": max(errs), "bitwise_repeat": True}
    return out


def _fwd_key(split):
    return "chosen" if split is None else str(split)


def fwd_split_report(args, rad, clamp):
    """Row 1 at one shape, split along the Gaussian axis: both variants
    (njac = d, 0) at the chosen split and at every split S the kernel takes
    against the plain twin (TOL), two launches of each bitwise equal; the
    main variant timed at every split in this call; the chosen split and
    the blocks it launches."""
    from gaussian_fluids_torch.ops import gsr_centered as gc
    tmask, x_p = args[0], args[1]
    d = x_p.shape[1]
    splits = [None] + list(gc.SPLIT_S)
    errs = []
    for nj in (d, 0):
        want = gc.fwd_plain(*args, clamp, nj)
        for sp in splits:
            a, b = (gc.gsr_fwd(*args, clamp, nj, rad, split=sp)
                    for _ in range(2))
            if not torch.equal(a, b):
                raise AssertionError(f"gsr_fwd[{nj}] at split {sp}: two "
                                     f"launches differ")
            errs.append(compare(f"gsr_fwd[{nj}, S={_fwd_key(sp)}]", [a],
                                [want], TOL)[1])
    torch.cuda.synchronize()
    ms = {_fwd_key(sp): time_ms(lambda sp=sp: gc.gsr_fwd(
        *args, clamp, d, rad, split=sp)) for sp in splits}
    chosen = gc.fwd_split(*tmask.shape, gc._sm_count(0))
    return {"split": chosen, "blocks": tmask.shape[0] * chosen,
            "ms": ms["chosen"], "ms_1": ms["1"], "ms_by_split": ms,
            "splits_checked": 2 * len(splits),
            "max_rel_err_splits": max(errs), "bitwise_repeat": True}


def fwd_shape_entry(args, rad, clamp, plain_reps=PLAIN_LAUNCHES_3D):
    """Row 1's summary at one more shape: every split (fwd_split_report),
    the plain twin's time, and the bound on need beside the walked bound,
    with the pairs whose geometry the box test lets through."""
    from gaussian_fluids_torch.ops import gsr_centered as gc
    tmask, x_p, muT, ppT, v = args
    d, B, N = x_p.shape[1], x_p.shape[0], muT.shape[1]
    rep = fwd_split_report(args, rad, clamp)
    plain_ms = time_ms(lambda: gc.fwd_plain(*args, clamp, d), plain_reps)
    live = int(tmask.sum()) * gc.TB * gc.TN
    sup = _support_pairs(gc, tmask, x_p, muT, ppT, d, clamp)
    nbytes = 4 * (tmask.numel() + x_p.numel() + muT.numel() + ppT.numel()
                  + v.numel() + B * (1 + d) * v.shape[1])
    ops = pair_ops(OPS_GEOMETRY[d], OPS_SUPPORT[(d, "fwd")], live, sup)
    e = _entry("gsr_fwd", "gsr", [(0.0, rep["max_rel_err_splits"])],
               rep["ms"], plain_ms, ops, nbytes, live, sup)
    return {"B": B, "N": N, "d": d,
            "live_tile_fraction": float(tmask.float().mean()),
            "box_pairs": _box_pairs(tmask, x_p, muT, rad, gc.TB, gc.TN),
            **{k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "walked_bound_ms", "support_pairs",
                                 "walked_pairs")},
            **{k: rep[k] for k in ("split", "blocks", "ms_1", "ms_by_split",
                                   "max_rel_err_splits")}}


def cells_split_report(lt, args, rad, clamp, douts):
    """Rows 7 and 6, the cells parameter backwards (one kernel over one or
    two cotangent blocks), at one state, split along each run: each row's
    variants (row 7: njac = 3 with the value cotangent, and njac = 0; row
    6: njac = 3 with and without the value cotangents) at the chosen split
    and at every split the kernel takes against the plain twin (TOL), two
    launches of each bitwise equal; the main variant timed at every split
    in this call; the chosen split, its blocks and the live query tiles per
    worker (mean, max)."""
    from gaussian_fluids_torch.ops import gsr_cells as gk
    from gaussian_fluids_torch.ops import gsr_centered as gc
    tmask = args[0]
    splits = [None] + [(w, s) for w in gc.SPLIT_W for s in gc.SPLIT_S]
    rows = {
        "cells_bwd_dn": [
            (lambda sp, o=o, nj=nj: list(gk.cells_bwd_dn(
                *lt, *args, o, clamp, nj, rad, split=sp)),
             lambda o=o, nj=nj: list(gk.cells_bwd_dn_plain(
                 *lt, *args, o, clamp, nj)))
            for nj, o in ((3, douts[0]), (0, douts[0][:, :3].contiguous()))],
        "cells_bwd_dn2": [
            (lambda sp, uv=uv: _flat(gk.cells_bwd_dn2(
                *lt, *args, *douts, clamp, 3, rad, use_val=uv, split=sp)),
             lambda uv=uv: _flat(gk.cells_bwd_dn2_plain(
                 *lt, *args, *douts, clamp, 3, use_val=uv)))
            for uv in (True, False)],
    }
    chosen = gc.bwd_split(*tmask.shape, gc._sm_count(0))
    shares = gk.run_worker_tiles(*lt, tmask, chosen).double()
    out = {}
    for name, variants in rows.items():
        errs = []
        for i, (kern, plain) in enumerate(variants):
            want = plain()
            for sp in splits:
                a, b = kern(sp), kern(sp)
                if not all(torch.equal(p, q) for p, q in zip(a, b)):
                    raise AssertionError(f"{name}[{i}] at split {sp}: two "
                                         f"launches differ")
                errs.append(compare(f"{name}[{i}, {_split_key(sp)}]", a,
                                    want, TOL)[1])
        torch.cuda.synchronize()
        kern = variants[0][0]
        ms = {_split_key(sp): time_ms(lambda sp=sp: kern(sp))
              for sp in splits}
        out[name] = {
            "split": list(chosen), "blocks": tmask.shape[1] * chosen[1],
            "threads_per_block": gc.TN * chosen[0],
            "worker_tiles_mean": float(shares.mean()),
            "worker_tiles_max": int(shares.max()),
            "ms": ms["chosen"], "ms_1x1": ms["1x1"], "ms_by_split": ms,
            "best_split": min((k for k in ms if k != "chosen"),
                              key=ms.get),
            "splits_checked": len(splits) * len(variants),
            "max_rel_err_splits": max(errs), "bitwise_repeat": True}
    return out


def kernel_phase(device):
    """PR 4's 2D kernel checks at Leapfrog-2D shapes (unchanged cases),
    with rows 2 and 3 at every split."""
    from gaussian_fluids_torch.utils.seeded_state import leapfrog_state
    from gaussian_fluids_torch.ops import field, gsr_centered as gc

    mix, spec, x = leapfrog_state(device)
    clamp = spec.clamp_threshold
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
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
    support_pairs = _support_pairs(gc, tmask, x_p, muT, ppT, 2, clamp)
    in_bytes = 4 * (tmask.numel() + x_p.numel() + muT.numel() + ppT.numel()
                    + v.numel())
    cases = {
        "gsr_fwd": ("gsr", "fwd",
            [(lambda nj=nj: [gc.gsr_fwd(tmask, x_p, muT, ppT, v, clamp, nj,
                                        rad)],
              lambda nj=nj: [gc.fwd_plain(tmask, x_p, muT, ppT, v, clamp,
                                          nj)])
             for nj in (2, 0)],
            B * 6 * 4, 0),
        "gsr_bwd_dn": ("gsr", "bwd_dn",
            [(lambda split=None: list(gc.gsr_bwd_dn(
                tmask, x_p, muT, ppT, v, dout[0], clamp, 2, split=split)),
              lambda: list(gc.bwd_dn_plain(tmask, x_p, muT, ppT, v, dout[0],
                                           clamp, 2))),
             (lambda split=None: list(gc.gsr_bwd_dn(
                 tmask, x_p, muT, ppT, v, dout_val, clamp, 0, split=split)),
              lambda: list(gc.bwd_dn_plain(tmask, x_p, muT, ppT, v,
                                           dout_val, clamp, 0)))],
            4 * (dout[0].numel() + 6 * N + 2 * N), 0),
        "gsr_bwd_dn2": ("gsr", "bwd_dn2",
            [(lambda uv=uv, split=None: [t for blk in gc.gsr_bwd_dn2(
                tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 2,
                use_val=uv, split=split) for t in blk],
              lambda uv=uv: [t for blk in gc.bwd_dn2_plain(
                  tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 2,
                  use_val=uv) for t in blk])
             for uv in (False, True)],
            4 * (2 * dout[0].numel() + 2 * (6 * N + 2 * N)), 0),
    }
    stats = _run_cases(cases, 2, live_pairs, support_pairs, in_bytes,
                       TIMED_LAUNCHES)
    for name, rep in split_reports(cases, tmask).items():
        stats[name]["split"] = rep
    args = (tmask, x_p, muT, ppT, v)
    stats["gsr_fwd"]["split"] = fwd_split_report(args, rad, clamp)
    stats["gsr_fwd"]["box_pairs"] = _box_pairs(tmask, x_p, muT, rad, gc.TB,
                                               gc.TN)
    # and on a 4096-point batch, the 2D test grid's chunk
    xq = rng.uniform(-5, 5, (4096, 2)).astype(np.float32)
    xq = torch.as_tensor(xq[np.argsort(xq[:, 0])], device=device)
    xq_p, _, _, _, _, _, tmq, radq = field._centered_prep(
        mix, spec, xq, gc.TB, gc.TN, presorted=True)
    stats["gsr_fwd"]["B4096"] = fwd_shape_entry(
        (tmq, xq_p, muT, ppT, v), radq, clamp, TIMED_LAUNCHES)
    return stats, {"B": B, "N": N, "live_pairs": live_pairs,
                   "support_pairs": support_pairs,
                   "live_tile_fraction": float(tmask.float().mean())}


def _centered_cases_3d(tmask, x_p, muT, ppT, v, clamp, dout, dout_val,
                       rad):
    """The three centered kernels at d = 3, each with its variants."""
    from gaussian_fluids_torch.ops import gsr_centered as gc
    B, N = x_p.shape[0], muT.shape[1]
    mask_bytes = 4 * tmask.numel()
    out_fwd, out_bwd = 4 * B * 12, 4 * N * (3 + 10 + 3)

    def pair(kern, plain):
        return (lambda: _flat(kern()), lambda: _flat(plain()))

    def pair_split(kern, plain):   # the kernel takes a forced split
        return (lambda split=None: _flat(kern(split)),
                lambda: _flat(plain()))

    a = (tmask, x_p, muT, ppT, v)
    return {
        "gsr_fwd": ("gsr", "fwd",
            [pair(lambda nj=nj: gc.gsr_fwd(*a, clamp, nj, rad),
                  lambda nj=nj: gc.fwd_plain(*a, clamp, nj))
             for nj in (3, 0)],
            out_fwd + mask_bytes, 0),
        "gsr_bwd_dn": ("gsr", "bwd_dn",
            [pair_split(lambda sp: gc.gsr_bwd_dn(*a, dout[0], clamp, 3,
                                                 split=sp),
                        lambda: gc.bwd_dn_plain(*a, dout[0], clamp, 3)),
             pair_split(lambda sp: gc.gsr_bwd_dn(*a, dout_val, clamp, 0,
                                                 split=sp),
                        lambda: gc.bwd_dn_plain(*a, dout_val, clamp, 0))],
            4 * dout[0].numel() + out_bwd + mask_bytes, 0),
        "gsr_bwd_dn2": ("gsr", "bwd_dn2",
            [pair_split(lambda sp, uv=uv: gc.gsr_bwd_dn2(
                *a, dout[0], dout[1], clamp, 3, use_val=uv, split=sp),
                        lambda uv=uv: gc.bwd_dn2_plain(
                *a, dout[0], dout[1], clamp, 3, use_val=uv))
             for uv in (True, False)],
            4 * 2 * dout[0].numel() + 2 * out_bwd + mask_bytes, 0),
    }


def kernels_fitted_3d(mix, spec, device, n_queries=8192):
    """Rows 2 and 3 at d = 3 on the fitted Leapfrog-3D mixture (the 3D
    path's frame-1 checkpoint) and one batch of the scene's size (8192
    uniform points in its domain, sorted along x as the epochs sort them):
    every split against the plain twins, timed at each split."""
    from gaussian_fluids_torch.ops import field, gsr_centered as gc
    from gaussian_fluids_torch.scenes import get_scene_3d

    lo, hi = np.float32(get_scene_3d("leapfrog").domain).reshape(3, 2).T
    x = np.random.RandomState(13).uniform(lo, hi, (n_queries, 3)) \
        .astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0], kind="stable")], device=device)
    clamp = spec.clamp_threshold
    x_p, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
        mix, spec, x, gc.TB, gc.TN, presorted=True)
    muT, ppT, v = mu_p.T.contiguous(), pp_p.T.contiguous(), v_p.contiguous()
    dout, dout_val = _douts_3d(x_p.shape[0], 14, device)
    reps = split_reports(_centered_cases_3d(tmask, x_p, muT, ppT, v, clamp,
                                            dout, dout_val, rad), tmask)
    common = {"B": x_p.shape[0], "N": muT.shape[1],
              "n_alive": int(mix.alive.sum()),
              "live_tile_fraction": float(tmask.float().mean()),
              "walked_pairs": int(tmask.sum()) * gc.TB * gc.TN,
              "support_pairs": _support_pairs(gc, tmask, x_p, muT, ppT, 3,
                                              clamp)}
    return {name: {**common, **rep} for name, rep in reps.items()}


def kernels_fitted_rc(mix, spec, device, n_queries=8192):
    """Rows 1, 6 and 7 on the fitted Ring-Collide mixture (the 3D path's
    frame-1 checkpoint). Rows 7 and 6 on one training batch of the
    scene's size (8192 uniform points in its domain, sorted along x as the
    epochs sort them): every split against the plain twin, each split
    timed. Row 1 on that batch and on the middle 32,768-node chunk of the
    scene's 128^3 test grid (x-major, as the projection evaluates it),
    every split."""
    from gaussian_fluids_torch.ops import field, gsr_cells as gk
    from gaussian_fluids_torch.ops import gsr_centered as gc
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.utils.grids import grid_points_3d

    scene = get_scene_3d("ring_collide")
    lo, hi = np.float32(scene.domain).reshape(3, 2).T
    clamp = spec.clamp_threshold
    x = np.random.RandomState(15).uniform(lo, hi, (n_queries, 3)) \
        .astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0], kind="stable")], device=device)
    grid = grid_points_3d(*scene.domain, *scene.visualize_res)
    mid = (grid.shape[0] // 32768 // 2) * 32768
    xg = torch.as_tensor(grid[mid:mid + 32768].astype(np.float32),
                         device=device)
    out = {"n_alive": int(mix.alive.sum())}
    for tag, q in (("batch", x), ("test_grid_chunk", xg)):
        x_p, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
            mix, spec, q, gc.TB, gc.TN, presorted=True)
        out["gsr_fwd_" + tag] = fwd_shape_entry(
            (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
             v_p.contiguous()), rad, clamp, 1)
    x_p, _, tmask, (_, _, gt, qt, ok), rad = field._cells_prep(mix, spec, x)
    if not int(ok):
        raise AssertionError("the fitted Ring-Collide work list overflowed")
    mu_p, pp_p, v_p = field._padded_param_rows(mix, spec, gk.TN)
    args = (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
            v_p.contiguous())
    dout, _ = _douts_3d(x_p.shape[0], 16, device)
    common = {
        "B": x_p.shape[0], "N": args[2].shape[1],
        "live_tile_fraction": float(tmask.float().mean()),
        "walked_pairs": int(tmask.sum()) * gk.TB * gk.TN,
        "support_pairs": _support_pairs(gc, tmask, x_p, args[2], args[3], 3,
                                        clamp),
        "box_pairs": _box_pairs(tmask, x_p, args[2], rad, gk.TB, gk.TN)}
    for name, rep in cells_split_report((gt, qt, ok), args, rad, clamp,
                                        dout).items():
        out[name] = {**rep, **common}
    return out


def _douts_3d(B, seed, device):
    rng = np.random.RandomState(seed)
    dout = [torch.as_tensor(rng.randn(B, 12).astype(np.float32) / B,
                            device=device) for _ in range(2)]
    dout_val = torch.as_tensor(rng.randn(B, 3).astype(np.float32) / B,
                               device=device)
    return dout, dout_val


def _box_pairs(tmask, x_p, muT, rad, tb, tn, rows=256):
    """Pairs of the live tiles whose query lies inside the row's dilated
    box: the pairs whose geometry the cells forward computes."""
    n = 0
    mu = muT.T
    live_rows = tmask.bool().repeat_interleave(tn, dim=1)
    for s in range(0, x_p.shape[0], rows):
        inb = ((x_p[s:s + rows, None, :] - mu[None]).abs()
               <= rad[None, :, None]).all(-1)
        n += int((inb & live_rows[s // tb:(s + rows) // tb]
                  .repeat_interleave(tb, dim=0)).sum())
    return n


def kernel_phase_3d(device):
    """The centered kernels at d=3 where the 3D path runs them (the
    Leapfrog-3D shape: B = 8192, N = 1024), timed again at Ring-Collide
    shapes, and the cells kernels at Ring-Collide shapes (B = 8192,
    N = 75,776), on the seeded states."""
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
    from gaussian_fluids_torch.ops import (field, gsr_cells as gk,
                                           gsr_centered as gc)

    mix, spec, x = ring_collide_state(device)
    clamp = spec.clamp_threshold
    x_p, _, tmask, (rows, cols, gt, qt, ok), rad = field._cells_prep(
        mix, spec, x)
    if not int(ok):
        raise AssertionError("the Ring-Collide work list overflowed")
    mu_p, pp_p, v_p = field._padded_param_rows(mix, spec, gk.TN)
    muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                   v_p.contiguous())
    B, N = x_p.shape[0], muT.shape[1]
    dout, dout_val = _douts_3d(B, 2, device)
    live_tiles = int(tmask.sum())
    live_pairs = live_tiles * gk.TB * gk.TN
    support_pairs = _support_pairs(gc, tmask, x_p, muT, ppT, 3, clamp)
    box_pairs = _box_pairs(tmask, x_p, muT, rad, gk.TB, gk.TN)
    par_bytes = 4 * (x_p.numel() + muT.numel() + ppT.numel() + v.numel())
    # the items a cells kernel walks: each live pair's (head, item)
    list_bytes = 2 * 4 * live_tiles
    out_fwd, out_bwd = 4 * B * 12, 4 * N * (3 + 10 + 3)
    lv = (rows, cols, ok)
    lt = (gt, qt, ok)

    def pair(kern, plain):
        return (lambda: _flat(kern()), lambda: _flat(plain()))

    cells = {
        "cells_fwd": ("cells", "fwd",
            [pair(lambda nj=nj: gk.cells_fwd(*lv, tmask, x_p, muT, ppT, v,
                                             clamp, nj, rad),
                  lambda nj=nj: gk.cells_fwd_plain(*lv, tmask, x_p, muT, ppT,
                                                   v, clamp, nj))
             for nj in (3, 0)],
            out_fwd, list_bytes),
        "cells_bwd_dn": ("cells", "bwd_dn",
            [pair(lambda: gk.cells_bwd_dn(*lt, tmask, x_p, muT, ppT, v,
                                          dout[0], clamp, 3, rad),
                  lambda: gk.cells_bwd_dn_plain(*lt, tmask, x_p, muT, ppT, v,
                                                dout[0], clamp, 3)),
             pair(lambda: gk.cells_bwd_dn(*lt, tmask, x_p, muT, ppT, v,
                                          dout_val, clamp, 0, rad),
                  lambda: gk.cells_bwd_dn_plain(*lt, tmask, x_p, muT, ppT, v,
                                                dout_val, clamp, 0))],
            4 * dout[0].numel() + out_bwd, list_bytes),
        "cells_bwd_dn2": ("cells", "bwd_dn2",
            [pair(lambda uv=uv: gk.cells_bwd_dn2(
                *lt, tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 3,
                rad, use_val=uv),
                  lambda uv=uv: gk.cells_bwd_dn2_plain(
                *lt, tmask, x_p, muT, ppT, v, dout[0], dout[1], clamp, 3,
                use_val=uv))
             for uv in (True, False)],
            4 * 2 * dout[0].numel() + 2 * out_bwd, list_bytes),
    }
    # the overflow branch: the same lists flagged as overflowed must give
    # the same field by sweeping the whole mask
    bad = torch.zeros_like(ok)
    for nj in (3, 0):
        compare(f"cells_fwd[overflow,{nj}]",
                [gk.cells_fwd(rows, cols, bad, tmask, x_p, muT, ppT, v,
                              clamp, nj, rad)],
                [gc.fwd_plain(tmask, x_p, muT, ppT, v, clamp, nj)], TOL)
    compare("cells_bwd_dn2[overflow,2x4]",
            _flat(gk.cells_bwd_dn2(gt, qt, bad, tmask, x_p, muT, ppT, v,
                                   dout[0], dout[1], clamp, 3, rad,
                                   split=(2, 4))),
            _flat(gc.bwd_dn2_plain(tmask, x_p, muT, ppT, v, dout[0],
                                   dout[1], clamp, 3)), TOL)
    # the centered kernels at d = 3 where they run (Leapfrog-3D), and at
    # Ring-Collide shapes as a second number
    lmix, lspec, lx = ring_collide_state(device, side=10)
    lx_p, _, _, lmu, lpp, lv_p, ltm, lrad = field._centered_prep(
        lmix, lspec, lx, gc.TB, gc.TN, presorted=True)
    lmuT, lppT, lvv = lmu.T.contiguous(), lpp.T.contiguous(), \
        lv_p.contiguous()
    ldout, ldout_val = _douts_3d(lx_p.shape[0], 12, device)
    l_live = int(ltm.sum()) * gc.TB * gc.TN
    l_sup = _support_pairs(gc, ltm, lx_p, lmuT, lppT, 3, clamp)
    l_cases = _centered_cases_3d(ltm, lx_p, lmuT, lppT, lvv, clamp, ldout,
                                 ldout_val, lrad)
    stats = _run_cases(
        l_cases, 3, l_live, l_sup,
        4 * (lx_p.numel() + lmuT.numel() + lppT.numel() + lvv.numel()),
        PLAIN_LAUNCHES_3D, tag="[d=3]")
    for name, rep in split_reports(l_cases, ltm).items():
        stats[name + "[d=3]"]["split"] = rep
    stats["gsr_fwd[d=3]"]["split"] = fwd_split_report(
        (ltm, lx_p, lmuT, lppT, lvv), lrad, clamp)
    stats["gsr_fwd[d=3]"]["box_pairs"] = _box_pairs(ltm, lx_p, lmuT, lrad,
                                                    gc.TB, gc.TN)
    # and on 32,768 points, the Leapfrog-3D test grid's chunk
    qmix, qspec, qx = ring_collide_state(device, side=10, n_queries=32768)
    qx_p, _, _, qmu, qpp, qv, qtm, qrad = field._centered_prep(
        qmix, qspec, qx, gc.TB, gc.TN, presorted=True)
    stats["gsr_fwd[d=3]"]["B32768"] = fwd_shape_entry(
        (qtm, qx_p, qmu.T.contiguous(), qpp.T.contiguous(), qv.contiguous()),
        qrad, clamp, PLAIN_LAUNCHES_3D)
    rc_cases = _centered_cases_3d(tmask, x_p, muT, ppT, v, clamp, dout,
                                  dout_val, rad)
    at_rc = _run_cases(rc_cases, 3, live_pairs, support_pairs, par_bytes,
                       PLAIN_LAUNCHES_3D, tag="[d=3]")
    for name, rep in split_reports(rc_cases, tmask).items():
        at_rc[name + "[d=3]"]["split"] = rep
    at_rc["gsr_fwd[d=3]"]["split"] = fwd_split_report(
        (tmask, x_p, muT, ppT, v), rad, clamp)
    # row 1 at the other batches of the Ring-Collide test grid: the 2D
    # projection's TEST_CHUNK and the 3D path's default chunk
    for nq in (4096, 32768):
        qmix, qspec, qx = ring_collide_state(device, n_queries=nq)
        qx_p, _, _, qmu, qpp, qv, qtm, qrad = field._centered_prep(
            qmix, qspec, qx, gc.TB, gc.TN, presorted=True)
        at_rc["gsr_fwd[d=3]"][f"B{nq}"] = fwd_shape_entry(
            (qtm, qx_p, qmu.T.contiguous(), qpp.T.contiguous(),
             qv.contiguous()), qrad, clamp, 1)
    for name, s_ in stats.items():
        s_.update(shape="Leapfrog-3D", B=lx_p.shape[0], N=lmuT.shape[1],
                  live_tile_fraction=float(ltm.float().mean()),
                  ring_collide={k: at_rc[name][k] for k in (
                      "ms", "plain_ms", "bound_ms", "walked_bound_ms",
                      "max_rel_err", "support_pairs", "walked_pairs",
                      "split", "B4096", "B32768") if k in at_rc[name]})
    stats["gsr_fwd[d=3]"]["ring_collide"]["box_pairs"] = box_pairs
    cstats = _run_cases(cells, 3, live_pairs, support_pairs, par_bytes,
                        PLAIN_LAUNCHES_3D)
    cstats["cells_fwd"].update(box_pairs=box_pairs)
    for name, rep in cells_split_report(lt, (tmask, x_p, muT, ppT, v), rad,
                                        clamp, dout).items():
        cstats[name].update(split=rep)
    for s_ in cstats.values():
        s_.update(shape="Ring-Collide", B=B, N=N,
                  live_tile_fraction=live_tiles / tmask.numel())
    stats.update(cstats)
    shapes = {"B": B, "N": N, "tiles": list(tmask.shape),
              "live_tiles": live_tiles, "live_pairs": live_pairs,
              "support_pairs": support_pairs,
              "cells_fwd_box_tested_pairs": live_pairs,
              "cells_fwd_geometry_pairs": box_pairs,
              "live_tiles_per_query_tile_mean": live_tiles / tmask.shape[0],
              "live_tiles_per_query_tile_max": int(tmask.sum(1).max()),
              "live_tile_fraction": live_tiles / tmask.numel(),
              "list_capacity": rows.numel(),
              "leapfrog_3d": {"B": lx_p.shape[0], "N": lmuT.shape[1],
                              "live_pairs": l_live, "support_pairs": l_sup,
                              "live_tile_fraction":
                                  float(ltm.float().mean())}}
    return stats, shapes


def _rk4_stage_points(x, muT, ppT, v, dt, clamp):
    """The five positions at which the fused RK4 kernel evaluates the field
    (the plain version's stages)."""
    from gaussian_fluids_torch.ops.gsr_centered import fwd_plain
    live = torch.ones((x.shape[0], 1), dtype=torch.int32, device=x.device)
    pts, vs = [x], []
    for h in (0.5 * dt, 0.5 * dt, dt):
        vs.append(fwd_plain(live, pts[-1], muT, ppT, v, clamp, 0))
        pts.append(x + h * vs[-1])
    vs.append(fwd_plain(live, pts[-1], muT, ppT, v, clamp, 0))
    pts.append(x + dt / 6.0 * (vs[0] + 2.0 * vs[1] + 2.0 * vs[2] + vs[3]))
    return pts


def _rk4_stage_tiles(pts, lo, hi):
    """(B/TB, nnt) bool: the Gaussian tiles whose boxes (lo, hi) meet each
    query tile's box at one stage's positions, the tiles the fused RK4
    kernel walks there."""
    from gaussian_fluids_torch.ops import rk4_fused as rk
    tiles = rk.pad_queries(pts).reshape(-1, rk.TB, pts.shape[1])
    return ((lo[None] <= tiles.amax(1)[:, :, None])
            & (hi[None] >= tiles.amin(1)[:, :, None])).all(1)


def karman_boundary_rows(scene, gen, n, device):
    """The scene's boundary batches as one projection epoch draws them (the
    cylinder's n Dirichlet points, the edges' 5n flux points), sorted along
    x as one segment, with the order that undoes the sort."""
    adv = torch.tensor(scene.advance_domain, device=device)
    b1 = scene.boundary_sampler_1(gen, n, adv)
    b2 = scene.boundary_sampler_2(gen, n, adv)
    pts = torch.cat([b1[0], b2[0]])
    order = torch.argsort(pts[:, 0])
    return pts[order].contiguous(), torch.argsort(order), b1, b2


def kernel_phase_rest(device):
    """Kernels 4, 9 and 10 at Karman-2D shapes on the seeded Karman state,
    and kernel 4 at Leapfrog-3D shapes, against their plain versions."""
    from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                          ring_collide_state)
    from gaussian_fluids_torch.ops import field, gsr_centered as gc
    from gaussian_fluids_torch.ops import rk4_fused as rk
    from gaussian_fluids_torch.scenes import get_scene_2d

    mix, spec, x = karman_state(device)
    clamp = spec.clamp_threshold
    mu_p, pp_p, v_p = field._padded_param_rows(mix, spec, gc.TN)
    muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                   v_p.contiguous())
    N = muT.shape[1]
    par_bytes = 4 * (muT.numel() + ppT.numel() + v.numel())
    rng = np.random.RandomState(5)
    stats, shapes = {}, {}

    def entry(name, src, ops, variants, nbytes, walked, support, tag=""):
        errs = [compare(f"{name}{tag}[{i}]", _flat(k()), _flat(p()), TOL)
                for i, (k, p) in enumerate(variants)]
        torch.cuda.synchronize()
        kern, plain = variants[0]
        stats[name + tag] = _entry(name + tag, src, errs, time_ms(kern),
                                   time_ms(plain), ops, nbytes, walked,
                                   support)

    # kernel 4 at d = 2 (Karman, B = 512) and at d = 3 where the path runs
    # it (the Leapfrog-3D frame's mixture, 1024 query points), with the
    # d = 3 time at B = 8192 as a second number
    for d, (m, sp, xq) in ((2, (mix, spec, x)),
                           (3, ring_collide_state(device, side=10,
                                                  n_queries=1024)),
                           (3, ring_collide_state(device, side=10))):
        x_p, _, _, mp, pp, vp, tmask, _ = field._centered_prep(
            m, sp, xq, gc.TB, gc.TN, presorted=True)
        args = (tmask, x_p, mp.T.contiguous(), pp.T.contiguous(),
                vp.contiguous())
        B = x_p.shape[0]
        dout = torch.as_tensor(rng.randn(B, (1 + d) * d).astype(np.float32)
                               / B, device=device)
        dval = dout[:, :d].contiguous()
        live = int(tmask.sum()) * gc.TB * gc.TN
        sup = _support_pairs(gc, tmask, *args[1:4], d, sp.clamp_threshold)
        c = sp.clamp_threshold
        tag = "" if d == 2 else ("[d=3]" if B == 1024 else "[d=3,B=8192]")
        entry("gsr_bwd_dx", "gsr",
              pair_ops(OPS_GEOMETRY[d], OPS_SUPPORT[(d, "bwd_dx")], live,
                       sup),
              [(lambda a=args, o=dout, d=d, c=c: gc.gsr_bwd_dx(*a, o, c, d),
                lambda a=args, o=dout, d=d, c=c: gc.bwd_dx_plain(*a, o, c,
                                                                 d)),
               (lambda a=args, o=dval, c=c: gc.gsr_bwd_dx(*a, o, c, 0),
                lambda a=args, o=dval, c=c: gc.bwd_dx_plain(*a, o, c, 0))],
              4 * (tmask.numel() + 2 * x_p.numel() + args[2].numel()
                   + args[3].numel() + args[4].numel() + dout.numel()),
              live, sup, tag)
        shapes[f"bwd_dx_d{d}_B{B}"] = {"B": B, "N": args[2].shape[1],
                                       "live_pairs": live,
                                       "support_pairs": sup}
    second = stats.pop("gsr_bwd_dx[d=3,B=8192]")
    stats["gsr_bwd_dx[d=3]"]["at_B8192"] = {k: second[k] for k in (
        "ms", "plain_ms", "bound_ms", "walked_bound_ms", "max_rel_err")}

    # row 1 at Karman-2D (B = 512, N = 24,576), every split
    x_p, _, _, mp, pp, vp, tmask, rad = field._centered_prep(
        mix, spec, x, gc.TB, gc.TN, presorted=True)
    shapes["gsr_fwd_karman_2d"] = fwd_shape_entry(
        (tmask, x_p, mp.T.contiguous(), pp.T.contiguous(), vp.contiguous()),
        rad, clamp, TIMED_LAUNCHES)

    # kernel 10 over [512 data rows; the scene's 3072 boundary rows]
    scene = get_scene_2d("karman")
    gen = torch.Generator(device=device).manual_seed(6)
    xb, _, _, _ = karman_boundary_rows(scene, gen, 512, device)
    x_dp = field._pad_axis(x, gc.TB)
    rows = x_dp.shape[0]
    x_c, _, _, _, _, _, tmask, _ = field._centered_prep(
        mix, spec, torch.cat([x_dp, xb]), gc.TB, gc.TN, presorted=True)
    B = x_c.shape[0]
    douts = [torch.zeros((B, 6), device=device) for _ in range(2)]
    for o in douts:
        o[:x.shape[0]] = torch.as_tensor(
            rng.randn(x.shape[0], 6).astype(np.float32) / 512, device=device)
    dout3 = torch.zeros((B, 2), device=device)
    dout3[rows:rows + xb.shape[0]] = torch.as_tensor(
        rng.randn(xb.shape[0], 2).astype(np.float32) / xb.shape[0],
        device=device)
    args = (tmask, x_c, muT, ppT, v)
    live = int(tmask.sum()) * gc.TB * gc.TN
    sup_d = _support_pairs(gc, tmask[:rows // gc.TB], x_c[:rows], muT, ppT,
                           2, clamp)
    sup_b = _support_pairs(gc, tmask[rows // gc.TB:], x_c[rows:], muT, ppT,
                           2, clamp)
    need_d, walk_d = pair_ops(OPS_GEOMETRY[2], OPS_SUPPORT[(2, "bwd_dn2")],
                              live, sup_d)
    need_b, walk_b = pair_ops(OPS_GEOMETRY[2],
                              OPS_SUPPORT[(2, "bwd_dn_val")], 0, sup_b)
    entry("gsr_bwd_dn3", "gsr", (need_d + need_b, walk_d + walk_b),
          [(lambda uv=uv: gc.gsr_bwd_dn3(*args, *douts, dout3, clamp, 2,
                                         rows, use_val12=uv),
            lambda uv=uv: gc.bwd_dn3_plain(*args, *douts, dout3, clamp, 2,
                                           rows, use_val12=uv))
           for uv in (False, True)],
          4 * (tmask.numel() + x_c.numel() + 2 * douts[0].numel()
               + dout3.numel()) + par_bytes + 3 * 4 * N * (6 + 2),
          live, sup_d + sup_b)
    shapes["bwd_dn3"] = {"B": B, "data_rows": rows,
                         "boundary_rows": xb.shape[0], "N": N,
                         "live_tile_fraction": float(tmask.float().mean()),
                         "support_pairs_data": sup_d,
                         "support_pairs_boundary": sup_b}

    # kernel 9: the covector target's backtrace over -dt, each stage
    # culled at its own positions: walked pairs are those of the Gaussian
    # tiles whose boxes meet the stage's query tile box
    dt = -KARMAN_DT
    rad = field.row_radius(mix, spec, gc.TN)
    lo, hi = rk.tile_boxes(muT, rad)
    pts = _rk4_stage_points(x, muT, ppT, v, dt, clamp)
    ones = torch.ones((x.shape[0], 1), dtype=torch.int32, device=device)
    sup = [_support_pairs(gc, ones, p_, muT, ppT, 2, clamp) for p_ in pts]
    meets = [_rk4_stage_tiles(p_, lo, hi) for p_ in pts]
    walked = [int(m.sum()) * rk.TB * rk.TN for m in meets]
    stage_ops = [pair_ops(OPS_GEOMETRY[2], OPS_SUPPORT[(2, "rk4_stage")],
                          w_, n) for w_, n in zip(walked[:4], sup[:4])] \
        + [pair_ops(OPS_GEOMETRY[2], OPS_SUPPORT[(2, "fwd")], walked[4],
                    sup[4])]
    variants = [(lambda nj=nj: rk.fused_rk4(x, muT, ppT, v, dt, clamp, nj,
                                            rad, lo, hi),
                 lambda nj=nj: rk.rk4_plain(x, muT, ppT, v, dt, clamp, nj))
                for nj in (2, 0)]
    entry("rk4_fused", "rk4",
          tuple(sum(o[i] for o in stage_ops) for i in range(2)), variants,
          4 * x.numel() + par_bytes + 4 * x.shape[0] * (2 + 6),
          sum(walked), sum(sup))
    # every split S against the plain twin, two launches bitwise equal,
    # each split timed
    splits = [None] + list(gc.SPLIT_S)
    errs = []
    for nj in (2, 0):
        want = rk.rk4_plain(x, muT, ppT, v, dt, clamp, nj)
        for sp in splits:
            a, b = (rk.fused_rk4(x, muT, ppT, v, dt, clamp, nj, rad, lo, hi,
                                 split=sp) for _ in range(2))
            if not all(torch.equal(p_, q_) for p_, q_ in zip(a, b)):
                raise AssertionError(f"rk4_fused[{nj}] at split {sp}: two "
                                     f"launches differ")
            errs.append(compare(f"rk4_fused[{nj}, S={_fwd_key(sp)}]", a,
                                want, TOL)[1])
    torch.cuda.synchronize()
    ms = {_fwd_key(sp): time_ms(lambda sp=sp: rk.fused_rk4(
        x, muT, ppT, v, dt, clamp, 2, rad, lo, hi, split=sp))
        for sp in splits}
    chosen = gc.fwd_split(x.shape[0] // rk.TB, N // rk.TN, gc._sm_count(0))
    pairs = x.shape[0] * N
    stats["rk4_fused"]["split"] = {
        "split": chosen, "blocks": x.shape[0] // rk.TB * chosen,
        "ms": ms["chosen"], "ms_1": ms["1"], "ms_by_split": ms,
        "best_split": min((k for k in ms if k != "chosen"), key=ms.get),
        "splits_checked": 2 * len(splits),
        "max_rel_err_splits": max(errs), "bitwise_repeat": True}
    shapes["rk4_fused"] = {
        "B": x.shape[0], "N": N, "dt": dt, "pairs_per_stage": pairs,
        "tile_pairs_per_stage": meets[0].numel(),
        "live_tiles_per_stage": [int(m.sum()) for m in meets],
        "walked_pairs_per_stage": walked,
        "walked_fraction": sum(walked) / (5 * pairs),
        "box_pairs_per_stage": [
            _box_pairs(m.to(torch.int32), p_, muT, rad, rk.TB, rk.TN)
            for m, p_ in zip(meets, pts)],
        "support_pairs_per_stage": sup}
    return stats, shapes


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def check_field(mix, spec, pts, tol=1e-3, f64=False):
    """The final field through the kernels vs the dense plain evaluation
    (an independent formulation: the expanded quadratic as one matmul, in
    float64, where the expanded form's f32 cancellation would otherwise
    be most of the difference)."""
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field
    pts = torch.as_tensor(pts, device=mix.device)
    ref_mix = mix
    if f64:
        ref_mix = mixture_of({k: p.double() for k, p in mix.params().items()},
                             mix.alive)
    with torch.no_grad():
        v, j = field.value_and_jac(mix, spec, pts)
        vd, jd = field.value_and_jac_dense(
            ref_mix, spec, pts.double() if f64 else pts)
    b, d = pts.shape
    if v.shape != (b, spec.vdim) or j.shape != (b, spec.vdim, d):
        raise AssertionError(f"field shapes {v.shape}, {j.shape}")
    err, rel = compare("final field", [v, j], [vd, jd], tol)
    return {"max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
            "max_abs_velocity": float(vd.abs().max())}


def check_frames(frames, n, tag):
    if len(frames) != n:
        raise AssertionError(f"{tag}: expected {n} frames, ran {len(frames)}")
    for f in frames:
        vals = list(f["clone"].values()) + list(f["project"].values())
        if not f["project"] or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{tag} frame {f['frame']}: {f}")


def run_2d(tmp):
    from gaussian_fluids_torch import advance2d, initialize2d
    from gaussian_fluids_torch.ops import gsr_centered
    from gaussian_fluids_torch.utils.grids import grid_points_2d

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
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    check_frames(frames, 2, "2D")
    for f in frames:
        emit({"phase": "advance", "frame": f["frame"],
              "seconds": f["seconds"], "n_gaussians": f["n_alive"],
              "capacity": f["capacity"], "clone": f["clone"],
              "project": f["project"],
              "divergence_residual": f["project"]["loss_div"]})
    emit({"phase": "advance", "seconds": time.perf_counter() - t0,
          "frames": len(frames),
          "launches": {k: launches[k] - init_launches[k] for k in launches},
          "gsr_fwd_launches_by_shape": by_shape})

    t0 = time.perf_counter()
    written = sorted(os.listdir(tmp))
    want = [f"gaussian_velocity_{i}.pt" for i in range(3)]
    if written != want:
        raise AssertionError(f"checkpoints {written} != {want}")
    pts = grid_points_2d(-5, 5, -5, 5, 64, 64)
    emit({"phase": "check", "seconds": time.perf_counter() - t0,
          **check_field(mix, spec, pts, f64=True)})
    return launches, by_shape


def _shape_counts(fwd_shapes):
    """Row 1's launches by shape, keyed for JSON."""
    return {f"d={d},B={b},N={n}": c for (d, b, n), c in fwd_shapes.items()}


def wall_ms(fn, reps=TIMED_LAUNCHES):
    """Median wall milliseconds of ``fn`` with a synchronise after each
    call: what a caller waits for one call, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def _profile(fn, calls=10):
    """Per call, under torch.profiler: wall and device ms, the device's busy
    share, host operators and device launches."""
    from gaussian_fluids_torch.epoch_profile import profile_epoch
    prof = profile_epoch(fn, calls)
    return {k.replace("epoch", "call"): prof[k] for k in (
        "ms_per_epoch", "device_ms_per_epoch", "device_busy_share",
        "host_ops_per_epoch", "device_launches_per_epoch")}


def run_karman(tmp):
    """initialize2d and one advance2d frame of karman at full width, the
    frame under GF_FUSED_RK4=1; returns (final mixture, spec, the frame's
    launches per wrapper)."""
    from gaussian_fluids_torch import advance2d, initialize2d
    from gaussian_fluids_torch.ops import gsr_centered, rk4_fused
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.utils.grids import grid_points_2d

    def counts():
        torch.cuda.synchronize()
        return {**gsr_centered.launches, **rk4_fused.launches}

    gsr_centered.reset_launches()
    rk4_fused.reset_launches()
    t0 = time.perf_counter()
    mix, spec = initialize2d.main(
        ["--init_cond", "karman", "--dir", tmp, "--max_epoch",
         str(KARMAN_INIT_EPOCHS)])
    init = counts()
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    emit({"phase": "karman_init", "seconds": time.perf_counter() - t0,
          "epochs": {"fit": KARMAN_INIT_EPOCHS,
                     "projection": KARMAN_INIT_EPOCHS},
          "epochs_by_default": {"fit": 10000, "projection": 10000},
          "n_gaussians": mix.n_alive(), "capacity": mix.capacity,
          "batch": 512, "launches": init})
    if (mix.n_alive(), mix.capacity) != (24000, 24576):
        raise AssertionError(f"karman width {mix.n_alive()}/{mix.capacity}")
    gsr_centered.reset_launches()
    rk4_fused.reset_launches()
    before = os.environ.get("GF_FUSED_RK4")
    os.environ["GF_FUSED_RK4"] = "1"
    try:
        t0 = time.perf_counter()
        mix, spec, frames = advance2d.main(
            ["--init_cond", "karman", "--dir", tmp, "--dt", str(KARMAN_DT),
             "--last_time", str(KARMAN_DT), "--max_epoch",
             str(KARMAN_ADVANCE_EPOCHS)])
        wall = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("GF_FUSED_RK4")
        else:
            os.environ["GF_FUSED_RK4"] = before
    launches = counts()
    for k, n in _shape_counts(gsr_centered.fwd_shapes).items():
        by_shape[k] = by_shape.get(k, 0) + n
    check_frames(frames, 1, "karman")
    scene = get_scene_2d("karman")
    f = frames[0]
    want_adv = scene.advance_domain_at(1, KARMAN_DT)
    if tuple(f["advance_domain"]) != tuple(want_adv) \
            or want_adv[0] <= scene.advance_domain[0]:
        raise AssertionError(f"advance domain {f['advance_domain']} != "
                             f"{want_adv}")
    if launches["rk4_fused"] == 0:
        raise AssertionError("the Karman frame never launched rk4_fused")
    if sorted(os.listdir(tmp)) != ["gaussian_velocity_0.pt",
                                   "gaussian_velocity_1.pt"]:
        raise AssertionError(f"karman: checkpoints {os.listdir(tmp)}")
    adv, sf = f["advance_domain"], scene.scaling_factor
    pts = grid_points_2d(adv[0] * sf, adv[1] * sf, adv[2] * sf, adv[3] * sf,
                         64, 32)
    emit({"phase": "karman", "frame": f["frame"], "seconds": wall,
          "frame_seconds": f["seconds"], "clone_seconds": f["clone_seconds"],
          "advect_seconds": f["advect_seconds"],
          "project_seconds": f["project_seconds"],
          "epochs_per_phase": KARMAN_ADVANCE_EPOCHS,
          "epochs_per_phase_by_default": 20000,
          "n_gaussians": f["n_alive"], "capacity": f["capacity"],
          "advance_domain": list(adv), "clone": f["clone"],
          "project": f["project"],
          "divergence_residual": f["project"]["loss_div"],
          "launches": launches, "gsr_fwd_launches_by_shape": by_shape,
          **{"check_" + k: v for k, v in check_field(
              mix, spec, pts, f64=True).items()}})
    return mix, spec, launches, by_shape


def _projection_batch(mix, spec, seed):
    """One projection epoch's data batch (512 points uniform in the
    frame's scaled advance domain, sorted along x) and the domain's scaled
    bounds."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver.fit import uniform_batch
    scene = get_scene_2d("karman")
    adv, sf = scene.advance_domain_at(1, KARMAN_DT), scene.scaling_factor
    lo = torch.tensor([adv[0] * sf, adv[2] * sf], device=mix.device)
    hi = torch.tensor([adv[1] * sf, adv[3] * sf], device=mix.device)
    gen = torch.Generator(device=mix.device).manual_seed(seed)
    x = uniform_batch(gen, 512, lo, hi)
    return x[torch.argsort(x[:, 0])].contiguous(), lo, hi, gen


def covector_fused(mix, spec):
    """The covector target on one projection batch with the fused RK4
    kernel against the staged, tile-culled evaluations."""
    from gaussian_fluids_torch.solver import covector

    x, lo, hi, _ = _projection_batch(mix, spec, 7)
    before = os.environ.get("GF_FUSED_RK4")
    out, ms = {}, {}
    try:
        for flag in ("1", "0"):
            os.environ["GF_FUSED_RK4"] = flag

            def target():
                return covector.advected_vorticity_2d(
                    mix, spec, x, KARMAN_DT, lo, hi, presorted=True)
            out[flag] = target()
            ms[flag] = (wall_ms(target), _profile(target))
    finally:
        if before is None:
            os.environ.pop("GF_FUSED_RK4", None)
        else:
            os.environ["GF_FUSED_RK4"] = before
    fused, staged = out["1"].double(), out["0"].double()
    err = float((fused - staged).abs().max())
    bad = (fused - staged).abs() > COVECTOR_ATOL + COVECTOR_RTOL * staged.abs()
    if bool(bad.any()) or not torch.isfinite(fused).all():
        raise AssertionError(f"fused covector target off the staged one: "
                             f"max abs err {err}, {int(bad.sum())} points")
    emit({"phase": "covector_fused", "batch": x.shape[0],
          "max_abs_err": err, "rtol": COVECTOR_RTOL, "atol": COVECTOR_ATOL,
          "max_abs_target": float(staged.abs().max()),
          "fused_wall_ms": ms["1"][0], "staged_wall_ms": ms["0"][0],
          "fused_profile": ms["1"][1], "staged_profile": ms["0"][1]})


def epoch_heads(mix, spec):
    """field.epoch_heads_grads at the Karman projection geometry against
    two_head_grads plus a separate boundary value backward; returns the
    triple backward's launches in its first call."""
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field, gsr_centered
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import covector, losses

    x, lo, hi, gen = _projection_batch(mix, spec, 8)
    scene = get_scene_2d("karman")
    xb, inv, b1, b2 = karman_boundary_rows(scene, gen, 512, mix.device)
    n1 = b1[0].shape[0]
    ref = covector.advected_vorticity_2d(mix, spec, x, KARMAN_DT, lo, hi,
                                         presorted=True)

    def head_vor(val, jac):
        return losses.vorticity_loss_2d(jac, ref)

    def head_div(val, jac):
        return losses.divergence_loss(jac)

    def head_bnd(vb):
        vb = vb[inv]
        return (losses.boundary_dirichlet_loss(vb[:n1], b1[1])
                + losses.boundary_flux_loss(vb[n1:], b2[1], b2[2]))

    params = mix.params()

    def fused():
        return field.epoch_heads_grads(params, mix.alive, spec, x, xb,
                                       head_vor, head_div, head_bnd)

    def separate():
        (l1, l2), (g1, g2) = field.two_head_grads(params, mix.alive, spec, x,
                                                  head_vor, head_div)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            lb = head_bnd(field.value(mixture_of(leaves, mix.alive), spec,
                                      xb, presorted=True, need_dx=False))
            gb = torch.autograd.grad(lb, list(leaves.values()),
                                     allow_unused=True,
                                     materialize_grads=True)
        return (l1, l2, lb.detach()), (g1, g2, dict(zip(leaves, gb)))

    gsr_centered.reset_launches()
    (ls, gs) = fused()
    torch.cuda.synchronize()
    launches = dict(gsr_centered.launches)
    (wl, wg) = separate()
    errs = [compare("epoch_heads losses", list(ls), list(wl), TOL)]
    for i, (a, b) in enumerate(zip(gs, wg)):
        for k in b:
            errs.append(compare(f"epoch_heads g{i + 1}.{k}", [a[k]], [b[k]],
                                TOL))
    emit({"phase": "epoch_heads", "data_rows": x.shape[0],
          "boundary_rows": xb.shape[0],
          "losses": [float(v) for v in ls],
          "max_abs_err": max(e for e, _ in errs),
          "max_rel_err": max(r for _, r in errs), "tolerance": TOL,
          "fused_wall_ms": wall_ms(fused),
          "separate_wall_ms": wall_ms(separate),
          "fused_profile": _profile(fused),
          "separate_profile": _profile(separate),
          "launches_fused_call": launches})
    return launches


def query_grad(mixes):
    """dL/dx through field.value_and_jac (Jacobian summed) and field.value
    on the card against float64 dense autograd, per (mixture, spec, points);
    returns the dL/dx kernel's launches per dimension."""
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field, gsr_centered

    out = {}
    for mix, spec, x in mixes:
        d = spec.d
        m64 = mixture_of({k: p.double() for k, p in mix.params().items()},
                         mix.alive)
        gsr_centered.reset_launches()
        res = {}
        for name, f, f64 in (
                ("value_and_jac", lambda q: field.value_and_jac(
                    mix, spec, q)[1].sum(),
                 lambda q: field.value_and_jac_dense(m64, spec, q)[1].sum()),
                ("value", lambda q: field.value(mix, spec, q).sum(),
                 lambda q: field.value_dense(m64, spec, q).sum())):
            xg = x.detach().clone().requires_grad_(True)
            (gx,) = torch.autograd.grad(f(xg), [xg])
            x64 = x.detach().double().requires_grad_(True)
            (want,) = torch.autograd.grad(f64(x64), [x64])
            err, rel = compare(f"query_grad d={d} {name}", [gx], [want], TOL)
            res[name] = {"max_abs_err": err, "max_rel_err": rel,
                         "max_abs_grad": float(want.abs().max())}
        torch.cuda.synchronize()
        out[d] = dict(gsr_centered.launches)
        emit({"phase": "query_grad", "d": d, "points": x.shape[0],
              "n_gaussians": mix.n_alive(), "tolerance": TOL, **res,
              "launches": out[d]})
    return out


def run_3d(tmp):
    """leapfrog (centered kernels at d=3) and ring_collide (cells) through
    the 3D entry points; returns the 3D path's launches per wrapper."""
    from gaussian_fluids_torch import advance3d, initialize3d
    from gaussian_fluids_torch.ops import gsr_cells, gsr_centered

    def counts():
        torch.cuda.synchronize()
        return {**gsr_centered.launches, **gsr_cells.launches}

    gsr_centered.reset_launches()
    gsr_cells.reset_launches()
    total = {}
    for scene in ("leapfrog", "ring_collide"):
        d = os.path.join(tmp, scene)
        before = counts()
        t0 = time.perf_counter()
        mix, spec = initialize3d.main(
            ["--init_cond", scene, "--dir", d, "--max_epoch",
             str(INIT3D_EPOCHS)])
        mid = counts()
        emit({"phase": "initialize3d", "scene": scene,
              "seconds": time.perf_counter() - t0, "epochs": INIT3D_EPOCHS,
              "n_gaussians": mix.n_alive(), "capacity": mix.capacity,
              "batch": 8192,
              "launches": {k: mid[k] - before[k] for k in mid}})
        t0 = time.perf_counter()
        mix, spec, frames = advance3d.main(
            ["--init_cond", scene, "--dir", d, "--dt", ".02",
             "--last_time", ".02", "--max_epoch", str(ADVANCE3D_EPOCHS)])
        after = counts()
        check_frames(frames, 1, scene)
        f = frames[0]
        emit({"phase": "advance3d", "scene": scene, "frame": f["frame"],
              "seconds": f["seconds"], "clone_seconds": f["clone_seconds"],
              "advect_seconds": f["advect_seconds"],
              "project_seconds": f["project_seconds"],
              "n_gaussians": f["n_alive"], "capacity": f["capacity"],
              "clone": f["clone"], "project": f["project"],
              "divergence_residual": f["project"]["loss_div"],
              "launches": {k: after[k] - mid[k] for k in after}})
        if sorted(os.listdir(d)) != ["gaussian_velocity_0.pt",
                                     "gaussian_velocity_1.pt"]:
            raise AssertionError(f"{scene}: checkpoints {os.listdir(d)}")
        total = after
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    overflows = gsr_cells.overflows()
    if any(overflows.values()):
        raise AssertionError(f"cells work lists overflowed: {overflows}")
    t0 = time.perf_counter()
    pts = np.random.RandomState(3).uniform(0, 1, (4096, 3)) \
        .astype(np.float32)
    emit({"phase": "check3d", "scene": "ring_collide",
          "seconds": time.perf_counter() - t0, "cells_overflows": overflows,
          "gsr_fwd_launches_by_shape": by_shape,
          **check_field(mix, spec, pts, f64=True)})
    return total, by_shape


def _banded_culling(x, B, prep, jlo, ok, band, tb, tn, warp=32):
    """What the banded kernel walks on these inputs, counted on the card
    with the kernel's own tests: per query tile the window's tiles (tested)
    and those whose box meets the tile's (staged and walked); and the rows
    of those tiles whose box meets a warp's queries' box (the rows a warp
    evaluates)."""
    nbt, nnt = B // tb, prep["lo"].shape[1]
    xb = x[:B].reshape(nbt, tb, -1)
    meet = ((prep["lo"].T[None] <= xb.amax(1)[:, None])
            & (prep["hi"].T[None] >= xb.amin(1)[:, None])).all(-1)
    j = torch.arange(nnt, device=x.device)[None]
    start = jlo.long().clamp(0, nnt - band)[:, None]
    width = band if int(ok) else nnt
    if int(ok):
        tested = (j >= start) & (j < start + width)
    else:
        tested = torch.ones_like(meet)
    walked = meet & tested
    mu, r = prep["muT"], prep["rad"]
    rows = 0
    wb = x[:B].reshape(B // warp, warp, -1)
    wlo, whi = wb.amin(1), wb.amax(1)
    for s in range(0, B // warp, 512):
        rmeet = ((wlo[s:s + 512, :, None] <= mu[None] + r)
                 & (whi[s:s + 512, :, None] >= mu[None] - r)).all(1) \
            & (r >= 0)[None]
        tiles = walked[s * warp // tb:(s + 512) * warp // tb] \
            .repeat_interleave(tb // warp, dim=0).repeat_interleave(tn, 1)
        rows += int((rmeet & tiles).sum())
    n_walked = walked.sum(1).float()
    return {"tiles_tested_per_query_tile": float(tested.sum(1).float()
                                                 .mean()),
            "tiles_walked_per_query_tile_mean": float(n_walked.mean()),
            "tiles_walked_per_query_tile_max": int(n_walked.max()),
            "walked_pairs": int(walked.sum()) * tb * tn,
            "warp_row_pairs": rows * warp}


def _x_sorted_chunk(mix, spec, x, plain):
    """The banded kernel on one chunk with the mixture x-sorted (the JAX
    package's order) and its own band: held against the plain version on
    the slab-major mixture (the same function, summed in another order),
    timed, and its culling."""
    from gaussian_fluids_torch.ops import field, gsr_banded as gb
    from gaussian_fluids_torch.solver.simulate3d import _suggest_band

    xmix = mix.x_sorted()
    band = _suggest_band(xmix, spec, DENSITY_DT)
    prep = field.banded_prep(xmix, spec)
    B = x.shape[0]
    jlo, ok = field.band_window(x, B, prep["nlo"], prep["nhi"], band, gb.TB)
    if not int(ok):
        raise AssertionError(f"x-sorted band {band} fails the guard")
    kern = lambda: gb.gsr_value_banded(  # noqa: E731
        jlo, ok, x, prep["muT"], prep["ppT"], prep["v"], prep["rad"],
        prep["lo"], prep["hi"], spec.clamp_threshold, band)
    err = compare("gsr_value_banded[x-sorted]", [kern()], [plain()], TOL)
    torch.cuda.synchronize()
    return {"band": band, "ms": time_ms(kern), "max_abs_err": err[0],
            **_banded_culling(x, B, prep, jlo, ok, band, gb.TB, gb.TN)}


def kernel_phase_density(device):
    """The banded value kernel at the replay's production shapes: one
    262,144-node chunk (the 512^3 grid's x-plane nearest 0.5) against the
    seeded Ring-Collide state, slab-major as the replay orders it, with
    the band the replay would use; then band 1, which fails the guard and
    sweeps the whole axis; then the mixture x-sorted, the order the
    replay's is held against."""
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
    from gaussian_fluids_torch.ops import field, gsr_banded as gb
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.solver.simulate3d import (
        DENSITY_CHUNK, _grid_chunks_device, _suggest_band)
    from gaussian_fluids_torch.utils.grids import axis_nodes

    mix, spec, _ = ring_collide_state(device)
    mix = mix.slab_sorted(spec.clamp_threshold)
    clamp = spec.clamp_threshold
    domain = get_scene_3d("ring_collide").domain
    xs = axis_nodes(domain[0], domain[1], 512)
    plane = int(np.argmin(np.abs(xs - 0.5 * (domain[0] + domain[1]))))
    chunks, _ = _grid_chunks_device(tuple(domain), (512,) * 3,
                                    DENSITY_CHUNK, device)
    x = chunks[plane]
    B = x.shape[0]
    band = _suggest_band(mix, spec, DENSITY_DT)
    prep = field.banded_prep(mix, spec)
    jlo, ok = field.band_window(x, B, prep["nlo"], prep["nhi"], band, gb.TB)
    if not int(ok):
        raise AssertionError(f"band {band} fails the guard at x = "
                             f"{xs[plane]}")
    args = (x, prep["muT"], prep["ppT"], prep["v"])
    boxes = (prep["rad"], prep["lo"], prep["hi"])
    kern = lambda: gb.gsr_value_banded(jlo, ok, *args, *boxes,  # noqa: E731
                                       clamp, band)
    plain = lambda: gb.value_banded_plain(jlo, ok, *args,  # noqa: E731
                                          clamp, band)
    errs = [compare("gsr_value_banded", [kern()], [plain()], TOL)]
    jlo1, ok1 = field.band_window(x, B, prep["nlo"], prep["nhi"], 1, gb.TB)
    if int(ok1):
        raise AssertionError("band 1 passed the guard")
    before = gb.guard_failures()
    sweep = lambda: gb.gsr_value_banded(jlo1, ok1, *args,  # noqa: E731
                                        *boxes, clamp, 1)
    if not torch.equal(sweep(), kern()):
        raise AssertionError("the guard's full sweep differs from the "
                             "sufficient band's output")
    if gb.guard_failures() != before + 1:
        raise AssertionError("the guard counter missed the full sweep")
    torch.cuda.synchronize()
    ms = time_ms(kern)
    sweep_ms = time_ms(sweep, 5)
    plain_ms = time_ms(plain, PLAIN_LAUNCHES_3D)
    N = prep["muT"].shape[1]
    window_pairs = B * band * gb.TN
    support_pairs = sum(int((mgv > 0).sum()) for _, mgv in gb.window_weights(
        jlo, ok, x, prep["muT"], prep["ppT"], clamp, band))
    cull = _banded_culling(x, B, prep, jlo, ok, band, gb.TB, gb.TN)
    cull_sweep = _banded_culling(x, B, prep, jlo1, ok1, 1, gb.TB, gb.TN)
    ops = pair_ops(OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT,
                   cull["walked_pairs"], support_pairs)
    # the function's own inputs and output: the boxes and radii only
    # help the kernel cull
    nbytes = 4 * (2 * x.numel() + jlo.numel() + prep["muT"].numel()
                  + prep["ppT"].numel() + prep["v"].numel())
    entry = _entry("gsr_value_banded", "banded", errs, ms, plain_ms, ops,
                   nbytes, cull["walked_pairs"], support_pairs,
                   NO_LIBRARY_BANDED)
    shapes = {"B": B, "N": N, "band": band, "band_of": N // gb.TN,
              "order": "slab-major", "window_rows": band * gb.TN,
              "window_pairs": window_pairs,
              "window_bound_ms": _bound(pair_ops(
                  OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT, window_pairs,
                  support_pairs)[1], nbytes)[0],
              "support_pairs": support_pairs, "plane_x": float(xs[plane]),
              **cull, "full_sweep_ms": sweep_ms,
              "full_sweep_tiles_tested_per_query_tile":
                  cull_sweep["tiles_tested_per_query_tile"],
              "full_sweep_tiles_walked_per_query_tile_mean":
                  cull_sweep["tiles_walked_per_query_tile_mean"],
              "full_sweep_bitwise_equal": True,
              "x_sorted": _x_sorted_chunk(mix, spec, x, plain)}
    entry.update(shapes)
    return {"gsr_value_banded": entry}, shapes


def _volume_stats(v):
    v = np.asarray(v, np.float64)
    return {"mass": float(v.sum()), "max": float(v.max()),
            "finite": bool(np.isfinite(v).all())}


def run_density(d):
    """The replay through its entry point on the ring_collide checkpoints
    0 and 1 in ``d``, at 128^3; returns the banded kernel's launches."""
    from gaussian_fluids_torch import advance_density3d
    from gaussian_fluids_torch.io import vti
    from gaussian_fluids_torch.ops import gsr_banded

    gsr_banded.reset_launches()
    t0 = time.perf_counter()
    records = advance_density3d.main(
        ["--init_cond", "ring_collide", "--dir", d, "--dt", str(DENSITY_DT),
         "--density_res_multiplier", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gsr_banded.launches)
    guard = gsr_banded.guard_failures()
    volumes = {}
    for tag in "ab":
        for frame in range(3):
            base = os.path.join(d, f"density_{tag}_{frame}")
            small = os.path.join(d, f"density_small_{tag}_{frame}.npz")
            if not os.path.exists(small):
                raise AssertionError(f"missing {small}")
            v = vti.read_vti_array(base + ".vti")
            st = _volume_stats(v)
            if v.shape != (128,) * 3 or not st["finite"] \
                    or st["max"] > 1 + 1e-5 or st["mass"] <= 0:
                raise AssertionError(f"{base}.vti: {v.shape} {st}")
            volumes[f"{tag}{frame}"] = st
    if [r["frame"] for r in records] != [1, 2] or guard:
        raise AssertionError(f"replay frames {records}, guard {guard}")
    emit({"phase": "density3d", "seconds": wall, "grid": [128] * 3,
          "frames": records, "volumes": volumes, "guard_failures": guard,
          "launches": launches})
    return launches


def check_density(d, device):
    """The backtrace of 4096 seeded grid nodes of the 128^3 grid (up to
    half inside the frame-1 smoke) through the banded kernel (the
    replay's own stage function) against the dense plain backtrace in
    float64 on frame 1's mixture, and the frame-1 density sampled at both
    endpoints."""
    from gaussian_fluids_torch.io import checkpoint, vti
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field, interp
    from gaussian_fluids_torch.ops.advect import rk4_pos_stages
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.solver.simulate3d import (_stage_velocity,
                                                         _suggest_band)
    from gaussian_fluids_torch.utils.grids import grid_points_3d

    t0 = time.perf_counter()
    mix, spec = checkpoint.load_checkpoint(
        os.path.join(d, "gaussian_velocity_1.pt"), device=device)
    mix = mix.slab_sorted(spec.clamp_threshold)
    domain = get_scene_3d("ring_collide").domain
    dens = torch.as_tensor(vti.read_vti_array(
        os.path.join(d, "density_a_1.vti")).copy(), device=device)
    # up to half the nodes inside the smoke, the rest elsewhere; sorted
    # node indices are x-sorted nodes
    nodes = grid_points_3d(*domain, 128, 128, 128)
    rng = np.random.RandomState(4)
    inside = dens.reshape(-1).cpu().numpy() > 0
    smoke = rng.choice(np.flatnonzero(inside), min(2048, int(inside.sum())),
                       replace=False)
    rest = rng.choice(np.flatnonzero(~inside), 4096 - smoke.size,
                      replace=False)
    pts = torch.as_tensor(nodes[np.sort(np.concatenate([smoke, rest]))],
                          device=device)
    band = _suggest_band(mix, spec, DENSITY_DT, chunk=pts.shape[0])
    with torch.no_grad():
        bk = rk4_pos_stages(_stage_velocity(mix, spec, band), pts,
                            -DENSITY_DT)
        m64 = mixture_of({k: p.double() for k, p in mix.params().items()},
                         mix.alive)
        f64 = lambda q: torch.cat([  # noqa: E731
            field.value_dense(m64, spec, q[s:s + 512])
            for s in range(0, q.shape[0], 512)])
        bk64 = rk4_pos_stages(f64, pts.double(), -DENSITY_DT)
    lo = torch.tensor(domain[0::2], device=device)
    hi = torch.tensor(domain[1::2], device=device)
    s32 = interp.trilinear_interp(
        dens, torch.minimum(torch.maximum(bk, lo), hi), domain)
    s64 = interp.trilinear_interp(
        dens.double(), torch.minimum(torch.maximum(bk64, lo.double()),
                                     hi.double()), domain)
    pos_err = float((bk.double() - bk64).abs().max())
    sample_err = float((s32.double() - s64).abs().max())
    if not (pos_err <= DENSITY_TOL_POS and sample_err <= DENSITY_TOL_SAMPLE
            and torch.isfinite(bk).all()):
        raise AssertionError(f"backtrace err {pos_err}, sample err "
                             f"{sample_err}")
    emit({"phase": "check_density", "seconds": time.perf_counter() - t0,
          "points": pts.shape[0], "band": band,
          "max_abs_err_position": pos_err, "tolerance_position":
          DENSITY_TOL_POS, "max_displacement": float(
              (bk64 - pts.double()).abs().max()),
          "max_abs_err_sample": sample_err,
          "tolerance_sample": DENSITY_TOL_SAMPLE,
          "sampled_nonzero": int((s64 > 0).sum())})


def density_512(d, device):
    """One density step at the production 512^3 grid (seconds per density
    per frame; no guard failure allowed), the seconds of writing its .vti
    as the replay writes it, and the card's busy share over a 128^3
    step."""
    from gaussian_fluids_torch.epoch_profile import profile_epoch
    from gaussian_fluids_torch.io import checkpoint, vti
    from gaussian_fluids_torch.ops import field, gsr_banded, interp
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.solver.simulate3d import (
        DENSITY_CHUNK, _grid_chunks_device, _suggest_band, advected_density)

    mix, spec = checkpoint.load_checkpoint(
        os.path.join(d, "gaussian_velocity_1.pt"), device=device)
    mix = mix.slab_sorted(spec.clamp_threshold)
    scene = get_scene_3d("ring_collide")
    domain = scene.domain
    r = scene.info["ring1"]
    t0 = time.perf_counter()
    dens = interp.seed_ring_density((512,) * 3, domain, r.center, r.normal,
                                    r.radius, r.thickness, device=device)
    _grid_chunks_device(tuple(domain), (512,) * 3, DENSITY_CHUNK, device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    before = _volume_stats(dens.cpu().numpy())
    n0, g0 = gsr_banded.launches["gsr_value_banded"], \
        gsr_banded.guard_failures()
    t0 = time.perf_counter()
    out = advected_density(dens, mix, spec, domain, DENSITY_DT, (512,) * 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gsr_banded.launches["gsr_value_banded"] - n0
    guard = gsr_banded.guard_failures() - g0
    # the banded kernel's share: its launches of one step, timed alone
    chunks, _ = _grid_chunks_device(tuple(domain), (512,) * 3,
                                    DENSITY_CHUNK, device)

    def kernels_ms(m):
        prep = field.banded_prep(m, spec)
        band = _suggest_band(m, spec, DENSITY_DT)
        windows = [field.band_window(c, c.shape[0], prep["nlo"],
                                     prep["nhi"], band, gsr_banded.TB)
                   for c in chunks]
        args = (prep["muT"], prep["ppT"], prep["v"], prep["rad"],
                prep["lo"], prep["hi"], spec.clamp_threshold, band)

        def step_kernels():
            for c, (jlo, ok) in zip(chunks, windows):
                for _ in range(4):
                    gsr_banded.gsr_value_banded(jlo, ok, c, *args)
        return time_ms(step_kernels, 3)
    banded_ms = kernels_ms(mix)
    # the order A/B: the step with the mixture x-sorted (the JAX package's
    # order), the replay's slab-major order again after it (slab, x, x,
    # slab), and the kernels' share
    xmix = mix.x_sorted()
    ab = {"slab_major_seconds": [seconds], "x_sorted_seconds": [],
          "x_sorted_band": _suggest_band(xmix, spec, DENSITY_DT),
          "x_sorted_banded_ms_per_step": kernels_ms(xmix)}
    for name, m in (("x_sorted", xmix), ("x_sorted", xmix),
                    ("slab_major", mix)):
        g1 = gsr_banded.guard_failures()
        t0 = time.perf_counter()
        other = advected_density(dens, m, spec, domain, DENSITY_DT,
                                 (512,) * 3)
        torch.cuda.synchronize()
        ab[name + "_seconds"].append(time.perf_counter() - t0)
        if gsr_banded.guard_failures() != g1:
            raise AssertionError(f"512^3 density, {name}: guard failure")
        ab[name + "_max_abs_diff"] = float((other - out).abs().max())
        del other
    host = out.cpu().numpy()
    after = _volume_stats(host)
    if not after["finite"] or after["max"] > 1 + 1e-5 or after["mass"] <= 0 \
            or guard:
        raise AssertionError(f"512^3 density: {after}, guard {guard}")
    # the replay writes each 512^3 density as inline-base64 .vti on a
    # background thread; time one such write (and its size) to set beside
    # the step's seconds
    lo, hi = np.asarray(domain[0::2]), np.asarray(domain[1::2])
    with tempfile.TemporaryDirectory(dir=d) as tmp:
        path = os.path.join(tmp, "density_512.vti")
        t0 = time.perf_counter()
        vti.write_vti_array(host, lo, (hi - lo) / 512, path)
        write_seconds = time.perf_counter() - t0
        write_bytes = os.path.getsize(path)
    small = interp.seed_ring_density((128,) * 3, domain, r.center, r.normal,
                                     r.radius, r.thickness, device=device)
    prof = profile_epoch(lambda: advected_density(
        small, mix, spec, domain, DENSITY_DT, (128,) * 3), 1)
    emit({"phase": "density512", "seconds": seconds, "setup_seconds": setup,
          "banded_ms_per_step": banded_ms, "order_ab": ab,
          "vti_write_seconds": write_seconds, "vti_bytes": write_bytes,
          "grid": [512] * 3, "chunks": -(-512 ** 3 // DENSITY_CHUNK),
          "band": _suggest_band(mix, spec, DENSITY_DT),
          "launches": launches, "guard_failures": guard,
          "before": before, "after": after,
          "profile_128": {k: prof[k] for k in (
              "wall_ms_per_epoch", "ms_per_epoch", "device_ms_per_epoch",
              "device_busy_share",
              "host_ops_per_epoch", "device_launches_per_epoch",
              "top_kernels_ms_per_epoch")}})
    return launches


def epoch_3d(device, epochs=10):
    """The Ring-Collide projection epoch under torch.profiler (seeded
    state, B = 8192, the cells kernels): device ms per epoch, the cells
    forward's share of it, the busy share."""
    from gaussian_fluids_torch.epoch_profile import _epochs_3d, profile_epoch
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state

    mix, spec, _ = ring_collide_state(device)
    prof = profile_epoch(_epochs_3d(mix, spec, device)["project"], epochs)
    fwd = sum(ms for name, ms in prof["top_kernels_ms_per_epoch"]
              if "cells_fwd_kernel" in name)
    emit({"phase": "epoch_3d", "config": "ring_collide", "epoch": "project",
          "epochs": epochs, "cells_fwd_device_ms_per_epoch": fwd,
          **{k: prof[k] for k in (
              "wall_ms_per_epoch", "ms_per_epoch", "device_ms_per_epoch",
              "device_busy_share",
              "host_ops_per_epoch", "device_launches_per_epoch",
              "top_kernels_ms_per_epoch")}})


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA GPU")
    from gaussian_fluids_torch.ops import (cuda_build, gsr_banded, gsr_cells,
                                           gsr_centered, rk4_fused)
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.scenes import get_scene_3d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    built = cuda_build.build(gsr_centered.SOURCE, gsr_cells.SOURCE,
                             gsr_banded.SOURCE, rk4_fused.SOURCE)
    gsr_centered._lib()
    gsr_cells._lib()
    gsr_banded._lib()
    rk4_fused._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(p) for k, (p, _) in built.items()},
          "built_now": any(bool(log) for _, log in built.values()),
          "ptxas": {k: ptxas_summary(log) for k, (_, log) in built.items()}})

    t0 = time.perf_counter()
    stats, shapes = kernel_phase(device)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": shapes,
          "kernels": [{k: s[k] for k in ("name", "max_abs_err",
                                         "max_rel_err", "tolerance", "ms",
                                         "plain_ms", "bound_ms")}
                      for s in stats.values()]})
    t0 = time.perf_counter()
    stats3, shapes3 = kernel_phase_3d(device)
    emit({"phase": "kernels_3d", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": shapes3,
          "kernels": [{k: s[k] for k in ("name", "max_abs_err",
                                         "max_rel_err", "tolerance", "ms",
                                         "plain_ms", "bound_ms", "bound_by")}
                      for s in stats3.values()]})
    t0 = time.perf_counter()
    stats_d, shapes_d = kernel_phase_density(device)
    emit({"phase": "kernels_density", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": shapes_d,
          "kernels": [{k: s[k] for k in ("name", "max_abs_err",
                                         "max_rel_err", "tolerance", "ms",
                                         "plain_ms", "bound_ms", "bound_by")}
                      for s in stats_d.values()]})
    t0 = time.perf_counter()
    stats_r, shapes_r = kernel_phase_rest(device)
    emit({"phase": "kernels_2d_rest", "seconds": time.perf_counter() - t0,
          "card": card, "shapes": shapes_r,
          "kernels": [{k: s[k] for k in ("name", "max_abs_err",
                                         "max_rel_err", "tolerance", "ms",
                                         "plain_ms", "bound_ms", "bound_by")}
                      for s in stats_r.values()]})

    tmp = tempfile.mkdtemp(prefix="gf_torch_smoke_")
    try:
        launches_2d, shapes_2d = run_2d(os.path.join(tmp, "2d"))
        kmix, kspec, launches_karman, shapes_karman = run_karman(
            os.path.join(tmp, "karman"))
        t0 = time.perf_counter()
        covector_fused(kmix, kspec)
        launches_heads = epoch_heads(kmix, kspec)
        emit({"phase": "karman_ab", "seconds": time.perf_counter() - t0})
        launches_3d, shapes_3d = run_3d(os.path.join(tmp, "3d"))
        epoch_3d(device)
        lmix, lspec = checkpoint.load_checkpoint(
            os.path.join(tmp, "3d", "leapfrog", "gaussian_velocity_1.pt"),
            device=device)
        lo, hi = np.float32(get_scene_3d("leapfrog").domain).reshape(3, 2).T
        pts3 = torch.as_tensor(np.random.RandomState(9).uniform(
            lo, hi, (1024, 3)).astype(np.float32), device=device)
        launches_dx = query_grad(
            [(kmix, kspec, _projection_batch(kmix, kspec, 10)[0]),
             (lmix, lspec, pts3)])
        t0 = time.perf_counter()
        fitted = kernels_fitted_3d(lmix, lspec, device)
        emit({"phase": "kernels_fitted_3d", "seconds":
              time.perf_counter() - t0, "card": card,
              "checkpoint": "3d/leapfrog/gaussian_velocity_1.pt",
              "kernels": fitted})
        t0 = time.perf_counter()
        rmix, rspec = checkpoint.load_checkpoint(
            os.path.join(tmp, "3d", "ring_collide", "gaussian_velocity_1.pt"),
            device=device)
        fitted_rc = kernels_fitted_rc(rmix, rspec, device)
        emit({"phase": "kernels_fitted_rc", "seconds":
              time.perf_counter() - t0, "card": card,
              "checkpoint": "3d/ring_collide/gaussian_velocity_1.pt",
              "kernels": fitted_rc})
        ring = os.path.join(tmp, "3d", "ring_collide")
        launches_density = run_density(ring)
        check_density(ring, device)
        launches_512 = density_512(ring, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, s in stats.items():
        s["launches"] = launches_2d[name]
    stats["gsr_fwd"]["launches_by_shape"] = shapes_2d
    kfwd = shapes_r.pop("gsr_fwd_karman_2d")
    stats["gsr_fwd"]["karman_2d"] = {
        **kfwd, "launches": shapes_karman.get(
            f"d=2,B={kfwd['B']},N={kfwd['N']}", 0),
        "launches_by_shape": shapes_karman}
    stats3["gsr_fwd[d=3]"]["launches_by_shape"] = shapes_3d
    stats3["gsr_fwd[d=3]"]["fitted_ring_collide"] = {
        k: fitted_rc[k] for k in ("gsr_fwd_batch", "gsr_fwd_test_grid_chunk")}
    for name in ("cells_bwd_dn", "cells_bwd_dn2"):
        stats3[name]["fitted_ring_collide"] = fitted_rc[name]
    for name, s in stats3.items():
        s["launches"] = launches_3d[name.split("[")[0]]
        if name.split("[")[0] in fitted:
            s["fitted_leapfrog_3d"] = {
                k: fitted[name.split("[")[0]][k] for k in (
                    "ms", "ms_1x1", "split", "worker_tiles_mean",
                    "worker_tiles_max", "max_rel_err_splits",
                    "live_tile_fraction", "support_pairs")}
    for name, s in stats_d.items():
        s.update(launches=launches_density[name] + launches_512,
                 launches_replay_128=launches_density[name],
                 launches_512_step=launches_512)
    stats_r["gsr_bwd_dx"]["launches"] = launches_dx[2]["gsr_bwd_dx"]
    stats_r["gsr_bwd_dx[d=3]"]["launches"] = launches_dx[3]["gsr_bwd_dx"]
    stats_r["gsr_bwd_dn3"]["launches"] = launches_heads["gsr_bwd_dn3"]
    stats_r["rk4_fused"]["launches"] = launches_karman["rk4_fused"]
    missing = [n for n, s in {**stats, **stats3, **stats_d,
                              **stats_r}.items() if s["launches"] == 0]
    if missing:
        raise AssertionError(f"not launched on their main path: {missing}")
    print(f"total seconds: {time.perf_counter() - t_all:.1f}")
    emit({"kernels": list(stats.values()) + list(stats3.values())
           + list(stats_d.values()) + list(stats_r.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
