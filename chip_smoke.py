#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gaussian_fluids_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  build         compile csrc/gsr_centered.cu, csrc/gsr_cells.cu,
                csrc/gsr_banded.cu and csrc/rk4_fused.cu with nvcc into
                gaussian_fluids_torch/_build/, one nvcc per source, started
                together (skipped when already built); meanwhile a thread
                imports torch._dynamo, which the 2D scenes' torch.func
                Jacobians import at their first call
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
                x-sorted, with its own band, timed beside it; then the
                replay's chunk as four stage launches (each tile on its
                own window, the last one sampling the 512^3 ring density)
                against the eager chain it replaces: the largest gap
                (bitwise: 0), both timed, the launches' bounds
  kernels_2d_rest  the dL/dx kernel, the triple-cotangent backward and the
                fused RK4 backtrace at Karman-2D shapes (B=512, N=24,576,
                the seeded Karman state; the triple backward over 512 data
                rows and the scene's 3072 boundary rows), and the dL/dx
                kernel again at Leapfrog-3D shapes (N=1024; B=1024 as the
                path's query_grad runs it, and B=8192), each against its
                plain version; the forward (row 1) at Karman-2D shapes at
                every split; dL/dx (both shapes) and the fused RK4 kernel
                at every split S, the triple backward at every split
                (W, S), all variants, two launches bitwise equal, each
                split timed, with the best split beside the chosen one;
                the pairs the triple backward walks and those a box test
                on the rows' radii would let through; the Gaussian tiles
                the fused RK4
                kernel's box test lets through at each stage and the pairs
                they hold
  initialize    the leapfrog scene fitted at 71x71 = 5041 Gaussians through
                the entry point ``gaussian_fluids_torch.initialize2d``,
                figures on (the default): the card's machine has no
                matplotlib, so the run prints one line and draws nothing
  advance       one frame (clone -> advect -> project) at dt .025 through
                ``gaussian_fluids_torch.advance2d``;
                losses and the divergence residual
  check         the final 2D field through the kernels against the plain
                dense field evaluation in float64
  figures_2d    the 2D figures' field sweeps (``simulate2d.figure_arrays``)
                on that frame: velocity on the two 30x30 grids, vorticity
                and divergence on the 200x200 grid, against float64 dense
                (FIGURE_TOL); row 1's launches by shape; the 2D runs'
                matplotlib lines and PNGs (none without matplotlib)
  profile       ``advance2d --profile DIR`` for a short frame from the fit
                (GF_PROFILE_SECONDS bounded): the Chrome trace exists,
                parses and names gsr_fwd_kernel
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
  vortices_pass_2d  vortices_pass (71x71 = 5041 Gaussians, capacity 6144,
                B=512, its flux batch 3 x 512) through initialize2d (100
                fit epochs) and one advance2d frame at dt .01 (100 + 100
                epochs, the targets hoisted): the final field against
                float64 dense, the obstacles' mean |u.n| on 4096 circle
                points after the fit and after the frame, row 1's
                launches by shape
  initialize3d  3D scenes fitted through ``gaussian_fluids_torch.initialize3d``:
                leapfrog (10^3 = 1000 Gaussians, the centered kernels at
                d=3) and ring_collide (40^3 = 64,000 Gaussians, capacity
                75,776, B=8192, the cells kernels), under --no_viz (no
                volumes: the times are the solver's)
  advance3d     one frame each (clone -> advect -> project) at dt .02
                through ``gaussian_fluids_torch.advance3d`` on the scene's
                128^3 test grid, --no_viz; losses and the divergence
                residual
  curves_3d     the Ring-Collide frame's projection with its loss curves
                collected (``project_3d(collect_curves=True)``, no extra
                epochs): one entry an epoch, one a chunk, all finite
  hoist         the exact-target hoist (the default on the card): the
                hoisted targets against the per-epoch ones on the same
                draws (Ring-Collide 25 x 8192, vortices_pass 100 x 512,
                Karman 100 x 512 under GF_FUSED_RK4=1; bitwise or not, the
                largest difference, within HOIST_TOL); rows 1, 5 and 9 at
                the shapes the hoist and the target grid give them (row 1
                d=2 at B=51,200 and 1536, row 5 at B=204,800 against
                N=75,776 and N=1024 and at B=32,768, row 9 at B=51,200)
                against their plain versions (on batch-sized row slices
                where the dense planes would not fit), timed, with their
                bounds; the Ring-Collide projection epoch in chunks of 25,
                hoisted and under GF_HOIST_TARGETS=0: wall ms alternated
                p c c p (their profiles are ``epoch_profile``'s); no work
                list overflowed
  target_grid_rc  a Ring-Collide projection chunk under --target_grid 128
                on the fitted Ring-Collide field: the grid's build seconds
                and launches; the grid at 8192 of its nodes against the
                exact targets there (1e-4 of the largest entry); the
                interpolated targets against the exact ones at 8192
                points off the nodes, reported (largest, 99th percentile,
                mean difference); 25 epochs on the interpolated targets
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
  backends      GF_FIELD_BACKEND auto, pallas, cells (2D) and sparse on
                8192 sorted queries of the Ring-Collide frame 1 (64,000
                Gaussians) and the Leapfrog-2D frame 1: value_and_jac and
                two_head_grads against auto (TOL), ms per call, two sparse
                calls bitwise equal; the oracle at the most cells that
                hold each state's radii, no call falling back
  cells_2d      GF_FIELD_BACKEND=cells at d=2: a Leapfrog-2D clone chunk
                and a projection chunk against the default path on the
                same draws (parameters within TOL); the d=2 instantiations
                of rows 5-7 at Leapfrog-2D shapes against their plain
                versions, timed, with their bounds
  density3d     the smoke replay through ``gaussian_fluids_torch.advance_density3d``
                (--density_res_multiplier 1: 128^3 nodes) on ring_collide's
                checkpoints 0 and 1: densities a and b, two steps each, .vti
                and pooled .npz files checked
  check_density the RK4 backtrace of 4096 seeded grid nodes through the
                banded kernel against the dense plain backtrace in float64 on
                frame 1's mixture, and the density sampled there
  density512    one advected_density step of one density at the production
                512^3 grid on frame 1's mixture, timed (fails where a query
                tile swept the whole axis: banded_swept_tiles over a second
                step, bitwise the first), with the banded kernel's device
                ms of such a step on the host's windows;
                one timed write of its .vti as the replay writes it
                (transposed on the card, copied, written as appended raw
                data: the file's encoding is checked); and the card's busy
                share over a 128^3 step
                (torch.profiler)
  analysis      the port's run analyzers (``gaussian_fluids_torch.scripts.
                analyze_*``) in this process on the card: leapfrog2d,
                karman2d, vortices_pass2d, ring3d and rc_tg128_ab on the
                run directories above, density3d on the replay's 128^3
                volumes; ring3d on the committed Ring-Collide checkpoint 0
                of the JAX run, its row held against the JAX analyzer's
                (runs_r2_evidence/analyze_ring3d_rc.txt) within one unit of
                each printed digit; row 1's launches by shape on this path
                and its ms at the 2D analyzers' grids (B = 25,600 at
                Leapfrog-2D, 25,000 at Karman-2D) at every split against
                the plain version
  spatial_key   GF_SPATIAL_KEY=morton on the fitted Ring-Collide mixture
                (frame 1, Morton-sorted) and 8192 seeded points: the cells
                path (row 5, the queries sorted by the key inside) and the
                centered path (row 1, presorted by the key) against the
                default order after the inverse permutation (TOL); the
                live tile fraction in both orders
  epoch_roofline  the projection epoch's modelled FLOPs and bytes
                (``gaussian_fluids_torch.utils.roofline``) over the walls
                already measured: the seeded Ring-Collide epoch at the
                hoist phase's four walls, the Leapfrog-2D frame's
                projection over its seconds; mfu_fp32_pct and hbm_pct, the
                card's name and power limit; no extra epoch
  obstacle3d    ring_with_obstacle (40^3 = 64,000 Gaussians, capacity
                75,776, B=8192, the boundary batch box + mesh 2 x 8192)
                through initialize3d (100 fit epochs) and one frame of
                advance3d (100 + 100 epochs) with the volumes on, at the
                scene's 128^3 grid: the JAX package's file set
                (obstacle.obj, the four *_ref.vti,
                vorticity_/divergence_{0,1}.vti, the checkpoints; not its
                loss_1.png figure), the final field and 4096 seeded nodes
                of each frame-1 volume against float64 dense, the seconds
                of the volumes apart from the solve, and the obstacle's
                mean |u.n| on 4096 mesh samples after the fit and after
                the frame
  replay_vs_jax the committed Ring-Collide run's checkpoint 0 (written by
                the JAX package) replayed one step through
                ``advance_density3d`` at 512^3; its pooled float16
                densities of frame 1 against the JAX replay's
                (runs_r2_evidence/ckpts/output_3d_ring_collide/
                density_small_{a,b}_1.npz): max abs and relative L2
                difference and mass, within REPLAY_TOL; the replay's own
                .vti writes (seconds, bytes, and the encoding read back
                from the files)
  mesh_error    three launches side by side of two ranks sharing the card
                over gloo, rank 1 raising while rank 0 waits in a
                broadcast: each raises rank 1's own error (run from a
                thread beside vortices_pass_2d and the 3D entry points)
  (the mesh phases run ``gaussian_fluids_torch.mesh_check``'s checks,
  which that module runs on several GPUs over NCCL; their processes run
  from threads beside obstacle3d and replay_vs_jax, their checks after)
  mesh_epoch    two ranks sharing the card over gloo with CUDA tensors
                (``parallel.mesh.launch(shared_device=True)``; the CLI
                never asks for it) at 1x2 and 2x1 in one launch: one
                sharded projection
                and one sharded clone epoch at Leapfrog-2D (5041
                Gaussians, capacity 6144, B=512) and Ring-Collide (64,000,
                capacity 75,776, B=8192; at 1x2 each rank holds 37,888
                and takes the cells path) from the same seeded inputs,
                against the single-device epochs on the card: losses,
                gradients (Adam's first moments) and parameters within
                ``mesh_check``'s MESH_* tolerances, every rank's
                parameters equal; each
                rank's launches by kernel; the epoch's wall ms on each rank
                beside the single-device epoch's; gloo's all-reduce and
                broadcast, the port's two collectives, on CUDA tensors
  mesh_density  in the same launches, the sharded 128^3 density step
                (each rank's stages on the banded kernel, row 8, over its
                shard of the slab-major mixture) on the fitted
                Ring-Collide checkpoint 1, against the single-device
                step (within ``mesh_check.DENSITY_TOL``), seconds on each
                rank
  mesh_cli      ``advance2d --mesh 1x1`` (NCCL) for one Leapfrog-2D frame
                from the smoke's fit against the smoke's single-device
                frame (finite test metrics, one checkpoint a frame, the
                same Gaussian count, the field within MESH_FIELD_TOL),
                and, run alongside it from a second thread,
                ``advance_density3d --mesh 1x1`` for one 128^3 step of
                Ring-Collide's checkpoint 0 against density3d's step
                (``DENSITY_TOL``);
                both again at --mesh 2x1 where two GPUs are visible
  production    ``gaussian_fluids_torch.scripts.production``'s chain on
                the Leapfrog-2D run of ``advance``: one more frame at 100
                epochs through ``Chain.advance`` (``--start_frame 1`` and
                the remaining horizon, in a child process on the card),
                then a step that fails on purpose, whose ``FAILED rc=``
                and ``[tail]`` lines ``chain.log`` must hold; the failure
                of any other step fails the phase; the run's
                ``report_runs`` line. It runs alone: its children launch
                kernels in processes of their own
Launches are counted per path: each path's counts are set to 0 just
before it and read just after; the 2D lines of the kernel summary carry
the Leapfrog-2D path's launches, the d=3 and cells lines the 3D path's,
the d=2 cells lines (``cells_fwd[d=2]`` ...) cells_2d's chunks under
GF_FIELD_BACKEND=cells; each kernel's plain version is timed once, at
its main shape (one call, after the comparison has run it);
the forward's are also counted per shape (d, B, N) on every path
(``launches_by_shape``; the Karman path's under ``karman_2d``, the
vortices_pass path's under ``vortices_pass_2d``), and so are the cells
forward's (B, N) and the fused RK4 kernel's; each shape the hoist or the
target grid adds carries its own entry (``hoisted_B...``) with its
launches on the path that runs it.
The run fails if a kernel of a path was not launched there, or if a cells
work list overflowed at the default capacity. The banded kernel's path is
the replay (density3d and density512: its launches are their sum), the
fused RK4 kernel's the Karman frame (row 9 by shape: the hoisted sweep
at B=51,200), the triple backward's epoch_heads,
the dL/dx kernel's query_grad; obstacle3d is a second path of rows 1 and
5-7 (the 3D lines add its launches to the 3D path's), replay_vs_jax a
third of row 8; the mesh phases' ranks count their own (set to 0 just
before each sharded epoch or density step and read after it), and the
summary adds their sums by path (``launches_mesh``: the Leapfrog-2D
epochs' to the 2D lines, Ring-Collide's to the d=3 and cells lines, the
density step's to row 8's). Then the per-kernel summary (each bound
counted on the pairs the inputs need, those with g >= c, with the bound
of the pairs the kernel walks beside it), the card's name and power
limit, and as the last line
``{"ok": true, "device": {...}}``. Solver output goes to a temporary
directory outside the checkout, deleted at the end. Any failure raises;
without a CUDA device the script exits non-zero before printing results.
"""

import contextlib
import importlib
import io
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the bound model: per-pair operation counts, a launch's bound at the
# card's peaks
from gaussian_fluids_torch.utils.roofline import (
    OPS_BANDED_SUPPORT, OPS_BANDED_WINDOW, OPS_GEOMETRY, OPS_SUPPORT,
    kernel_bound, pair_ops)

INIT_EPOCHS = 100      # 2D; the entry point's default is 10000
ADVANCE_EPOCHS = 100   # 2D, per phase and frame; the default is 20000
INIT3D_EPOCHS = 100    # the 3D entry point's default is 500
ADVANCE3D_EPOCHS = 100  # 3D, per phase; the default is 20000
TIMED_LAUNCHES = 30
TOL = 1e-4   # relative to the largest reference entry: f32 sums in another
#              order and FMA contraction on the card

KARMAN_INIT_EPOCHS = 100     # fit and the zero-dt projection; default 10000
KARMAN_ADVANCE_EPOCHS = 100  # per phase; the default is 20000
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
# The committed Ring-Collide run's replay against the JAX replay's pooled
# float16 volumes (reasoned in PERF.md §6 before its first run): f16
# storage (2^-11 at 1, each side half of it), a seed node flipped by f32
# rounding (1/512 of a cell), and the JAX kernel's single bf16 pass of
# its value contraction (2^-8 of a term) over the backtrace (reasoned at
# dt .02, 6e-3 or 3 nodes of the 512^3 grid; the committed run's dt .1
# makes it 5x longer), of which a quarter of a cell's nodes sample the
# indicator's sloped layer.
REPLAY_TOL = {"max_abs_diff": 1e-2, "rel_l2_diff": 1e-2,
              "rel_mass_diff": 1e-3}
REPLAY_DT = 0.1  # the committed replay's step: --dt .1 in
#                  scripts/run_production_chain5.sh:119
OBSTACLE_INIT_EPOCHS = 100     # the obstacle scene's fit; default 500
OBSTACLE_ADVANCE_EPOCHS = 100  # per phase of its frame; default 20000
OBSTACLE_VOLUME_TOL = 1e-3     # frame volumes against float64 dense, of
#                                the largest entry (as check3d's field)
VP_INIT_EPOCHS = 100      # the vortices_pass fit; the default is 10000
VP_ADVANCE_EPOCHS = 100   # per phase of its frame; the default is 20000
VP_DT = 0.01              # the committed vortices_pass runs' step
#                           (scripts/run_production_chain5.sh:137)
HOIST_CHUNK = 25          # epochs of the hoist A/B's and the grid mode's
#                           chunks: one sweep of 25 x 8192 at Ring-Collide,
#                           the shape of the solver's (check_iter 100 gives
#                           four: sweep_group(100, 8192) = 25)
HOIST_TOL = 1e-4          # hoisted against per-epoch targets, of the
#                           largest entry (reasoned in PERF.md §6 before the
#                           first run)
GRID_RES = 128            # the committed Ring-Collide run's --target_grid
#                           (scripts/run_production_chain5.sh:251)
GRID_TOL = 0.02           # interpolated against exact targets, of the
#                           largest entry: tests/test_target_grid.py:34
#                           holds the JAX package's grid mode to it on a
#                           smooth field; reported here, not gated (the
#                           fitted Ring-Collide field misses it at its
#                           worst points: PERF.md §6)
FIGURE_TOL = 1e-3         # the figures' sweeps against float64 dense, of
#                           the largest entry (as check's final field)
PROFILE_EPOCHS = 10       # the --profile frame's epochs a phase
PROFILE_SECONDS = 60      # its capture window (GF_PROFILE_SECONDS)
BACKEND_B = 8192          # queries of the backends phase
CELLS_2D_EPOCHS = 10      # epochs of each cells_2d chunk
MESH_ERROR_LAUNCHES = 3
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
    # one write a line: lines from the phases' threads never interleave
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def process_seconds() -> float:
    """Wall seconds since this process started, its imports included
    (Linux's /proc): the clock of PERF.md's cold-smoke limit, short of the
    interpreter's own start-up."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=TIMED_LAUNCHES):
    """Median device milliseconds of ``fn`` over ``reps`` calls, queued
    behind a sleep kernel (``gaussian_fluids_torch.utils.timing``)."""
    from gaussian_fluids_torch.utils.timing import time_ms as timed
    return timed(fn, reps)


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


def _entry(name, route_src, errs, ms, plain_ms, ops, nbytes, walked_pairs,
           support_pairs, note=NO_LIBRARY):
    """The summary line of one kernel: ``ops`` is ``pair_ops``'s (need,
    walked) pair; the bound is on need, the walked bound beside it."""
    bound_ms, bound_by = kernel_bound(ops[0], nbytes)
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
        "walked_bound_ms": kernel_bound(ops[1], nbytes)[0],
    }


def plain_once(fn):
    """Device ms of one call of a plain twin, which the comparison has just
    run: each twin is timed once a run, at its kernel's main shape (PERF.md
    keeps the medians of earlier runs at the other shapes)."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def _run_cases(cases, d, live_pairs, support_pairs, in_bytes, time_plain,
               tag=""):
    """Compare every variant of every kernel with its plain version, time
    the main path's variant (the first) and, where ``time_plain``, its
    plain version once, and build the summary entries."""
    stats = {}
    for name, (src, key, variants, extra_bytes, walk_bytes) in cases.items():
        errs = [compare(f"{name}{tag}[{i}]", k(), p(), TOL)
                for i, (k, p) in enumerate(variants)]
        torch.cuda.synchronize()
        kern, plain = variants[0]
        ms = time_ms(kern)
        plain_ms = plain_once(plain) if time_plain else None
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


def check_splits(name, splits, variants, key=_fwd_key):
    """Every variant (tag, kernel taking split=, plain) at every split
    against its plain twin (TOL), two launches of each bitwise equal;
    returns the largest relative error."""
    errs = []
    for tag, kern, plain in variants:
        want = _flat(plain())
        for sp in splits:
            a, b = _flat(kern(split=sp)), _flat(kern(split=sp))
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name}[{tag}] at split {sp}: two "
                                     f"launches differ")
            errs.append(compare(f"{name}[{tag}, {key(sp)}]", a, want,
                                TOL)[1])
    return max(errs)


def time_splits(kern, splits, key=_fwd_key):
    """{split: median ms} of kern(split=) at every split, in this call,
    and the fastest forced split."""
    torch.cuda.synchronize()
    ms = {key(sp): time_ms(lambda sp=sp: kern(split=sp)) for sp in splits}
    return ms, min((k for k in ms if k != "chosen"), key=ms.get)


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
    err = check_splits("gsr_fwd", splits, [
        (nj, lambda split, nj=nj: gc.gsr_fwd(*args, clamp, nj, rad,
                                             split=split),
         lambda nj=nj: gc.fwd_plain(*args, clamp, nj)) for nj in (d, 0)])
    ms, _ = time_splits(lambda split: gc.gsr_fwd(*args, clamp, d, rad,
                                                 split=split), splits)
    chosen = gc.fwd_split(*tmask.shape, gc._sm_count(0))
    return {"split": chosen, "blocks": tmask.shape[0] * chosen,
            "ms": ms["chosen"], "ms_1": ms["1"], "ms_by_split": ms,
            "splits_checked": 2 * len(splits),
            "max_rel_err_splits": err, "bitwise_repeat": True}


def fwd_shape_entry(args, rad, clamp):
    """Row 1's summary at one more shape: every split (fwd_split_report)
    and the bound on need beside the walked bound, with the pairs whose
    geometry the box test lets through (the plain twin is timed at row
    1's main shapes only: ``plain_ms`` None)."""
    from gaussian_fluids_torch.ops import gsr_centered as gc
    tmask, x_p, muT, ppT, v = args
    d, B, N = x_p.shape[1], x_p.shape[0], muT.shape[1]
    rep = fwd_split_report(args, rad, clamp)
    plain_ms = None
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
    stats = _run_cases(cases, 2, live_pairs, support_pairs, in_bytes, True)
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
        (tmq, xq_p, muT, ppT, v), radq, clamp)
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
             v_p.contiguous()), rad, clamp)
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
        True, tag="[d=3]")
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
        qrad, clamp)
    rc_cases = _centered_cases_3d(tmask, x_p, muT, ppT, v, clamp, dout,
                                  dout_val, rad)
    at_rc = _run_cases(rc_cases, 3, live_pairs, support_pairs, par_bytes,
                       False, tag="[d=3]")
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
             qv.contiguous()), qrad, clamp)
    for name, s_ in stats.items():
        s_.update(shape="Leapfrog-3D", B=lx_p.shape[0], N=lmuT.shape[1],
                  live_tile_fraction=float(ltm.float().mean()),
                  ring_collide={k: at_rc[name][k] for k in (
                      "ms", "plain_ms", "bound_ms", "walked_bound_ms",
                      "max_rel_err", "support_pairs", "walked_pairs",
                      "split", "B4096", "B32768") if k in at_rc[name]})
    stats["gsr_fwd[d=3]"]["ring_collide"]["box_pairs"] = box_pairs
    cstats = _run_cases(cells, 3, live_pairs, support_pairs, par_bytes,
                        True)
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


def kernel_phase_rest(device):
    """Kernels 4, 9 and 10 at Karman-2D shapes on the seeded Karman state,
    and kernel 4 at Leapfrog-3D shapes, against their plain versions."""
    from gaussian_fluids_torch.utils.seeded_state import (
        karman_boundary_rows, karman_state, ring_collide_state)
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
                                   plain_once(plain), ops, nbytes, walked,
                                   support)

    # kernel 4 at d = 2 (Karman, B = 512) and at d = 3 where the path runs
    # it (the Leapfrog-3D frame's mixture, 1024 query points), with the
    # d = 3 time at B = 8192 as a second number; at the first two shapes
    # every split S
    for d, (m, sp, xq) in ((2, (mix, spec, x)),
                           (3, ring_collide_state(device, side=10,
                                                  n_queries=1024)),
                           (3, ring_collide_state(device, side=10))):
        x_p, _, _, mp, pp, vp, tmask, rad4 = field._centered_prep(
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
        variants = [(nj, lambda split=None, a=args, o=o, nj=nj, c=c, r=rad4:
                     gc.gsr_bwd_dx(*a, o, c, nj, r, split=split),
                     lambda a=args, o=o, nj=nj, c=c: gc.bwd_dx_plain(
                         *a, o, c, nj)) for nj, o in ((d, dout), (0, dval))]
        entry("gsr_bwd_dx", "gsr",
              pair_ops(OPS_GEOMETRY[d], OPS_SUPPORT[(d, "bwd_dx")], live,
                       sup),
              [(k, p_) for _, k, p_ in variants],
              4 * (tmask.numel() + 2 * x_p.numel() + args[2].numel()
                   + args[3].numel() + args[4].numel() + dout.numel()),
              live, sup, tag)
        shapes[f"bwd_dx_d{d}_B{B}"] = {
            "B": B, "N": args[2].shape[1], "live_pairs": live,
            "box_pairs": _box_pairs(tmask, x_p, args[2], rad4, gc.TB,
                                    gc.TN),
            "support_pairs": sup}
        if B == 8192:
            continue
        splits = [None] + list(gc.SPLIT_S)
        err = check_splits("gsr_bwd_dx" + tag, splits, variants)
        ms, best = time_splits(variants[0][1], splits)
        chosen = gc.fwd_split(*tmask.shape, gc._sm_count(0), gc.DX_MIN_TILES)
        stats["gsr_bwd_dx" + tag]["split"] = {
            "split": chosen, "blocks": tmask.shape[0] * chosen,
            "ms": ms["chosen"], "ms_by_split": ms, "best_split": best,
            "splits_checked": 2 * len(splits), "max_rel_err_splits": err,
            "bitwise_repeat": True}
    second = stats.pop("gsr_bwd_dx[d=3,B=8192]")
    stats["gsr_bwd_dx[d=3]"]["at_B8192"] = {k: second[k] for k in (
        "ms", "plain_ms", "bound_ms", "walked_bound_ms", "max_rel_err")}

    # row 1 at Karman-2D (B = 512, N = 24,576), every split
    x_p, _, _, mp, pp, vp, tmask, rad = field._centered_prep(
        mix, spec, x, gc.TB, gc.TN, presorted=True)
    shapes["gsr_fwd_karman_2d"] = fwd_shape_entry(
        (tmask, x_p, mp.T.contiguous(), pp.T.contiguous(), vp.contiguous()),
        rad, clamp)

    # kernel 10 over [512 data rows; the scene's 3072 boundary rows], at
    # every split (W, S)
    scene = get_scene_2d("karman")
    gen = torch.Generator(device=device).manual_seed(6)
    xb, _, _, _ = karman_boundary_rows(scene, gen, 512, device)
    x_dp = field._pad_axis(x, gc.TB)
    rows = x_dp.shape[0]
    x_c, _, _, _, _, _, tmask, rad10 = field._centered_prep(
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
    variants = [(uv, lambda split=None, uv=uv: gc.gsr_bwd_dn3(
        *args, *douts, dout3, clamp, 2, rows, use_val12=uv, split=split),
        lambda uv=uv: gc.bwd_dn3_plain(*args, *douts, dout3, clamp, 2,
                                       rows, use_val12=uv))
        for uv in (False, True)]
    entry("gsr_bwd_dn3", "gsr", (need_d + need_b, walk_d + walk_b),
          [(k, p_) for _, k, p_ in variants],
          4 * (tmask.numel() + x_c.numel() + 2 * douts[0].numel()
               + dout3.numel()) + par_bytes + 3 * 4 * N * (6 + 2),
          live, sup_d + sup_b)
    splits = [None] + [(w_, s_) for w_ in gc.SPLIT_W for s_ in gc.SPLIT_S]
    err = check_splits("gsr_bwd_dn3", splits, variants, _split_key)
    ms, best = time_splits(variants[0][1], splits, _split_key)
    chosen = gc.bwd_split(*tmask.shape, gc._sm_count(0))
    shares = gc.worker_tiles(tmask, chosen).double()
    col_live = tmask.bool().sum(0).double()
    stats["gsr_bwd_dn3"]["split"] = {
        "split": list(chosen), "blocks": tmask.shape[1] * chosen[1],
        "threads_per_block": gc.TN * chosen[0], "ms": ms["chosen"],
        "ms_by_split": ms, "best_split": best,
        "worker_tiles_mean": float(shares.mean()),
        "worker_tiles_max": int(shares.max()),
        "splits_checked": len(splits) * len(variants),
        "max_rel_err_splits": err, "bitwise_repeat": True}
    # the walked pairs a box test on the rows' radii would let through
    # (the kernel does not box them: timed slower, csrc/gsr_centered.cu)
    box = _box_pairs(tmask, x_c, muT, rad10, gc.TB, gc.TN)
    shapes["bwd_dn3"] = {"B": B, "data_rows": rows,
                         "boundary_rows": xb.shape[0], "N": N,
                         "live_tile_fraction": float(tmask.float().mean()),
                         "column_live_tiles_mean": float(col_live.mean()),
                         "column_live_tiles_max": int(col_live.max()),
                         "walked_pairs": live, "box_pairs": box,
                         "box_fraction": box / max(live, 1),
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
    variants = [(nj, lambda split=None, nj=nj: rk.fused_rk4(
        x, muT, ppT, v, dt, clamp, nj, rad, lo, hi, split=split),
        lambda nj=nj: rk.rk4_plain(x, muT, ppT, v, dt, clamp, nj))
        for nj in (2, 0)]
    entry("rk4_fused", "rk4",
          tuple(sum(o[i] for o in stage_ops) for i in range(2)),
          [(k, p_) for _, k, p_ in variants],
          4 * x.numel() + par_bytes + 4 * x.shape[0] * (2 + 6),
          sum(walked), sum(sup))
    # every split S against the plain twin, two launches bitwise equal,
    # each split timed
    splits = [None] + list(gc.SPLIT_S)
    err = check_splits("rk4_fused", splits, variants)
    ms, best = time_splits(variants[0][1], splits)
    chosen = gc.fwd_split(x.shape[0] // rk.TB, N // rk.TN, gc._sm_count(0))
    pairs = x.shape[0] * N
    stats["rk4_fused"]["split"] = {
        "split": chosen, "blocks": x.shape[0] // rk.TB * chosen,
        "ms": ms["chosen"], "ms_1": ms["1"], "ms_by_split": ms,
        "best_split": best, "splits_checked": 2 * len(splits),
        "max_rel_err_splits": err, "bitwise_repeat": True}
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
         "--last_time", ".025", "--max_epoch", str(ADVANCE_EPOCHS)])
    torch.cuda.synchronize()
    launches = dict(gsr_centered.launches)   # initialize + advance
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    check_frames(frames, 1, "2D")
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
    written = sorted(f for f in os.listdir(tmp) if f.endswith(".pt"))
    want = [f"gaussian_velocity_{i}.pt" for i in range(2)]
    if written != want:
        raise AssertionError(f"checkpoints {written} != {want}")
    pts = grid_points_2d(-5, 5, -5, 5, 64, 64)
    emit({"phase": "check", "seconds": time.perf_counter() - t0,
          **check_field(mix, spec, pts, f64=True)})
    return launches, by_shape, frames[0]["project_seconds"]


def _shape_counts(fwd_shapes):
    """Row 1's launches by shape, keyed for JSON."""
    return {f"d={d},B={b},N={n}": c for (d, b, n), c in fwd_shapes.items()}


def _cells_shapes():
    """Row 5's launches by shape since the last reset, keyed for JSON."""
    from gaussian_fluids_torch.ops import gsr_cells
    return {f"B={b},N={n}": c for (b, n), c in gsr_cells.fwd_shapes.items()}


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


def _profile(fn, calls=3):
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
    rk4_shapes = {f"B={b},N={n}": c for (b, n), c in rk4_fused.shapes.items()}
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
          "rk4_fused_launches_by_shape": rk4_shapes,
          **{"check_" + k: v for k, v in check_field(
              mix, spec, pts, f64=True).items()}})
    return mix, spec, launches, by_shape, rk4_shapes


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

    t0 = time.perf_counter()
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
    emit({"phase": "covector_fused", "seconds": time.perf_counter() - t0,
          "batch": x.shape[0],
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
    from gaussian_fluids_torch.utils.seeded_state import karman_boundary_rows

    t0 = time.perf_counter()
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
    walls = {"fused_wall_ms": wall_ms(fused),
             "separate_wall_ms": wall_ms(separate)}
    t1 = time.perf_counter()
    profiles = {"fused_profile": _profile(fused),
                "separate_profile": _profile(separate)}
    emit({"phase": "epoch_heads", "seconds": time.perf_counter() - t0,
          "profile_seconds": time.perf_counter() - t1,
          "data_rows": x.shape[0], "boundary_rows": xb.shape[0],
          "losses": [float(v) for v in ls],
          "max_abs_err": max(e for e, _ in errs),
          "max_rel_err": max(r for _, r in errs), "tolerance": TOL,
          **walls, **profiles, "launches_fused_call": launches})
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
    the 3D entry points; the Ring-Collide frame's projection collects its
    loss curves (curves_3d: one entry an epoch of the per-epoch curves,
    one a chunk of the per-chunk ones, all finite); returns the 3D path's
    launches per wrapper."""
    from gaussian_fluids_torch import advance3d, initialize3d
    from gaussian_fluids_torch.ops import gsr_cells, gsr_centered
    from gaussian_fluids_torch.solver import simulate3d

    curves = []
    project_3d = simulate3d.project_3d

    def collecting(*a, **k):
        new, last, c = project_3d(*a, **{**k, "collect_curves": True})
        curves.append(c)
        return new, last, c

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
             str(INIT3D_EPOCHS), "--no_viz"])
        mid = counts()
        emit({"phase": "initialize3d", "scene": scene,
              "seconds": time.perf_counter() - t0, "epochs": INIT3D_EPOCHS,
              "n_gaussians": mix.n_alive(), "capacity": mix.capacity,
              "batch": 8192,
              "launches": {k: mid[k] - before[k] for k in mid}})
        t0 = time.perf_counter()
        if scene == "ring_collide":
            simulate3d.project_3d = collecting
        try:
            mix, spec, frames = advance3d.main(
                ["--init_cond", scene, "--dir", d, "--dt", ".02",
                 "--last_time", ".02", "--max_epoch",
                 str(ADVANCE3D_EPOCHS), "--no_viz"])
        finally:
            simulate3d.project_3d = project_3d
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
    # one chunk of ADVANCE3D_EPOCHS (= check_iter) epochs: as many entries
    # in each per-epoch curve, one in each per-chunk curve
    lens = {k: len(v) for k, v in curves[0].items()} if curves else {}
    want = {"train_vor": ADVANCE3D_EPOCHS, "train_div": ADVANCE3D_EPOCHS,
            "log_lr": ADVANCE3D_EPOCHS, "test_vor": 1, "test_div": 1}
    if len(curves) != 1 or lens != want or not all(
            np.isfinite(v).all() for v in curves[0].values()):
        raise AssertionError(f"curves_3d: {len(curves)} projections, "
                             f"lengths {lens} (want {want})")
    emit({"phase": "curves_3d", "scene": "ring_collide", "lengths": lens,
          "train_vor_first_last": [curves[0]["train_vor"][0],
                                   curves[0]["train_vor"][-1]],
          "test_vor": curves[0]["test_vor"],
          "test_div": curves[0]["test_div"],
          "log_lr_last": curves[0]["log_lr"][-1]})
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    cells_shapes = _cells_shapes()
    overflows = gsr_cells.overflows()
    if any(overflows.values()):
        raise AssertionError(f"cells work lists overflowed: {overflows}")
    t0 = time.perf_counter()
    pts = np.random.RandomState(3).uniform(0, 1, (4096, 3)) \
        .astype(np.float32)
    emit({"phase": "check3d", "scene": "ring_collide",
          "seconds": time.perf_counter() - t0, "cells_overflows": overflows,
          "gsr_fwd_launches_by_shape": by_shape,
          "cells_fwd_launches_by_shape": cells_shapes,
          **check_field(mix, spec, pts, f64=True)})
    return total, by_shape, cells_shapes


def _flux(mix, spec, pts, nrm):
    """analysis.flux_stats of the mixture's velocity at boundary points:
    (mean |u.n|, max |u.n|)."""
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.utils import analysis
    with torch.no_grad():
        vel = field.value(mix, spec, pts, need_dx=False)
    return analysis.flux_stats(vel.double().cpu().numpy(),
                               nrm.double().cpu().numpy())


def check_volumes(d, mix, spec, domain, shape, tag, n=4096):
    """``n`` seeded nodes of ``vorticity_{tag}.vti`` and
    ``divergence_{tag}.vti`` against |curl u| and div u of the float64
    dense Jacobian at those nodes, each within OBSTACLE_VOLUME_TOL of its
    largest entry there."""
    from gaussian_fluids_torch.io import vti
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.solver import losses
    from gaussian_fluids_torch.utils.grids import axis_nodes

    idx = np.random.RandomState(12).randint(0, shape, (n, 3))
    pts = np.stack([axis_nodes(domain[2 * i], domain[2 * i + 1], shape[i])
                    [idx[:, i]] for i in range(3)], -1)
    m64 = mixture_of({k: p.double() for k, p in mix.params().items()},
                     mix.alive)
    with torch.no_grad():
        jac = field.value_and_jac_dense(
            m64, spec, torch.as_tensor(pts, device=mix.device).double())[1]
    want = {"vorticity": torch.linalg.vector_norm(losses.curl3d(jac), dim=-1),
            "divergence": losses.divergence(jac)}
    out = {}
    for name, ref in want.items():
        vol = vti.read_vti_array(os.path.join(d, f"{name}_{tag}.vti"))
        if vol.shape != tuple(shape) or not np.isfinite(vol).all():
            raise AssertionError(f"{name}_{tag}.vti: {vol.shape}")
        got = torch.as_tensor(vol[idx[:, 0], idx[:, 1], idx[:, 2]])
        err, rel = compare(f"{name}_{tag}.vti", [got], [ref.cpu()],
                           OBSTACLE_VOLUME_TOL)
        out[name] = {"max_abs_err": err, "max_rel_err": rel,
                     "max_abs_reference": float(ref.abs().max())}
    return out


def run_obstacle(d, device):
    """ring_with_obstacle through the 3D entry points with the volumes on
    (the JAX CLI's default): initialize3d and one frame of advance3d at the
    scene's width (40^3 = 64,000 Gaussians, capacity 75,776, B = 8192)
    and its 128^3 grid. Checks the written files against the JAX
    package's set (without its loss_1.png figure), the final field and
    4096 nodes of each frame-1 volume against float64 dense, finite
    losses, no work-list overflow, and launches of rows 1, 5, 6 and 7;
    reports the obstacle's mean |u.n| on 4096 seeded mesh samples before
    (frame 0, the fit) and after the projection (frame 1). Returns the
    path's launches per wrapper and row 1's by shape."""
    from gaussian_fluids_torch import advance3d, initialize3d
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.ops import gsr_cells, gsr_centered
    from gaussian_fluids_torch.scenes import get_scene_3d

    def counts():
        torch.cuda.synchronize()
        return {**gsr_centered.launches, **gsr_cells.launches}

    scene = get_scene_3d("ring_with_obstacle")
    gsr_centered.reset_launches()
    gsr_cells.reset_launches()
    t0 = time.perf_counter()
    mix0, spec = initialize3d.main(
        ["--init_cond", scene.name, "--dir", d, "--max_epoch",
         str(OBSTACLE_INIT_EPOCHS)])
    init_seconds = time.perf_counter() - t0
    mid = counts()
    mix, spec, frames = advance3d.main(
        ["--init_cond", scene.name, "--dir", d, "--dt", ".02",
         "--last_time", ".02", "--max_epoch", str(OBSTACLE_ADVANCE_EPOCHS)])
    after = counts()
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    cells_shapes = _cells_shapes()
    overflows = gsr_cells.overflows()
    check_frames(frames, 1, scene.name)
    files = sorted(os.listdir(d))
    want = sorted(["obstacle.obj", "gaussian_velocity_0.pt",
                   "gaussian_velocity_1.pt"]
                  + [f"{n}_ref.vti" for n in ("velocity", "vorticity",
                                              "divergence", "helicity")]
                  + [f"{n}_{f}.vti" for n in ("vorticity", "divergence")
                     for f in (0, 1)])
    if files != want:
        raise AssertionError(f"ring_with_obstacle wrote {files}")
    fit = checkpoint.load_checkpoint(
        os.path.join(d, "gaussian_velocity_0.pt"), device=device)[0]
    if fit.n_alive() != math.prod(scene.particle_count):
        raise AssertionError(f"fit: {fit.n_alive()} of {fit.capacity}")
    lo, hi = np.float32(scene.domain).reshape(3, 2).T
    pts = np.random.RandomState(13).uniform(lo, hi, (4096, 3)) \
        .astype(np.float32)
    field_check = check_field(mix, spec, pts, f64=True)
    volumes = check_volumes(d, mix, spec, scene.domain,
                            scene.visualize_res, "1")
    gen = torch.Generator(device=device).manual_seed(14)
    mpts, mnrm = scene.mesh_sampler.sample(gen, 4096)
    flux = {"fit": _flux(fit, spec, mpts, mnrm),
            "frame_1": _flux(mix, spec, mpts, mnrm)}
    path = {k: after[k] for k in after}
    rows = ("gsr_fwd", "cells_fwd", "cells_bwd_dn2", "cells_bwd_dn")
    if any(overflows.values()) or any(path[k] == 0 for k in rows):
        raise AssertionError(f"ring_with_obstacle: overflows {overflows}, "
                             f"launches {path}")
    f = frames[0]
    emit({"phase": "obstacle3d", "scene": scene.name,
          "seconds": time.perf_counter() - t0,
          "init_seconds": init_seconds, "init_epochs":
          OBSTACLE_INIT_EPOCHS, "frame": f["frame"],
          "frame_seconds": f["seconds"],
          "clone_seconds": f["clone_seconds"],
          "advect_seconds": f["advect_seconds"],
          "project_seconds": f["project_seconds"],
          "volume_seconds": f["viz_seconds"],
          "save_seconds": f["save_seconds"],
          "frame_epochs": OBSTACLE_ADVANCE_EPOCHS,
          "n_gaussians": f["n_alive"], "capacity": f["capacity"],
          "boundary_batch": 2 * 8192, "grid": list(scene.visualize_res),
          "clone": f["clone"], "project": f["project"],
          "files": files, "final_field": field_check, "volumes": volumes,
          "mesh_flux_mean_max": flux, "cells_overflows": overflows,
          "launches_initialize": mid,
          "launches_advance": {k: after[k] - mid[k] for k in after},
          "gsr_fwd_launches_by_shape": by_shape,
          "cells_fwd_launches_by_shape": cells_shapes})
    return path, by_shape


def _pooled_diff(got, want):
    """Max abs and relative L2 difference and both masses of two pooled
    density volumes, in float64."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    return {"max_abs_diff": float(np.abs(g - w).max()),
            "rel_l2_diff": float(np.linalg.norm(g - w) / np.linalg.norm(w)),
            "mass": float(g.sum()), "mass_jax": float(w.sum()),
            "rel_mass_diff": float(abs(g.sum() - w.sum()) / w.sum())}


def _vti_encoding(path):
    """``appended_raw`` or ``base64``: how the .vti at ``path`` holds its
    data, read from its header."""
    with open(path, "rb") as fd:
        head = fd.read(2048)
    if b'<AppendedData encoding="raw">' in head:
        return "appended_raw"
    return "base64" if b'format="binary"' in head else "unknown"


def replay_vs_jax(device):
    """The committed Ring-Collide run's frame 0 -> 1 replayed on the card
    through ``advance_density3d`` at its default 512^3 grid and the
    committed replay's dt (its checkpoint 0, which the JAX package wrote,
    copied to a temporary directory), and the pooled float16 densities a
    and b of frame 1 against the JAX replay's own
    (``density_small_{a,b}_1.npz``) within REPLAY_TOL; frame 0 (the seeds) reported beside them. Also the
    replay's .vti writes: seconds, bytes, and the encoding read back from
    the files. Returns the banded kernel's launches."""
    from gaussian_fluids_torch import advance_density3d
    from gaussian_fluids_torch.ops import gsr_banded

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "runs_r2_evidence", "ckpts", "output_3d_ring_collide")
    with tempfile.TemporaryDirectory(prefix="gf_replay_") as d:
        shutil.copy(os.path.join(src, "gaussian_velocity_0.pt"), d)
        gsr_banded.reset_launches()
        t0 = time.perf_counter()
        records = advance_density3d.main(
            ["--init_cond", "ring_collide", "--dir", d, "--dt",
             str(REPLAY_DT)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gsr_banded.launches["gsr_value_banded"]
        guard = gsr_banded.guard_failures()
        frames = {}
        for frame in (0, 1):
            for tag in "ab":
                name = f"density_small_{tag}_{frame}.npz"
                got, want = np.load(os.path.join(d, name)), \
                    np.load(os.path.join(src, name))
                for k in ("origin", "spacing", "full_shape"):
                    if not np.array_equal(got[k], want[k]):
                        raise AssertionError(f"{name}: {k} {got[k]} "
                                             f"against {want[k]}")
                frames[f"{tag}{frame}"] = _pooled_diff(got["density"],
                                                       want["density"])
        encodings = {tag: _vti_encoding(
            os.path.join(d, f"density_{tag}_1.vti")) for tag in "ab"}
    rec = records[0]
    emit({"phase": "replay_vs_jax", "seconds": wall, "grid": [512] * 3,
          "checkpoint": "runs_r2_evidence/ckpts/output_3d_ring_collide/"
                        "gaussian_velocity_0.pt",
          "dt": REPLAY_DT, "band": rec["band"],
          "step_seconds": rec["seconds"], "vti_writes": rec["vti_writes"],
          "vti_encodings": encodings,
          "against_jax": frames, "tolerance": REPLAY_TOL,
          "guard_failures": guard, "launches": launches})
    if [r["frame"] for r in records] != [1] or guard or launches == 0 \
            or set(encodings.values()) != {"appended_raw"}:
        raise AssertionError(f"replay frames {records}, guard {guard}, "
                             f"launches {launches}, encodings {encodings}")
    for tag in "ab":
        r = frames[f"{tag}1"]
        if not all(r[k] <= tol for k, tol in REPLAY_TOL.items()):
            raise AssertionError(f"replay density {tag}, frame 1, against "
                                 f"the JAX replay: {r} beyond {REPLAY_TOL}")
    return launches


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


def _stage_chunk(mix, spec, prep, x, band, domain):
    """The replay's chunk as four stage launches of the banded kernel (each
    query tile on its own window; the last launch clamps and samples the
    512^3 ring density into the volume) against the eager chain it
    replaces (the kernel on the host's window through rk4_pos_stages, the
    clamp, trilinear_interp): the largest gap (0 when bitwise), both timed
    (device ms of the enqueued work), and the four launches' bounds, each
    stage's walk counted on its own points."""
    from gaussian_fluids_torch.ops import field, gsr_banded as gb, interp
    from gaussian_fluids_torch.ops.advect import rk4_pos_stages
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.solver.simulate3d import (_banded_rk4_chunk,
                                                         _stage_velocity)

    r = get_scene_3d("ring_collide").info["ring1"]
    dens = interp.seed_ring_density((512,) * 3, domain, r.center, r.normal,
                                    r.radius, r.thickness, device=x.device)
    B, clamp = x.shape[0], spec.clamp_threshold
    out = torch.empty(B, device=x.device)
    stages = []
    real = gb.gsr_value_banded

    def keep(*args, **kwargs):
        stages.append(args[2])
        return real(*args, **kwargs)
    fused = lambda: _banded_rk4_chunk(  # noqa: E731
        prep, x, -DENSITY_DT, band, dens, domain, out, 0)
    gb.gsr_value_banded = keep
    try:
        fused()
    finally:
        gb.gsr_value_banded = real
    got = out.clone()
    lo, hi = (torch.tensor(domain[i::2], dtype=torch.float32,
                           device=x.device) for i in (0, 1))
    f = _stage_velocity(mix, spec, band)
    eager = lambda: interp.trilinear_interp(  # noqa: E731
        dens, torch.minimum(torch.maximum(
            rk4_pos_stages(f, x, -DENSITY_DT), lo), hi), domain)
    want = eager()
    gap = float((got - want).abs().max())
    if gap > TOL * max(float(want.abs().max()), 1e-30):
        raise AssertionError(f"the stage launches' chunk is {gap} off the "
                             f"eager chain")
    torch.cuda.synchronize()
    ms, eager_ms = time_ms(fused, 10), time_ms(eager, 10)
    need = walked = 0.0
    walked_pairs = 0
    for xs in stages:
        jlo, ok = field.band_window(xs, B, prep["nlo"], prep["nhi"], band,
                                    gb.TB)
        cull = _banded_culling(xs, B, prep, jlo, ok, band, gb.TB, gb.TN)
        support = sum(int((mgv > 0).sum()) for _, mgv in gb.window_weights(
            jlo, ok, xs, prep["muT"], prep["ppT"], clamp, band))
        ops = pair_ops(OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT,
                       cull["walked_pairs"], support)
        # the stage's points in and out, x0 and the running sum, the
        # mixture's rows; the last stage's eight gathers and its volume
        nbytes = 4 * (4 * x.numel() + prep["muT"].numel()
                      + prep["ppT"].numel() + prep["v"].numel() + 9 * B)
        need += kernel_bound(ops[0], nbytes)[0]
        walked += kernel_bound(ops[1], nbytes)[0]
        walked_pairs += cull["walked_pairs"]
    return {"launches": len(stages), "ms": ms, "eager_chain_ms": eager_ms,
            "max_abs_gap_vs_eager": gap, "bitwise_equal": gap == 0.0,
            "bound_ms": need, "walked_bound_ms": walked,
            "walked_pairs": walked_pairs, "density": "ring1 at 512^3"}


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
    plain_ms = plain_once(plain)
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
              "window_bound_ms": kernel_bound(pair_ops(
                  OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT, window_pairs,
                  support_pairs)[1], nbytes)[0],
              "support_pairs": support_pairs, "plane_x": float(xs[plane]),
              **cull, "full_sweep_ms": sweep_ms,
              "full_sweep_tiles_tested_per_query_tile":
                  cull_sweep["tiles_tested_per_query_tile"],
              "full_sweep_tiles_walked_per_query_tile_mean":
                  cull_sweep["tiles_walked_per_query_tile_mean"],
              "full_sweep_bitwise_equal": True,
              "x_sorted": _x_sorted_chunk(mix, spec, x, plain),
              "rk4_stage_chunk": _stage_chunk(mix, spec, prep, x, band,
                                              tuple(domain))}
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
    from gaussian_fluids_torch.utils import profiling

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
    n0 = gsr_banded.launches["gsr_value_banded"]
    t0 = time.perf_counter()
    out = advected_density(dens, mix, spec, domain, DENSITY_DT, (512,) * 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gsr_banded.launches["gsr_value_banded"] - n0

    def swept(m):
        """Query tiles of one step that swept the whole axis: each stage
        launch takes its tiles' own windows, so no launch fails a guard."""
        with profiling.counting() as rec:
            again = advected_density(dens, m, spec, domain, DENSITY_DT,
                                     (512,) * 3)
        return rec.sums("banded_swept_tiles")[0], again
    guard, again = swept(mix)
    if not torch.equal(again, out):
        raise AssertionError("512^3 density: a second step differs")
    del again
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
        t0 = time.perf_counter()
        other = advected_density(dens, m, spec, domain, DENSITY_DT,
                                 (512,) * 3)
        torch.cuda.synchronize()
        ab[name + "_seconds"].append(time.perf_counter() - t0)
        ab[name + "_max_abs_diff"] = float((other - out).abs().max())
        del other
    ab["x_sorted_swept_tiles"] = swept(xmix)[0]
    host = out.cpu().numpy()
    after = _volume_stats(host)
    if not after["finite"] or after["max"] > 1 + 1e-5 or after["mass"] <= 0 \
            or guard:
        raise AssertionError(f"512^3 density: {after}, swept tiles "
                             f"{guard}")
    # the replay writes each 512^3 density as .vti on a background thread,
    # transposed on the card and copied first; time one such copy and
    # write (and the file's size) to set beside the step's seconds
    lo, hi = np.asarray(domain[0::2]), np.asarray(domain[1::2])
    with tempfile.TemporaryDirectory(dir=d) as tmp:
        path = os.path.join(tmp, "density_512.vti")
        t0 = time.perf_counter()
        x_fastest = vti.x_fastest(out).cpu().numpy()
        t1 = time.perf_counter()
        vti.write_vti_x_fastest(x_fastest, lo, (hi - lo) / 512, path)
        write_seconds = time.perf_counter() - t1
        copy_seconds = t1 - t0
        write_bytes = os.path.getsize(path)
        encoding = _vti_encoding(path)
        del x_fastest
    if encoding != "appended_raw":
        raise AssertionError(f"512^3 .vti written as {encoding}")
    small = interp.seed_ring_density((128,) * 3, domain, r.center, r.normal,
                                     r.radius, r.thickness, device=device)
    prof = profile_epoch(lambda: advected_density(
        small, mix, spec, domain, DENSITY_DT, (128,) * 3), 1)
    emit({"phase": "density512", "seconds": seconds, "setup_seconds": setup,
          "banded_ms_per_step": banded_ms, "order_ab": ab,
          "vti_write_seconds": write_seconds,
          "vti_copy_seconds": copy_seconds, "vti_bytes": write_bytes,
          "vti_encoding": encoding,
          "grid": [512] * 3, "chunks": -(-512 ** 3 // DENSITY_CHUNK),
          "band": _suggest_band(mix, spec, DENSITY_DT),
          "launches": launches, "swept_tiles": guard,
          "before": before, "after": after,
          "profile_128": {k: prof[k] for k in (
              "wall_ms_per_epoch", "ms_per_epoch", "device_ms_per_epoch",
              "device_busy_share",
              "host_ops_per_epoch", "device_launches_per_epoch",
              "top_kernels_ms_per_epoch")}})
    return launches


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` inside the block, restored after."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name)
        else:
            os.environ[name] = before


def run_vortices_pass(d, device):
    """vortices_pass (71 x 71 = 5041 Gaussians, capacity 6144, B = 512, the
    flux batch 3 x 512 on the two obstacle circles and the walls) through
    initialize2d (VP_INIT_EPOCHS) and one advance2d frame at dt VP_DT
    (VP_ADVANCE_EPOCHS a phase), its targets hoisted: the final field
    against float64 dense, the obstacles' mean |u.n| on 4096 circle
    points after the fit and after the frame, launches of rows 1-3 and
    row 1's by shape (the hoisted sweep at B = 51,200 among them).
    Returns (final mixture, spec, the frame's launches, row 1's by
    shape)."""
    from gaussian_fluids_torch import advance2d, initialize2d
    from gaussian_fluids_torch.ops import gsr_centered
    from gaussian_fluids_torch.scenes import boundaries2d, get_scene_2d
    from gaussian_fluids_torch.utils.grids import grid_points_2d

    scene = get_scene_2d("vortices_pass")
    sf = scene.scaling_factor
    gsr_centered.reset_launches()
    t0 = time.perf_counter()
    fit, spec = initialize2d.main(
        ["--init_cond", scene.name, "--dir", d, "--max_epoch",
         str(VP_INIT_EPOCHS)])
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    init = dict(gsr_centered.launches)
    gsr_centered.reset_launches()
    mix, spec, frames = advance2d.main(
        ["--init_cond", scene.name, "--dir", d, "--dt", str(VP_DT),
         "--last_time", str(VP_DT), "--max_epoch", str(VP_ADVANCE_EPOCHS)])
    torch.cuda.synchronize()
    launches = dict(gsr_centered.launches)
    by_shape = _shape_counts(gsr_centered.fwd_shapes)
    check_frames(frames, 1, scene.name)
    if sorted(os.listdir(d)) != ["gaussian_velocity_0.pt",
                                 "gaussian_velocity_1.pt"]:
        raise AssertionError(f"{scene.name}: checkpoints {os.listdir(d)}")
    if fit.n_alive() != 5041 or fit.capacity != 6144:
        raise AssertionError(f"{scene.name} width {fit.n_alive()}/"
                             f"{fit.capacity}")
    hoisted = f"d=2,B={100 * 512},N={mix.capacity}"
    if by_shape.get(hoisted, 0) == 0 or any(
            launches[k] == 0 for k in ("gsr_fwd", "gsr_bwd_dn",
                                       "gsr_bwd_dn2")):
        raise AssertionError(f"{scene.name}: launches {launches}, "
                             f"{by_shape}")
    gen = torch.Generator(device=device).manual_seed(15)
    u = torch.rand((2, 2048), generator=gen, device=device)
    pts, nrm = boundaries2d.obstacle_circles(u[0], u[1], scene.info)
    flux = {"fit": _flux(fit, spec, pts * sf, nrm),
            "frame_1": _flux(mix, spec, pts * sf, nrm)}
    f = frames[0]
    emit({"phase": "vortices_pass_2d", "scene": scene.name,
          "seconds": time.perf_counter() - t0, "init_seconds": init_seconds,
          "init_epochs": VP_INIT_EPOCHS, "dt": VP_DT, "frame": f["frame"],
          "frame_seconds": f["seconds"],
          "clone_seconds": f["clone_seconds"],
          "advect_seconds": f["advect_seconds"],
          "project_seconds": f["project_seconds"],
          "epochs_per_phase": VP_ADVANCE_EPOCHS,
          "n_gaussians": f["n_alive"], "capacity": f["capacity"],
          "batch": 512, "boundary_batch": 3 * 512,
          "clone": f["clone"], "project": f["project"],
          "obstacle_flux_mean_max": flux,
          "obstacle_flux_lower_after_frame":
              flux["frame_1"][0] < flux["fit"][0],
          "launches_initialize": init, "launches_advance": launches,
          "gsr_fwd_launches_by_shape": by_shape,
          "final_field": check_field(
              mix, spec, grid_points_2d(0, 10, 0, 10, 64, 64), f64=True)})
    return mix, spec, launches, by_shape


def _sorted_draws(gen, n, b, lo, hi):
    """n batches of b uniform points in [lo, hi], each sorted along x as
    the hoist sorts them: (n, b, d)."""
    from gaussian_fluids_torch.solver.fit import uniform_batch
    from gaussian_fluids_torch.solver.loop import sorted_batches
    return sorted_batches(torch.stack([uniform_batch(gen, b, lo, hi)
                                       for _ in range(n)]))


def hoist_targets(device, vp_mix, vp_spec):
    """The exact covector targets of a chunk's batches, hoisted (sweeps of
    sweep_group(n, B) batches) against per epoch (each batch alone), on
    the same draws: Ring-Collide (25 x 8192 on the seeded states, the cells
    path), vortices_pass (100 x 512 on its fitted field, row 1) and Karman
    under GF_FUSED_RK4=1 (100 x 512 on the seeded state, row 9). Whether
    they are bitwise equal, the largest difference over the largest
    entry, within HOIST_TOL."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import covector
    from gaussian_fluids_torch.solver.loop import swept
    from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                          ring_collide_state)
    out = {}
    rc, rc_spec, _ = ring_collide_state(device, seed=1)
    gen = torch.Generator(device=device).manual_seed(16)
    cube = (torch.zeros(3, device=device), torch.ones(3, device=device))
    km, kspec, _ = karman_state(device)
    kscene = get_scene_2d("karman")
    ksf = kscene.scaling_factor
    kadv = kscene.advance_domain
    kbox = (torch.tensor([kadv[0] * ksf, kadv[2] * ksf], device=device),
            torch.tensor([kadv[1] * ksf, kadv[3] * ksf], device=device))
    vp_box = (torch.zeros(2, device=device),
              torch.full((2,), 10.0, device=device))
    cases = [
        ("ring_collide", 25, 8192, cube, lambda c: covector.
         advected_vorticity_3d(rc, rc_spec, c, 0.02, presorted=True), None),
        ("vortices_pass", 100, 512, vp_box, lambda c: covector.
         advected_vorticity_2d(vp_mix, vp_spec, c, VP_DT, *vp_box,
                               presorted=True), None),
        ("karman_fused", 100, 512, kbox, lambda c: covector.
         advected_vorticity_2d(km, kspec, c, KARMAN_DT, *kbox,
                               presorted=True), "1")]
    for name, n, b, box, fn, fused in cases:
        with env_set("GF_FUSED_RK4", fused or "0"):
            data = _sorted_draws(gen, n, b, *box)
            t0 = time.perf_counter()
            hoisted = _flat(swept(fn, data))
            torch.cuda.synchronize()
            t_h = time.perf_counter() - t0
            t0 = time.perf_counter()
            per = [_flat(fn(data[i])) for i in range(n)]
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        per = [torch.stack([p[j] for p in per]) for j in range(len(hoisted))]
        bitwise = all(torch.equal(h, p) for h, p in zip(hoisted, per))
        err, rel = compare(f"hoisted targets {name}", hoisted, per,
                           HOIST_TOL)
        out[name] = {"batches": n, "batch": b, "sweep_rows": n * b,
                     "bitwise_equal": bitwise, "max_abs_diff": err,
                     "max_rel_diff": rel, "tolerance": HOIST_TOL,
                     "hoisted_seconds": t_h, "per_epoch_seconds": t_p}
    return out


def kernels_hoisted(device, vp_mix, vp_spec):
    """Rows 1, 5 and 9 at the shapes the hoist and the target grid give
    them, each against its plain twin (TOL) — on the whole batch where
    the twin's dense (B, N) planes fit, else on two batch-sized row
    slices (rows are independent) — timed, with the bound on need and
    the walked bound: row 1 at d = 2, B = 51,200 (vortices_pass's fitted
    field, 100 sorted batches of 512) and B = 1536 (its flux batch,
    value only); row 5 at Ring-Collide B = 204,800 (25 sorted batches of
    8192; twin on slices), at Leapfrog-3D B = 204,800, N = 1024 (also
    on the lists of ``GF_CELLS_CAP=0.3``, which overflow there: the
    kernel sweeps the whole mask; its ms and the lists' preparation
    seconds beside the default whole-grid list's), and at B = 32,768 (a
    chunk of the 128^3 target grid); row 9 at Karman B = 51,200 (twin on
    slices). Returns {shape tag: entry}."""
    from gaussian_fluids_torch.ops import field, gsr_cells as gk
    from gaussian_fluids_torch.ops import gsr_centered as gc
    from gaussian_fluids_torch.ops import rk4_fused as rk
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.utils.grids import grid_nodes
    from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                          ring_collide_state)
    gen = torch.Generator(device=device).manual_seed(17)
    out = {}

    def centered_args(mix, spec, x):
        x_p, _, _, mp, pp, vp, tm, rad = field._centered_prep(
            mix, spec, x, gc.TB, gc.TN, presorted=True)
        return (tm, x_p, mp.T.contiguous(), pp.T.contiguous(),
                vp.contiguous()), rad

    # row 1, d = 2: the vortices_pass projection's hoisted sweep and its
    # flux batch
    box = (torch.zeros(2, device=device),
           torch.full((2,), 10.0, device=device))
    x = _sorted_draws(gen, 100, 512, *box).reshape(-1, 2)
    args, rad = centered_args(vp_mix, vp_spec, x)
    out["gsr_fwd_B51200"] = fwd_shape_entry(args, rad,
                                            vp_spec.clamp_threshold)
    scene = get_scene_2d("vortices_pass")
    bd = scene.boundary_sampler_2(gen, 512, torch.tensor(
        scene.advance_domain, device=device))[0]
    bd = bd[torch.argsort(bd[:, 0], stable=True)]
    args, rad = centered_args(vp_mix, vp_spec, bd)
    out["gsr_fwd_B1536"] = fwd_shape_entry(args, rad,
                                           vp_spec.clamp_threshold)

    def prep_seconds(mix, spec, x):
        """Median wall seconds of the lists' preparation, of 5."""
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            field._cells_prep(mix, spec, x)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[2]

    def cells_entry(mix, spec, x, slices, budget=None):
        clamp = spec.clamp_threshold
        x_p, _, tmask, (rows, cols, gt, qt, ok), rad = field._cells_prep(
            mix, spec, x)
        mu_p, pp_p, v_p = field._padded_param_rows(mix, spec, gk.TN)
        muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                       v_p.contiguous())
        B, N = x_p.shape[0], muT.shape[1]

        def kern(nj):
            return gk.cells_fwd(rows, cols, ok, tmask, x_p, muT, ppT, v,
                                clamp, nj, rad)

        def twin(sl, nj):
            xs = x[sl]
            xs_p, _, tms, (r_, c_, _, _, ok_), _ = field._cells_prep(
                mix, spec, xs)
            return gk.cells_fwd_plain(r_, c_, ok_, tms, xs_p, muT, ppT, v,
                                      clamp, nj)[:xs.shape[0]]
        errs = [compare(f"cells_fwd[B={B},N={N},{sl.start}:{sl.stop},{nj}]",
                        [kern(nj)[sl]], [twin(sl, nj)], TOL)
                for sl in slices for nj in (3, 0)]
        torch.cuda.synchronize()
        ms = time_ms(lambda: kern(3))
        plain_ms = None
        live = int(tmask.sum())
        sup = _support_pairs(gc, tmask, x_p, muT, ppT, 3, clamp)
        nbytes = 4 * (x_p.numel() + muT.numel() + ppT.numel() + v.numel()
                      + B * 12) + 2 * 4 * live
        e = _entry("cells_fwd", "cells", errs, ms, plain_ms,
                   pair_ops(OPS_GEOMETRY[3], OPS_SUPPORT[(3, "fwd")],
                            live * gk.TB * gk.TN, sup),
                   nbytes, live * gk.TB * gk.TN, sup)
        extra = {}
        if budget is not None:
            with env_set("GF_CELLS_CAP", budget):
                _, _, _, (r_b, c_b, _, _, ok_b), _ = field._cells_prep(
                    mix, spec, x)
                prep_b = prep_seconds(mix, spec, x)

            def kern_b():
                return gk.cells_fwd(r_b, c_b, ok_b, tmask, x_p, muT, ppT, v,
                                    clamp, 3, rad)
            err_b = compare(f"cells_fwd[B={B},N={N}] GF_CELLS_CAP={budget}",
                            [kern_b()], [kern(3)], TOL)
            torch.cuda.synchronize()
            extra = {"prep_seconds": prep_seconds(mix, spec, x),
                     f"cap_{budget}": {
                         "list_capacity": r_b.numel(), "list_ok": int(ok_b),
                         "ms": time_ms(kern_b), "prep_seconds": prep_b,
                         "max_abs_err_vs_whole_list": err_b[0]}}
        return {**extra, "B": B, "N": N, "twin_rows": [[s.start, s.stop]
                                              for s in slices],
                "list_ok": int(ok), "list_capacity": rows.numel(),
                "live_tiles": live, "tiles": list(tmask.shape),
                "live_tile_fraction": live / tmask.numel(),
                **{k: e[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "walked_bound_ms", "support_pairs",
                                     "walked_pairs")}}

    cube = (torch.zeros(3, device=device), torch.ones(3, device=device))
    rc, rc_spec, _ = ring_collide_state(device, seed=1)
    x = _sorted_draws(gen, 25, 8192, *cube).reshape(-1, 3)
    out["cells_fwd_B204800"] = cells_entry(
        rc, rc_spec, x, [slice(0, 8192), slice(12 * 8192, 13 * 8192)])
    lf, lf_spec, _ = ring_collide_state(device, seed=2, side=10)
    x = _sorted_draws(gen, 25, 8192, *cube).reshape(-1, 3)
    out["cells_fwd_B204800_N1024"] = cells_entry(
        lf, lf_spec, x, [slice(0, 8192), slice(12 * 8192, 13 * 8192)],
        "0.3")
    nodes = grid_nodes((0, 1, 0, 1, 0, 1), (GRID_RES,) * 3, device)
    x = nodes[32 * 32768:33 * 32768]           # the grid's middle chunk
    out["cells_fwd_B32768"] = cells_entry(rc, rc_spec, x,
                                          [slice(0, 32768)])

    # row 9: Karman's hoisted sweep under GF_FUSED_RK4=1
    km, kspec, _ = karman_state(device)
    scene = get_scene_2d("karman")
    sf, adv = scene.scaling_factor, scene.advance_domain
    x = _sorted_draws(gen, 100, 512,
                      torch.tensor([adv[0] * sf, adv[2] * sf],
                                   device=device),
                      torch.tensor([adv[1] * sf, adv[3] * sf],
                                   device=device)).reshape(-1, 2)
    clamp = kspec.clamp_threshold
    mu_p, pp_p, v_p = field._padded_param_rows(km, kspec, gc.TN)
    muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                   v_p.contiguous())
    rad = field.row_radius(km, kspec, gc.TN)
    lo, hi = rk.tile_boxes(muT, rad)
    dt = -KARMAN_DT
    slices = [slice(0, 512), slice(50 * 512, 51 * 512)]
    errs = [compare(f"rk4_fused[B=51200,{s.start}:{s.stop},{nj}]",
                    [o[s] for o in rk.fused_rk4(x, muT, ppT, v, dt, clamp,
                                                nj, rad, lo, hi)],
                    list(rk.rk4_plain(x[s], muT, ppT, v, dt, clamp, nj)),
                    TOL) for s in slices for nj in (2, 0)]
    torch.cuda.synchronize()
    ms = time_ms(lambda: rk.fused_rk4(x, muT, ppT, v, dt, clamp, 2, rad, lo,
                                      hi))
    plain_ms = None
    pts = _rk4_stage_points(x, muT, ppT, v, dt, clamp)
    ones = torch.ones((x.shape[0], 1), dtype=torch.int32, device=device)
    sup = [_support_pairs(gc, ones, p_, muT, ppT, 2, clamp) for p_ in pts]
    walked = [int(_rk4_stage_tiles(p_, lo, hi).sum()) * rk.TB * rk.TN
              for p_ in pts]
    ops = [pair_ops(OPS_GEOMETRY[2], OPS_SUPPORT[(2, "rk4_stage")], w_, n)
           for w_, n in zip(walked[:4], sup[:4])] \
        + [pair_ops(OPS_GEOMETRY[2], OPS_SUPPORT[(2, "fwd")], walked[4],
                    sup[4])]
    e = _entry("rk4_fused", "rk4", errs, ms, plain_ms,
               tuple(sum(o[i] for o in ops) for i in range(2)),
               4 * x.numel() + 4 * (muT.numel() + ppT.numel() + v.numel())
               + 4 * x.shape[0] * (2 + 6), sum(walked), sum(sup))
    out["rk4_fused_B51200"] = {
        "B": x.shape[0], "N": muT.shape[1],
        "twin_rows": [[s.start, s.stop] for s in slices],
        "split": gc.fwd_split(x.shape[0] // rk.TB, muT.shape[1] // rk.TN,
                              gc._sm_count(0)),
        "walked_pairs_per_stage": walked, "support_pairs_per_stage": sup,
        **{k: e[k] for k in ("max_abs_err", "max_rel_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "walked_bound_ms")}}
    return out


def hoist_ab(device):
    """The Ring-Collide projection epoch (seeded state, B = 8192) hoisted
    and under GF_HOIST_TARGETS=0: wall ms per epoch over a chunk of
    HOIST_CHUNK epochs, alternated p c c p in this call, each mode's first
    run after a warm-up chunk. Returns the four wall runs. (Its profiles,
    device ms and host operators a mode, are ``epoch_profile``'s, PERF.md
    §5; the smoke no longer pays the profiler for them.)"""
    from gaussian_fluids_torch.epoch_profile import _epochs_3d

    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
    mix, spec, _ = ring_collide_state(device)
    walls = []
    for i, mode in enumerate(("per_epoch", "hoisted", "hoisted",
                              "per_epoch")):
        with env_set("GF_HOIST_TARGETS",
                     "1" if mode == "hoisted" else "0"):
            step, _ = _epochs_3d(mix, spec, device,
                                 chunk=HOIST_CHUNK)["project"]
        if i < 2:   # a mode's first run warms its caches for both
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append({"mode": mode, "epochs": HOIST_CHUNK,
                      "wall_ms_per_epoch":
                          1e3 * (time.perf_counter() - t0) / HOIST_CHUNK})
    return walls


def target_grid_rc(device, rmix, rspec):
    """A Ring-Collide projection chunk under --target_grid GRID_RES on the
    fitted Ring-Collide field (the 3D path's frame 1, old and new): the
    grid's build seconds and launches (row 5 at B = 32,768); the grid at
    8192 seeded nodes, where interpolation returns the node's value,
    against the exact targets computed there (TOL of the largest entry:
    the build on the card); the interpolated targets against the exact
    ones at 8192 seeded points off the nodes, reported (the largest, the
    99th percentile and the mean difference over the largest entry, and
    whether the largest is within GRID_TOL); the same off-node reading on
    the committed Ring-Collide fit (the JAX package's TPU run, frame 0:
    the field its --target_grid 128 run starts from), over the whole box
    and over the box of the grid's nodes 48..63 on each axis at the
    points where tests/test_torch_target_grid.py holds the port's reading
    to the JAX package's on the CPU (a 16^3 grid there); and HOIST_CHUNK
    epochs on the interpolated targets (wall ms per epoch; finite
    parameters). Returns row 5's launches by shape in the grid's
    build."""
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.ops import gsr_cells, gsr_centered, interp
    from gaussian_fluids_torch.solver import covector, optim, project
    from gaussian_fluids_torch.utils.grids import grid_nodes

    dt, dom = 0.02, (0, 1, 0, 1, 0, 1)

    def grid_runner(spec):
        return project._runner_3d(
            spec, "ring_collide", project.ProjectWeights(delta_pos=0.0),
            10.0, 8192, (0.0,) * 3, (1.0,) * 3, (GRID_RES,) * 3)
    runner = grid_runner(rspec)
    gsr_cells.reset_launches()
    gsr_centered.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tgt = runner.target_grid_fn(rmix, dt)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    launches = {**gsr_cells.launches, **gsr_centered.launches}
    shapes = _cells_shapes()
    rng = np.random.RandomState(18)

    def exact_and_grid(x, mix=rmix, spec=rspec, grid=tgt):
        x = x[torch.argsort(x[:, 0])]
        ev, eh = covector.advected_vorticity_3d(mix, spec, x, dt,
                                                presorted=True)
        return torch.cat([ev, eh[:, None]], -1), \
            interp.multi_channel_interp(grid, x, dom)

    def off_nodes(lo, hi, *field, draws=rng):
        want, got = exact_and_grid(torch.as_tensor(
            draws.uniform(lo, hi, (8192, 3)).astype(np.float32),
            device=device), *field)
        off = {}
        for k, sl in (("vorticity", slice(0, 3)), ("helicity", slice(3, 4))):
            diff = (got[:, sl] - want[:, sl]).abs().amax(-1).double()
            scale = float(want[:, sl].abs().max())
            off[k] = {"max_rel": float(diff.max()) / scale,
                      "p99_rel": float(torch.quantile(diff, 0.99)) / scale,
                      "mean_rel": float(diff.mean()) / scale,
                      "max_within_grid_tol": float(diff.max()) <= GRID_TOL
                      * scale}
        return off

    nodes = grid_nodes(dom, (GRID_RES,) * 3, device)
    want, got = exact_and_grid(nodes[torch.as_tensor(
        rng.randint(0, GRID_RES ** 3, 8192), device=device)])
    at_nodes = {k: compare(f"target grid at its nodes, {k}", [got[:, sl]],
                           [want[:, sl]], TOL)
                for k, sl in (("vorticity", slice(0, 3)),
                              ("helicity", slice(3, 4)))}
    off = off_nodes(0.0, 1.0)
    cmix, cspec = checkpoint.load_checkpoint(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "runs_r2_evidence",
        "ckpts", "output_3d_ring_collide", "gaussian_velocity_0.pt"),
        device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cgrid = grid_runner(cspec).target_grid_fn(cmix, dt)
    torch.cuda.synchronize()
    committed = {
        "checkpoint": "runs_r2_evidence/ckpts/output_3d_ring_collide/"
                      "gaussian_velocity_0.pt",
        "build_seconds": time.perf_counter() - t0,
        "off_nodes": off_nodes(0.0, 1.0, cmix, cspec, cgrid),
        # the CPU test's points: its seed, its box
        "off_nodes_box_nodes_48_63": off_nodes(
            48 / 127, 63 / 127, cmix, cspec, cgrid,
            draws=np.random.RandomState(18))}
    del cgrid, cmix
    p = rmix.params()
    carry = (p, optim.init(p, project.DEFAULT_LRS_3D), rmix.alive, rmix, dt)
    gen = torch.Generator(device=device).manual_seed(19)
    carry = runner.run_chunk(carry, gen, 2, False, tgt)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = runner.run_chunk(carry, gen, HOIST_CHUNK, False, tgt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(torch.isfinite(v).all() for v in carry[0].values()):
        raise AssertionError("target_grid_rc: non-finite parameters")
    emit({"phase": "target_grid_rc", "grid": [GRID_RES] * 3,
          "grid_nodes": GRID_RES ** 3, "build_seconds": build,
          "build_launches": launches, "build_cells_fwd_by_shape": shapes,
          "at_nodes": {k: {"max_abs_err": e, "max_rel_err": r}
                       for k, (e, r) in at_nodes.items()},
          "at_nodes_tolerance": TOL, "off_nodes": off,
          "committed_fit": committed,
          "grid_tol": GRID_TOL, "epochs": HOIST_CHUNK,
          "wall_ms_per_epoch": 1e3 * wall / HOIST_CHUNK})
    return shapes


MESH_SHAPES = ((1, 2), (2, 1))  # two ranks sharing the card over gloo,
#   both layouts in one launch: at 1x2 Ring-Collide's ranks hold 37,888
#   Gaussians each and take the cells path; at 2x1 the batch splits (the
#   batch group's mean, each batch row's draws) and so do the density
#   step's node chunks


def mesh_start(pool, tmp, ring_dir, device, card):
    """Start from ``pool`` what the mesh phases run in other processes,
    to run beside single-process phases: the ranks of mesh_epoch and
    mesh_density (``mesh_check.launch_ranks``, every layout of MESH_SHAPES
    in one launch, the density step on the smoke's Ring-Collide frame 1),
    and the entry points at --mesh 1x1 over NCCL (``cli_frame_run``, and
    ``cli_replay`` whole: its check reads files). This process launches
    no kernel for them meanwhile. Returns their futures."""
    from gaussian_fluids_torch import mesh_check

    return (pool.submit(mesh_check.launch_ranks, MESH_SHAPES, device,
                        os.path.join(ring_dir, "gaussian_velocity_1.pt"),
                        True),
            pool.submit(mesh_check.cli_frame_run,
                        os.path.join(tmp, "2d", "gaussian_velocity_0.pt"),
                        os.path.join(tmp, "mesh_cli_2d_1x1"), "1x1",
                        ADVANCE_EPOCHS),
            pool.submit(mesh_check.cli_replay,
                        os.path.join(ring_dir, "gaussian_velocity_0.pt"),
                        ring_dir, os.path.join(tmp, "mesh_cli_rc_1x1"),
                        "1x1", card))


def mesh_phases(tmp, ring_dir, device, card, started):
    """The checks of what :func:`mesh_start` started (``started``, its
    futures): mesh_epoch and mesh_density (``mesh_check.check_epochs``,
    the single-device references made now), the 1x1 frame of mesh_cli
    (``cli_frame``); then mesh_cli at 2x1 where two GPUs are visible.
    Returns the ranks' launches by kernel, summed per path."""
    from gaussian_fluids_torch import mesh_check

    ranks, frame, replay = started
    totals = mesh_check.check_epochs(
        MESH_SHAPES, device, card,
        ckpt=os.path.join(ring_dir, "gaussian_velocity_1.pt"), shared=True,
        ranks=ranks.result())
    mesh_check.cli_frame(
        os.path.join(tmp, "2d", "gaussian_velocity_0.pt"),
        os.path.join(tmp, "2d", "gaussian_velocity_1.pt"),
        os.path.join(tmp, "mesh_cli_2d_1x1"), "1x1", card, ADVANCE_EPOCHS,
        ran=frame.result())
    replay.result()
    meshes = ["2x1"] if torch.cuda.device_count() >= 2 else []
    for mesh in meshes:
        with ThreadPoolExecutor(1) as pool:
            replay = pool.submit(
                mesh_check.cli_replay,
                os.path.join(ring_dir, "gaussian_velocity_0.pt"), ring_dir,
                os.path.join(tmp, f"mesh_cli_rc_{mesh}"), mesh, card)
            mesh_check.cli_frame(
                os.path.join(tmp, "2d", "gaussian_velocity_0.pt"),
                os.path.join(tmp, "2d", "gaussian_velocity_1.pt"),
                os.path.join(tmp, f"mesh_cli_2d_{mesh}"), mesh, card,
                ADVANCE_EPOCHS)
            replay.result()
    if not meshes:
        emit({"phase": "mesh_cli", "mesh": "2x1",
              "skipped": f"{torch.cuda.device_count()} visible GPU"})
    return totals


class _Tee:
    """stdout that also keeps its lines: the runs' own report lines (the
    matplotlib line) are read back from them."""

    def __init__(self, out):
        self.out, self.lines, self.part = out, [], ""

    def write(self, text):
        self.out.write(text)
        self.part += text
        *done, self.part = self.part.split("\n")
        self.lines += done
        return len(text)

    def flush(self):
        self.out.flush()


def figures_2d(tmp, device, lines):
    """The 2D figures' field sweeps (``simulate2d.figure_arrays``) on the
    Leapfrog-2D frame 1: the velocity on the 30 x 30 grids of the
    initialize and visualize domains, vorticity and divergence on the
    200 x 200 grid, each against a float64 plain dense evaluation of the
    same points within FIGURE_TOL of the largest entry; row 1's launches
    by shape; and the 2D run's matplotlib line with its PNGs: without
    matplotlib one line and no PNG, with it no line and the PNGs."""
    from gaussian_fluids_torch.io import checkpoint, viz2d
    from gaussian_fluids_torch.models.mixture import mixture_of
    from gaussian_fluids_torch.ops import field, gsr_centered
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import simulate2d
    from gaussian_fluids_torch.utils import analysis
    from gaussian_fluids_torch.utils.grids import grid_points_2d

    t0 = time.perf_counter()
    d2 = os.path.join(tmp, "2d")
    said = [ln for ln in lines if "matplotlib is not installed" in ln]
    pngs = sorted(f for f in os.listdir(d2) if f.endswith(".png"))
    have = viz2d.available()
    if (have and (said or len(pngs) != 11)) or (not have and (
            len(said) != 2 or pngs)):
        raise AssertionError(f"figures_2d: matplotlib {have}, lines "
                             f"{said}, PNGs {pngs}")
    mix, spec = checkpoint.load_checkpoint(
        os.path.join(d2, "gaussian_velocity_1.pt"), device=device)
    scene = get_scene_2d("leapfrog")
    gsr_centered.reset_launches()
    arr = simulate2d.figure_arrays(mix, spec, scene)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    shapes = _shape_counts(gsr_centered.fwd_shapes)
    launches = gsr_centered.launches["gsr_fwd"]
    sf = scene.scaling_factor
    x0i, x1i, y0i, y1i = scene.initialize_domain
    x0v, x1v, y0v, y1v = scene.visualize_domain
    xnv, ynv = scene.visualize_res
    m64 = mixture_of({k: p.double() for k, p in mix.params().items()},
                     mix.alive)

    def dense64(pts):
        x = torch.as_tensor(pts, dtype=torch.float64, device=device)
        vs, js = [], []
        with torch.no_grad():
            for c in range(0, x.shape[0], 4096):
                v, j = field.value_and_jac_dense(m64, spec, x[c:c + 4096])
                vs.append(v)
                js.append(j)
        return torch.cat(vs).cpu().numpy(), torch.cat(js).cpu().numpy()

    jac = dense64(grid_points_2d(x0v, x1v, y0v, y1v, xnv, ynv) * sf)[1]
    want = {"vel_i": dense64(grid_points_2d(x0i * sf, x1i * sf, y0i * sf,
                                            y1i * sf, 30, 30))[0],
            "vel_v": dense64(grid_points_2d(x0v, x1v, y0v, y1v, 30,
                                            30) * sf)[0] / sf,
            "vor": analysis.curl2d_np(jac), "div": analysis.divergence_np(jac)}
    errs = {k: compare(f"figures_2d {k}", [torch.as_tensor(arr[k])],
                       [torch.as_tensor(w)], FIGURE_TOL)
            for k, w in want.items()}
    emit({"phase": "figures_2d", "seconds": time.perf_counter() - t0,
          "sweep_seconds": sweep_s, "n_gaussians": mix.n_alive(),
          "capacity": mix.capacity,
          "arrays": {k: list(np.shape(arr[k])) for k in want},
          "max_abs_err": {k: e for k, (e, _) in errs.items()},
          "max_rel_err": {k: r for k, (_, r) in errs.items()},
          "tolerance": FIGURE_TOL, "gsr_fwd_launches": launches,
          "gsr_fwd_launches_by_shape": shapes,
          "matplotlib": have, "matplotlib_lines": said, "pngs": pngs})


def profile_phase(tmp):
    """``advance2d --profile DIR`` for one short Leapfrog-2D frame from
    the smoke's fit (PROFILE_EPOCHS a phase, the capture's window
    PROFILE_SECONDS): the trace exists, parses as JSON and names the
    forward kernel."""
    from gaussian_fluids_torch import advance2d

    t0 = time.perf_counter()
    d = os.path.join(tmp, "profile")
    os.makedirs(d)
    shutil.copy(os.path.join(tmp, "2d", "gaussian_velocity_0.pt"), d)
    trace_dir = os.path.join(tmp, "trace")
    with env_set("GF_PROFILE_SECONDS", str(PROFILE_SECONDS)):
        advance2d.main(["--init_cond", "leapfrog", "--dir", d, "--dt",
                        ".025", "--last_time", ".025", "--max_epoch",
                        str(PROFILE_EPOCHS), "--no_viz", "--profile",
                        trace_dir])
    run_s = time.perf_counter() - t0
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    # the port's kernels by name (templated: "void gsr_fwd_kernel<2, 2>...")
    kernels = {}
    for n in names:
        if re.search(r"(gsr|cells|rk4)_\w*kernel", n):
            kernels[n] = kernels.get(n, 0) + 1
    if not any("gsr_fwd_kernel" in n for n in kernels):
        raise AssertionError(f"profile: no gsr_fwd_kernel in the trace "
                             f"({len(events)} events)")
    emit({"phase": "profile", "seconds": time.perf_counter() - t0,
          "run_seconds": run_s, "epochs": PROFILE_EPOCHS,
          "window_seconds": PROFILE_SECONDS,
          "trace_bytes": os.path.getsize(path), "events": len(events),
          "kernel_events": kernels})


def _heads(d):
    """The projection's two heads on (val, jac): vorticity (and the
    value) and divergence, squared means."""
    from gaussian_fluids_torch.solver import losses

    def curl(j):
        return losses.curl2d(j) if d == 2 else losses.curl3d(j)

    return (lambda v, j: (curl(j) ** 2).mean() + (v ** 2).mean(),
            lambda v, j: (losses.divergence(j) ** 2).mean())


def _sparse_cells(mix, spec):
    """The most cells along the longest axis, at most the oracle's default
    16 (``GF_SPARSE_CELLS``), whose cells hold every in-domain Gaussian's
    support radius: the oracle's exactness condition, its radius guard."""
    from gaussian_fluids_torch.ops import field, sparse

    with torch.no_grad():
        r = field.support_radius(mix.scalings, spec.clamp_threshold)
        r = float(r[field.in_domain_mask(mix, spec)].max())
    for cells in range(16, 0, -1):
        with env_set("GF_SPARSE_CELLS", str(cells)):
            if r <= min(sparse.grid_dims(spec)[1]):
                return cells
    raise AssertionError(f"backends: a support radius {r} exceeds the "
                         f"whole domain")


def backends(device, states):
    """``value_and_jac`` and ``two_head_grads`` under GF_FIELD_BACKEND
    auto, pallas, cells (2D: at d = 3 auto is the cells path already) and
    sparse, on BACKEND_B sorted queries of each state: every mode against
    auto within TOL of the largest entry (values, Jacobians, losses and
    each gradient group), ms per call, two sparse calls bitwise equal,
    each mode's launches by kernel. The oracle runs with the most cells
    that hold the state's radii (``_sparse_cells``), and must serve every
    call from its pair list: a fallback fails the phase."""
    from gaussian_fluids_torch.ops import field, gsr_cells, gsr_centered
    from gaussian_fluids_torch.ops import sparse

    t0 = time.perf_counter()
    out = {}
    for tag, (mix, spec) in states.items():
        d = spec.d
        cells = _sparse_cells(mix, spec)
        lo, hi = np.float32(spec.lo), np.float32(spec.hi)
        x = np.random.RandomState(21).uniform(lo, hi, (BACKEND_B, d))
        x = torch.as_tensor(x[np.argsort(x[:, 0])].astype(np.float32),
                            device=device)
        h1, h2 = _heads(d)
        params = {k: p.detach() for k, p in mix.params().items()}

        def vj():
            return _flat(field.value_and_jac(mix, spec, x, presorted=True,
                                             need_dx=False))

        def th():
            (l1, l2), (g1, g2) = field.two_head_grads(params, mix.alive,
                                                      spec, x, h1, h2)
            return [l1, l2] + [g[k] for g in (g1, g2) for k in sorted(g)]

        modes = ("auto", "pallas") + (("cells",) if d == 2 else ()) \
            + ("sparse",)
        res, ref = {}, None
        for mode in modes:
            with env_set("GF_FIELD_BACKEND", mode), \
                    env_set("GF_SPARSE_CELLS", str(cells)):
                sparse.reset_fallbacks()
                gsr_centered.reset_launches()
                gsr_cells.reset_launches()
                got = (vj(), th())
                torch.cuda.synchronize()
                launched = {k: v for k, v in {**gsr_centered.launches,
                                              **gsr_cells.launches}.items()
                            if v}
                fallbacks = sparse.fallbacks()
                rec = {"launches": launched, "sparse_fallbacks": fallbacks,
                       "value_and_jac_ms": time_ms(vj, 5),
                       "two_head_grads_ms": time_ms(th, 5)}
                if mode == "sparse":
                    if fallbacks or sparse.fallbacks() != fallbacks:
                        raise AssertionError(
                            f"backends {tag}: {sparse.fallbacks()} sparse "
                            f"calls fell back at {cells} cells")
                    again = (vj(), th())
                    rec["bitwise_repeat"] = all(
                        torch.equal(a, b) for a, b in zip(
                            got[0] + got[1], again[0] + again[1]))
                    if not rec["bitwise_repeat"]:
                        raise AssertionError(f"backends {tag}: two sparse "
                                             f"calls differ")
            if ref is None:
                ref = got
            else:
                rec["value_and_jac_err"] = compare(
                    f"backends {tag} {mode} value_and_jac", got[0], ref[0],
                    TOL)[1]
                rec["two_head_grads_err"] = max(
                    compare(f"backends {tag} {mode} two_head_grads[{i}]",
                            [a], [b], TOL)[1]
                    for i, (a, b) in enumerate(zip(got[1], ref[1])))
            res[mode] = rec
        out[tag] = {"B": BACKEND_B, "N": mix.capacity, "d": d,
                    "sparse_cells": cells, "modes": res}
    emit({"phase": "backends", "seconds": time.perf_counter() - t0,
          "tolerance": TOL, "states": out})


def cells_2d(device, card):
    """GF_FIELD_BACKEND=cells at d = 2: one Leapfrog-2D clone chunk and
    one projection chunk of CELLS_2D_EPOCHS epochs on the seeded state
    (warm Adam states, so a step is linear in its gradient), against the
    same chunks on the default path from the same generators' draws:
    parameters within TOL of each group's largest entry. Then each d = 2
    instantiation of rows 5-7 at the Leapfrog-2D shape (B = 512,
    N = 6144) against its plain twin, timed (median of 30), with its
    bounds. Returns those kernels' entries, their launches being the
    chunks' under the mode."""
    from gaussian_fluids_torch.mesh_check import _warm_opt
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.ops import gsr_cells as gk
    from gaussian_fluids_torch.ops import gsr_centered as gc
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import clone, project
    from gaussian_fluids_torch.solver.loop import hoist_default
    from gaussian_fluids_torch.utils.seeded_state import leapfrog_state

    t0 = time.perf_counter()
    mix, spec, x = leapfrog_state(device, seed=91)
    old, _, _ = leapfrog_state(device, seed=92)
    adv = get_scene_2d("leapfrog").advance_domain
    lo, hi = (-5.0, -5.0), (5.0, 5.0)

    def chunks():
        p = {k: v.clone() for k, v in mix.params().items()}
        stop = torch.rand(mix.capacity, generator=torch.Generator(
            device=device).manual_seed(3), device=device) > 0.5
        cr = clone._clone_runner(spec, 512, lo, hi)
        c = cr.run_chunk((p, _warm_opt(p, clone.DEFAULT_LRS_CLONE_2D),
                          mix.alive, stop, old),
                         torch.Generator(device=device).manual_seed(4),
                         CELLS_2D_EPOCHS, hoist_default(x))
        pr = project._runner_2d(spec, "leapfrog", project.ProjectWeights(),
                                1.0, 512)
        p = {k: v.clone() for k, v in mix.params().items()}
        q = pr.run_chunk((p, _warm_opt(p, project.DEFAULT_LRS_2D),
                          mix.alive, mix.positions + 0.01, old,
                          torch.tensor(adv, device=device), 0.025),
                         torch.Generator(device=device).manual_seed(5),
                         CELLS_2D_EPOCHS, hoist_default(x))
        torch.cuda.synchronize()
        return c[0], q[0]

    gk.reset_launches()
    gc.reset_launches()
    with env_set("GF_FIELD_BACKEND", "cells"):
        got = chunks()
    launches = dict(gk.launches)
    centered_under_cells = dict(gc.launches)
    cells_shapes = _cells_shapes()
    want = chunks()
    errs = {f"{phase} {k}": compare(f"cells_2d {phase} {k}", [g[k]], [w[k]],
                                    TOL)[1]
            for phase, g, w in (("clone", got[0], want[0]),
                                ("project", got[1], want[1]))
            for k in w}
    chunk_s = time.perf_counter() - t0

    # the d = 2 instantiations at the Leapfrog-2D shape
    mix, spec, x = leapfrog_state(device)
    clamp = spec.clamp_threshold
    x_p, _, tmask, (rows, cols, gt, qt, ok), rad = field._cells_prep(
        mix, spec, x)
    if not int(ok):
        raise AssertionError("the Leapfrog-2D work list overflowed")
    mu_p, pp_p, v_p = field._padded_param_rows(mix, spec, gk.TN)
    muT, ppT, v = (mu_p.T.contiguous(), pp_p.T.contiguous(),
                   v_p.contiguous())
    B, N = x_p.shape[0], muT.shape[1]
    rng = np.random.RandomState(1)
    dout = [torch.as_tensor(rng.randn(B, 6).astype(np.float32) / B,
                            device=device) for _ in range(2)]
    dout_val = torch.as_tensor(rng.randn(B, 2).astype(np.float32) / B,
                               device=device)
    live_tiles = int(tmask.sum())
    live_pairs = live_tiles * gk.TB * gk.TN
    support_pairs = _support_pairs(gc, tmask, x_p, muT, ppT, 2, clamp)
    par_bytes = 4 * (x_p.numel() + muT.numel() + ppT.numel() + v.numel())
    list_bytes = 2 * 4 * live_tiles
    out_fwd, out_bwd = 4 * B * 6, 4 * N * (2 + 6 + 2)
    lv, lt = (rows, cols, ok), (gt, qt, ok)
    args = (tmask, x_p, muT, ppT, v)

    def pair(kern, plain):
        return (lambda: _flat(kern()), lambda: _flat(plain()))

    cases = {
        "cells_fwd": ("cells", "fwd",
            [pair(lambda nj=nj: gk.cells_fwd(*lv, *args, clamp, nj, rad),
                  lambda nj=nj: gk.cells_fwd_plain(*lv, *args, clamp, nj))
             for nj in (2, 0)], out_fwd, list_bytes),
        "cells_bwd_dn": ("cells", "bwd_dn",
            [pair(lambda o=o, nj=nj: gk.cells_bwd_dn(*lt, *args, o, clamp,
                                                     nj, rad),
                  lambda o=o, nj=nj: gk.cells_bwd_dn_plain(*lt, *args, o,
                                                           clamp, nj))
             for nj, o in ((2, dout[0]), (0, dout_val))],
            4 * dout[0].numel() + out_bwd, list_bytes),
        "cells_bwd_dn2": ("cells", "bwd_dn2",
            [pair(lambda uv=uv: gk.cells_bwd_dn2(*lt, *args, *dout, clamp,
                                                 2, rad, use_val=uv),
                  lambda uv=uv: gk.cells_bwd_dn2_plain(
                      *lt, *args, *dout, clamp, 2, use_val=uv))
             for uv in (False, True)],
            4 * 2 * dout[0].numel() + 2 * out_bwd, list_bytes),
    }
    stats = _run_cases(cases, 2, live_pairs, support_pairs, par_bytes, True,
                       tag="[d=2]")
    for name, s_ in stats.items():
        s_.update(shape="Leapfrog-2D", B=B, N=N,
                  live_tile_fraction=live_tiles / tmask.numel(),
                  launches=launches[name.split("[")[0]],
                  launches_cells_2d={"cells_fwd": cells_shapes}
                  if name.startswith("cells_fwd") else {})
    stats["cells_fwd[d=2]"]["box_pairs"] = _box_pairs(tmask, x_p, muT, rad,
                                                      gk.TB, gk.TN)
    emit({"phase": "cells_2d", "seconds": time.perf_counter() - t0,
          "chunk_seconds": chunk_s, "card": card, "epochs": CELLS_2D_EPOCHS,
          "launches_under_cells": launches,
          "centered_launches_under_cells": centered_under_cells,
          "cells_fwd_launches_by_shape": cells_shapes,
          "params_max_rel_err": errs, "tolerance": TOL,
          "kernels": [{k: s_[k] for k in ("name", "max_abs_err",
                                          "max_rel_err", "ms", "plain_ms",
                                          "bound_ms", "walked_bound_ms",
                                          "bound_by", "launches")}
                      for s_ in stats.values()]})
    return stats


def mesh_error(card):
    """MESH_ERROR_LAUNCHES launches of two ranks sharing the card over
    gloo, rank 1 raising while rank 0 waits in a broadcast from it, side
    by side: each must raise rank 1's own error. Returns the phase's line
    (it runs beside other phases, from a thread, which must not print)."""
    from gaussian_fluids_torch import mesh_check

    t0 = time.perf_counter()
    own = mesh_check.mesh_error("cuda:0", MESH_ERROR_LAUNCHES)
    if own != MESH_ERROR_LAUNCHES:
        raise AssertionError(f"mesh_error: {own} of {MESH_ERROR_LAUNCHES} "
                             f"launches raised the failing rank's error")
    return {"phase": "mesh_error", "seconds": time.perf_counter() - t0,
            "beside": ["vortices_pass_2d", "initialize3d", "advance3d"],
            "card": card,
            "launches": MESH_ERROR_LAUNCHES, "own_error": own}


ANALYZERS_2D_GRIDS = {"leapfrog_2d": 160, "karman_2d": (250, 100)}
RC_REFERENCE = "runs_r2_evidence/analyze_ring3d_rc.txt"
RC_FRAME0 = "runs_r2_evidence/ckpts/output_3d_ring_collide/" \
    "gaussian_velocity_0.pt"
_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _analyzer(name, args):
    """``gaussian_fluids_torch.scripts.analyze_{name}.main(args)`` on the
    card, its table captured: (rows, text). Raises on a non-zero return,
    on no row, or on a number that is not finite."""
    mod = importlib.import_module(
        f"gaussian_fluids_torch.scripts.analyze_{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(args)
    text = buf.getvalue()
    rows = [ln for ln in text.splitlines() if ln.strip()[:1].isdigit()]
    if rc != 0 or not rows or re.search(r"\b(nan|inf)\b", text.lower()):
        raise AssertionError(f"analyze_{name} {args}: rc {rc}\n{text}")
    return rows, text


def _digit_unit(tok):
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def _rc_reference_row():
    """The JAX run's frame-0 row of ``analyze_ring3d_rc.txt``: {column:
    printed token}."""
    with open(RC_REFERENCE) as fh:
        lines = fh.read().splitlines()
    head = next(ln for ln in lines if ln.split()[:1] == ["frame"])
    row = next(ln for ln in lines if ln.split()[:1] == ["0"])
    return dict(zip(head.split(), row.split()))


def analysis_phase(tmp, device):
    """The port's run analyzers on the card, in this process, on the run
    directories the smoke wrote (Leapfrog-2D, Karman-2D, vortices_pass,
    Ring-Collide frames, the replay's 128^3 volumes) and on the committed
    Ring-Collide checkpoint 0 of the JAX run, whose row must reproduce the
    JAX analyzer's within one unit of each printed digit; row 1's
    launches by shape on this path, and its ms at the 2D analyzers'
    grids, which no earlier phase times."""
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.ops import field, gsr_cells
    from gaussian_fluids_torch.ops import gsr_centered as gc

    t0 = time.perf_counter()
    ring = os.path.join(tmp, "3d", "ring_collide")
    runs = {"leapfrog2d": [os.path.join(tmp, "2d"), "1"],
            "karman2d": [os.path.join(tmp, "karman"), "1"],
            "vortices_pass2d": [os.path.join(tmp, "vortices_pass"),
                                "vortices_pass", "1"],
            "ring3d": [ring, "1"],
            "rc_tg128_ab": [ring, ring, "1"],
            "density3d": [ring]}
    torch.cuda.synchronize()
    gc.reset_launches()
    gsr_cells.reset_launches()
    tables = {}
    with env_set("GF_DT", str(KARMAN_DT)):
        for name, args in runs.items():
            tables[name] = _analyzer(name, args)[0]
    # the committed JAX run's checkpoint 0, alone in a directory
    frame0 = os.path.join(tmp, "committed_rc0")
    os.makedirs(frame0)
    os.symlink(os.path.abspath(RC_FRAME0),
               os.path.join(frame0, "gaussian_velocity_0.pt"))
    rows, text = _analyzer("ring3d", [frame0, "1"])
    torch.cuda.synchronize()
    launches = {**dict(gc.launches), **dict(gsr_cells.launches)}
    shapes = _shape_counts(gc.fwd_shapes)
    seconds = time.perf_counter() - t0
    head = next(ln for ln in text.splitlines()
                if ln.split()[:1] == ["frame"]).split()
    got = dict(zip(head, rows[0].split()))
    want = _rc_reference_row()
    misses = {k: (got.get(k), w) for k, w in want.items()
              if got.get(k) is None
              or abs(float(got[k]) - float(w)) > _digit_unit(w) * 1.0001}
    if misses:
        raise AssertionError(f"analyze_ring3d on {RC_FRAME0}: {misses}")
    # row 1 at the 2D analyzers' grids (their only kernel), timed
    shapes_timed = {}
    for tag, sub in (("leapfrog_2d", "2d"), ("karman_2d", "karman")):
        mix, spec = checkpoint.load_checkpoint(
            os.path.join(tmp, sub, "gaussian_velocity_1.pt"), device=device)
        x = _analyzer_grid_2d(tag, spec, device)
        x_p, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
            mix, spec, x, gc.TB, gc.TN, presorted=False)
        shapes_timed[tag] = fwd_shape_entry(
            (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(),
             v_p.contiguous()), rad, spec.clamp_threshold)
        shapes_timed[tag]["launches_analysis"] = shapes.get(
            f"d=2,B={shapes_timed[tag]['B']},N={shapes_timed[tag]['N']}", 0)
    emit({"phase": "analysis", "seconds": seconds,
          "timing_seconds": time.perf_counter() - t0 - seconds,
          "rows": {k: len(v) for k, v in tables.items()},
          "tables": tables, "committed_rc_frame0": {
              "got": got, "jax": want, "within_one_digit": True},
          "launches": launches, "gsr_fwd_launches_by_shape": shapes,
          "gsr_fwd_at_analyzer_grids": shapes_timed})
    return launches, shapes, shapes_timed


def _analyzer_grid_2d(tag, spec, device):
    """The 2D analyzer's evaluation points, as its script builds them:
    Leapfrog-2D's 160^2 grid over the checkpoint's padded domain, Karman's
    250 x 100 over the scaled visualize domain."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    if tag == "karman_2d":
        sc = get_scene_2d("karman")
        x0, x1, y0, y1 = np.asarray(sc.visualize_domain) * sc.scaling_factor
        nx, ny = ANALYZERS_2D_GRIDS[tag]
    else:
        (x0, y0), (x1, y1) = spec.lo, spec.hi
        nx = ny = ANALYZERS_2D_GRIDS[tag]
    xs = np.linspace(x0 + 1e-3, x1 - 1e-3, nx)
    ys = np.linspace(y0 + 1e-3, y1 - 1e-3, ny)
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    return torch.as_tensor(pts.astype(np.float32), device=device)


def spatial_key_phase(device, rmix, rspec, n_queries=8192):
    """GF_SPATIAL_KEY=morton on the fitted Ring-Collide state: the
    mixture Morton-sorted (``spatially_sorted``) and a seeded batch of
    8192 points, through ``value_and_jac`` on the cells path (row 5: the
    queries sorted by the key inside) and on the centered path (row 1:
    the queries presorted by the key), each against the default order
    after the inverse permutation (TOL); the live tile fraction in both
    orders (data for the slab-major question, not a decision)."""
    from gaussian_fluids_torch.ops import field, gsr_cells, spatial
    from gaussian_fluids_torch.ops import gsr_centered as gc

    t0 = time.perf_counter()
    x = torch.as_tensor(np.random.RandomState(17).uniform(
        0, 1, (n_queries, 3)).astype(np.float32), device=device)
    lo, hi = rspec.lo, rspec.hi

    def run():
        mix = rmix.spatially_sorted()
        xs, inv = spatial.sort_queries(x, lo, hi)
        with torch.no_grad():
            cells = field.value_and_jac(mix, rspec, x, need_dx=False)
            cent = field.value_and_jac(mix, rspec, xs, presorted=True)
        cent = tuple(t[inv] for t in cent)
        tm = field._cells_prep(mix, rspec, xs)[2]
        return cells, cent, float(tm.float().mean())

    torch.cuda.synchronize()
    gc.reset_launches()
    gsr_cells.reset_launches()
    want_cells, want_cent, frac_x = run()
    with env_set("GF_SPATIAL_KEY", "morton"):
        got_cells, got_cent, frac_m = run()
    torch.cuda.synchronize()
    launches = {**dict(gc.launches), **dict(gsr_cells.launches)}
    overflows = gsr_cells.overflows()
    errs = {"cells": compare("spatial_key cells", got_cells, want_cells,
                             TOL),
            "centered": compare("spatial_key centered", got_cent,
                                want_cent, TOL)}
    if not launches.get("gsr_fwd") or not launches.get("cells_fwd"):
        raise AssertionError(f"spatial_key: launches {launches}")
    emit({"phase": "spatial_key", "seconds": time.perf_counter() - t0,
          "B": n_queries, "N": rmix.capacity,
          "max_rel_err": {k: e[1] for k, e in errs.items()},
          "tolerance": TOL,
          "live_tile_fraction": {"x": frac_x, "morton": frac_m},
          "launches": launches, "cells_overflows": overflows})
    return launches


def epoch_roofline(card, walls, proj_2d, device):
    """The projection epoch's modelled FLOPs and bytes (``utils/roofline``)
    against the walls earlier phases measured, no extra epoch: the seeded
    Ring-Collide epoch (B = 8192) at hoist_ab's four walls, and the
    Leapfrog-2D frame's projection over its seconds. The pairs are those
    the inputs need (``measured_support_density`` on one batch)."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.utils import roofline
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state

    t0 = time.perf_counter()
    mix, spec, x = ring_collide_state(device)
    n = mix.n_alive()
    dens = roofline.measured_support_density(mix, spec, x, chunk=1024)
    cost = roofline.projection_epoch_cost_3d(x.shape[0], n, dens)
    rc = {"B": x.shape[0], "N": n, "support_density": dens,
          "tile_density": roofline.measured_tile_density(mix, spec, x),
          "flops": cost.flops, "bytes": cost.hbm_bytes, "runs": []}
    for w in walls:
        u = cost.utilization(1e3 / w["wall_ms_per_epoch"])
        rc["runs"].append({**w, **u})
    mix2, spec2, seconds, epochs = proj_2d
    sc = get_scene_2d("leapfrog")
    dom = torch.tensor(sc.advance_domain, device=device) * sc.scaling_factor
    x2 = dom[0::2] + torch.rand(
        (512, 2), generator=torch.Generator(device=device).manual_seed(3),
        device=device) * (dom[1::2] - dom[0::2])
    n2 = mix2.n_alive()
    dens2 = roofline.measured_support_density(mix2, spec2, x2)
    cost2 = roofline.projection_epoch_cost_2d(512, n2, dens2)
    lf = {"B": 512, "N": n2, "support_density": dens2,
          "tile_density": roofline.measured_tile_density(mix2, spec2, x2),
          "flops": cost2.flops, "bytes": cost2.hbm_bytes,
          "epochs": epochs, "seconds": seconds,
          **cost2.utilization(epochs / seconds)}
    emit({"phase": "epoch_roofline", "seconds": time.perf_counter() - t0,
          "card": card, "peaks": roofline.PEAKS["h100"],
          "ring_collide": rc, "leapfrog_2d": lf})


def production_phase(run_dir):
    """The production chain on the smoke's Leapfrog-2D run: one resumed
    frame through ``Chain.advance`` and one step that fails on purpose."""
    from gaussian_fluids_torch.scripts import production, report_runs

    t0 = time.perf_counter()
    logdir = os.path.join(os.path.dirname(run_dir), "production_log")
    chain = production.Chain(logdir)
    k = production.last_frame(run_dir)
    chain.advance("lf_advance", run_dir, .025, (k + 1) * .025,
                  production.entry("advance2d", "--init_cond", "leapfrog",
                                   "--dir", run_dir, "--dt", .025,
                                   "--max_epoch", ADVANCE_EPOCHS))
    t1 = time.perf_counter()
    chain.run("must_fail", [sys.executable, "-c",
                            "print('production: failing on purpose'); "
                            "raise SystemExit(3)"])
    with open(os.path.join(logdir, "chain.log")) as fh:
        log = fh.read().splitlines()
    frames = [ln for ln in open(os.path.join(logdir, "lf_advance.log"))
              if ln.startswith("[frame ")]
    want = [f"--- lf_advance resuming from frame {k} (remaining t=0.025, "
            f"to frame {k + 1})",
            "=== must_fail FAILED rc=3",
            "    [must_fail tail] production: failing on purpose"]
    missing = [w for w in want if not any(ln.startswith(w) for ln in log)]
    if (chain.failed != ["must_fail"] or missing
            or production.last_frame(run_dir) != k + 1 or len(frames) != 1):
        raise AssertionError(f"production: failed {chain.failed}, missing "
                             f"{missing}, frames {frames}\n" + "\n".join(log))
    line = report_runs.report(run_dir)
    print(line, flush=True)
    emit({"phase": "production", "seconds": time.perf_counter() - t0,
          "resumed_frame_seconds": t1 - t0, "frame_line": frames[0].strip(),
          "chain_log": log, "report_runs": line})


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
    # the 2D scenes' Jacobians (torch.func) import torch._dynamo at their
    # first call: seconds of cold imports, made here while nvcc builds
    with ThreadPoolExecutor(1) as pool:
        warmed = pool.submit(importlib.import_module, "torch._dynamo")
        built = cuda_build.build(gsr_centered.SOURCE, gsr_cells.SOURCE,
                                 gsr_banded.SOURCE, rk4_fused.SOURCE)
        gsr_centered._lib()
        gsr_cells._lib()
        gsr_banded._lib()
        rk4_fused._lib()
        warmed.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "imported_meanwhile": "torch._dynamo",
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
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            launches_2d, shapes_2d, proj_seconds_2d = run_2d(
                os.path.join(tmp, "2d"))
        figures_2d(tmp, device, tee.lines)
        profile_phase(tmp)
        kmix, kspec, launches_karman, shapes_karman, rk4_shapes = \
            run_karman(os.path.join(tmp, "karman"))
        t0 = time.perf_counter()
        covector_fused(kmix, kspec)
        launches_heads = epoch_heads(kmix, kspec)
        emit({"phase": "karman_ab", "seconds": time.perf_counter() - t0})
        # the failing ranks' launches spend their time starting processes
        # and launch no kernel here: they run beside phases that time none
        with ThreadPoolExecutor(1) as pool:
            failing = pool.submit(mesh_error, card)
            vp_mix, vp_spec, launches_vp, shapes_vp = run_vortices_pass(
                os.path.join(tmp, "vortices_pass"), device)
            launches_3d, shapes_3d, cells_3d = run_3d(
                os.path.join(tmp, "3d"))
            emit(failing.result())
        t0 = time.perf_counter()
        targets = hoist_targets(device, vp_mix, vp_spec)
        hoisted = kernels_hoisted(device, vp_mix, vp_spec)
        gsr_cells.reset_launches()
        walls = hoist_ab(device)
        overflows = gsr_cells.overflows()
        if any(overflows.values()) or not all(
                hoisted[k]["list_ok"] for k in hoisted
                if k.startswith("cells_fwd")):
            raise AssertionError(f"hoist: work lists overflowed "
                                 f"{overflows}")
        emit({"phase": "hoist", "seconds": time.perf_counter() - t0,
              "card": card, "targets": targets, "kernels": hoisted,
              "projection_epoch_wall_pccp": walls,
              "cells_overflows": overflows})
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
        backends(device, {"ring_collide": (rmix, rspec),
                          "leapfrog_2d": checkpoint.load_checkpoint(
                              os.path.join(tmp, "2d",
                                           "gaussian_velocity_1.pt"),
                              device=device)})
        stats_c2 = cells_2d(device, card)
        grid_shapes = target_grid_rc(device, rmix, rspec)
        ring = os.path.join(tmp, "3d", "ring_collide")
        launches_density = run_density(ring)
        check_density(ring, device)
        launches_512 = density_512(ring, device)
        launches_an, shapes_an, timed_an = analysis_phase(tmp, device)
        launches_key = spatial_key_phase(device, rmix, rspec)
        epoch_roofline(card, walls, checkpoint.load_checkpoint(
            os.path.join(tmp, "2d", "gaussian_velocity_1.pt"),
            device=device) + (proj_seconds_2d, ADVANCE_EPOCHS), device)
        # the mesh ranks and the entry points' --mesh runs spend their time
        # starting processes and in gloo's host staging: they run beside
        # two single-process phases that time no kernel
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            started = mesh_start(pool, tmp, ring, device, card)
            launches_obstacle, shapes_obstacle = run_obstacle(
                os.path.join(tmp, "obstacle"), device)
            launches_replay = replay_vs_jax(device)
            t1 = time.perf_counter()
            launches_mesh = mesh_phases(tmp, ring, device, card, started)
        emit({"phase": "mesh", "seconds": time.perf_counter() - t0,
              "beside": ["obstacle3d", "replay_vs_jax"],
              "after_them_seconds": time.perf_counter() - t1})
        production_phase(os.path.join(tmp, "2d"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, s in stats.items():
        s["launches"] = launches_2d[name]
    stats["gsr_fwd"]["launches_by_shape"] = shapes_2d
    stats["gsr_fwd"]["vortices_pass_2d"] = {
        "launches": launches_vp["gsr_fwd"], "launches_by_shape": shapes_vp}
    for tag in ("B51200", "B1536"):
        e = hoisted["gsr_fwd_" + tag]
        stats["gsr_fwd"][f"hoisted_{tag}"] = {
            **e, "launches_vortices_pass": shapes_vp.get(
                f"d=2,B={e['B']},N={e['N']}", 0)}
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
    stats3["gsr_fwd[d=3]"]["launches_by_shape_obstacle"] = shapes_obstacle
    stats3["cells_fwd"]["launches_by_shape"] = cells_3d
    for tag, path in (("B204800", cells_3d), ("B204800_N1024", cells_3d),
                      ("B32768", grid_shapes)):
        e = hoisted["cells_fwd_" + tag]
        stats3["cells_fwd"][f"hoisted_{tag}"] = {
            **e, "launches": path.get(f"B={e['B']},N={e['N']}", 0)}
    for name, s in stats3.items():
        base = name.split("[")[0]
        s.update(launches=launches_3d[base] + launches_obstacle[base],
                 launches_3d_path=launches_3d[base],
                 launches_obstacle=launches_obstacle[base])
        if name.split("[")[0] in fitted:
            s["fitted_leapfrog_3d"] = {
                k: fitted[name.split("[")[0]][k] for k in (
                    "ms", "ms_1x1", "split", "worker_tiles_mean",
                    "worker_tiles_max", "max_rel_err_splits",
                    "live_tile_fraction", "support_pairs")}
    for name, s in stats_d.items():
        s.update(launches=launches_density[name] + launches_512
                 + launches_replay,
                 launches_replay_128=launches_density[name],
                 launches_512_step=launches_512,
                 launches_replay_vs_jax=launches_replay)
    stats_r["gsr_bwd_dx"]["launches"] = launches_dx[2]["gsr_bwd_dx"]
    stats_r["gsr_bwd_dx[d=3]"]["launches"] = launches_dx[3]["gsr_bwd_dx"]
    stats_r["gsr_bwd_dn3"]["launches"] = launches_heads["gsr_bwd_dn3"]
    stats_r["rk4_fused"]["launches"] = launches_karman["rk4_fused"]
    stats_r["rk4_fused"]["launches_by_shape"] = rk4_shapes
    e = hoisted["rk4_fused_B51200"]
    stats_r["rk4_fused"]["hoisted_B51200"] = {
        **e, "launches": rk4_shapes.get(f"B={e['B']},N={e['N']}", 0)}
    # the mesh phases' launches, summed over their ranks, on each path
    for path, table in (("leapfrog_2d", stats), ("ring_collide", stats3),
                        ("density", stats_d), (None, stats_r)):
        for name, s in table.items():
            n = launches_mesh[path].get(name.split("[")[0], 0) \
                if path else 0
            s["launches_mesh"] = {path: n} if path else {}
            s["launches"] += n
    for s in stats_c2.values():
        s["launches_mesh"] = {}
    # the analyzers' path (row 1 at d = 2 and 3) and the Morton check's
    # (rows 1 and 5 at d = 3), each counted from 0 over its phase
    an = {d: sum(c for k, c in shapes_an.items() if k.startswith(f"d={d},"))
          for d in (2, 3)}
    stats["gsr_fwd"]["launches_analysis"] = an[2]
    stats["gsr_fwd"]["analysis_launches_by_shape"] = {
        k: c for k, c in shapes_an.items() if k.startswith("d=2,")}
    stats["gsr_fwd"]["analyzer_grids"] = timed_an
    stats["gsr_fwd"]["launches"] += an[2]
    rc_fwd = stats3["gsr_fwd[d=3]"]
    rc_fwd.update(launches_analysis=an[3], analysis_launches_by_shape={
        k: c for k, c in shapes_an.items() if k.startswith("d=3,")},
        launches_spatial_key=launches_key["gsr_fwd"])
    rc_fwd["launches"] += an[3] + launches_key["gsr_fwd"]
    stats3["cells_fwd"]["launches_spatial_key"] = launches_key["cells_fwd"]
    stats3["cells_fwd"]["launches"] += launches_key["cells_fwd"]
    missing = [n for n, s in {**stats, **stats3, **stats_d, **stats_r,
                              **stats_c2}.items() if s["launches"] == 0]
    if missing:
        raise AssertionError(f"not launched on their main path: {missing}")
    print(f"total seconds: {time.perf_counter() - t_all:.1f} after the "
          f"imports, {process_seconds():.1f} since the process started")
    emit({"kernels": list(stats.values()) + list(stats3.values())
           + list(stats_c2.values()) + list(stats_d.values())
           + list(stats_r.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
