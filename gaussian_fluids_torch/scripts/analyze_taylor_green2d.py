"""Analytic-drift analysis of a Taylor-Green 2D run from its saved
checkpoints (reference workload: dt=.001, last_time=.2 -> 200 frames),
the JAX package's ``scripts/analyze_taylor_green2d.py`` on the port.

Taylor-Green is a stationary solution of the incompressible Euler
equations, so the t=0 analytic field (reference 2D/init_cond.py:158-167)
stays the exact solution for the whole horizon. For sampled frames this
reports:
  * L1 velocity error against the analytic field, relative to the
    analytic mean |u|;
  * divergence residual (mean |div|, max |div|), the parity metric the
    reference prints per 100 epochs (2D/advance.py:271,286);
  * grid mean |vorticity| against the analytic one;
plus per-frame wall-clock statistics from checkpoint mtimes.

Usage: python -m gaussian_fluids_torch.scripts.analyze_taylor_green2d
           RUN_DIR [stride] [--device cpu]
"""
import sys

import numpy as np
import torch

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

RES = 160


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 20))
    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt in {args.run_dir}")

    scene = get_scene_2d("taylor_green")
    sf = scene.scaling_factor
    d = scene.visualize_domain
    xs = np.linspace(d[0] + 1e-3, d[1] - 1e-3, RES)
    ys = np.linspace(d[2] + 1e-3, d[3] - 1e-3, RES)
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    pts = pts.astype(np.float32)

    # the analytic field, in the original space, on the host
    with torch.no_grad():
        ref_v = scene.velocity(torch.from_numpy(pts)).numpy()
        ref_jac = scene.velocity_jac(torch.from_numpy(pts)).numpy()
    ref_speed = np.abs(ref_v).mean()
    ref_vor_mean = np.abs(analysis.curl2d_np(ref_jac)).mean()

    sampled = [n for n in all_frames if n % args.stride == 0]
    if sampled[-1] != max(all_frames):
        sampled.append(max(all_frames))

    print(f"analytic mean|u| = {ref_speed:.4f}, mean|vor| = "
          f"{ref_vor_mean:.4f}")
    print(f"{'frame':>6} {'N':>6} {'relL1(u)':>9} {'mean|div|':>11} "
          f"{'max|div|':>10} {'mean|vor|':>10}")
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        # the solver's state lives in the scaled target space
        val, jac = field.eval_on_grid(mix, spec, pts * sf)
        vel = val / sf                                 # back to original
        err = np.abs(vel - ref_v).mean() / ref_speed
        div = analysis.divergence_np(jac)             # d(su)/d(sx) = du/dx
        vor = analysis.curl2d_np(jac)
        print(f"{n:6d} {mix.n_alive():6d} {err:9.4f} "
              f"{np.abs(div).mean():11.3e} {np.abs(div).max():10.3e} "
              f"{np.abs(vor).mean():10.4f}")

    dts = _runs.frame_seconds(all_frames, lambda d: 1.0 <= d < 600)
    if dts.size:
        print(f"# per-frame wall-clock over {dts.size} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f} s, "
              f"p90 {np.percentile(dts, 90):.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
