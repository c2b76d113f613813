"""Fidelity analysis of a Taylor-vortex 2D run from its saved checkpoints
(reference workload: dt=.01, last_time=4 -> 400 frames), the JAX
package's ``scripts/analyze_taylor_vortex2d.py`` on the port.

The scene is two co-rotating Gaussian vortices (reference
2D/init_cond.py:169-191) at separation 1.6 with core radius a=0.5: the
pair must orbit its centroid while conserving vorticity. For sampled
frames this reports:
  * divergence residual (mean |div|, max |div|);
  * grid mean |vorticity| (material conservation);
  * the two positive core positions, their separation, and the pair's
    orientation angle: the separation should stay ~constant before the
    merger while the angle advances (solid-body-like co-rotation).

Usage: python -m gaussian_fluids_torch.scripts.analyze_taylor_vortex2d
           RUN_DIR [stride] [--device cpu]
"""
import sys

import numpy as np

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

RES = 160


def two_pos_cores(vor, xs, ys):
    """The two strongest positive local extrema (suppressing a
    neighborhood around the first so the second is the other vortex)."""
    vv = vor.copy()
    found = []
    for _ in range(2):
        i, j = np.unravel_index(np.argmax(vv), vv.shape)
        found.append((xs[j], ys[i], vor[i, j]))
        r = RES // 8
        vv[max(0, i - r):i + r, max(0, j - r):j + r] = -np.inf
    return found


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 40))
    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt in {args.run_dir}")

    scene = get_scene_2d("taylor_vortex")
    sf = scene.scaling_factor
    d = scene.visualize_domain
    xs = np.linspace(d[0] + 1e-3, d[1] - 1e-3, RES)
    ys = np.linspace(d[2] + 1e-3, d[3] - 1e-3, RES)
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    pts = pts.astype(np.float32)

    sampled = [n for n in all_frames if n % args.stride == 0]
    if sampled[-1] != max(all_frames):
        sampled.append(max(all_frames))

    print(f"{'frame':>6} {'N':>6} {'mean|div|':>11} {'max|div|':>10} "
          f"{'mean|vor|':>10} {'core1 (x,y)':>15} {'core2 (x,y)':>15} "
          f"{'sep':>6} {'angle':>7}")
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        _, jac = field.eval_on_grid(mix, spec, pts * sf)
        div = analysis.divergence_np(jac)
        vor = analysis.curl2d_np(jac).reshape(RES, RES)
        (x1, y1, w1), (x2, y2, w2) = two_pos_cores(vor, xs, ys)
        sep = float(np.hypot(x1 - x2, y1 - y2))
        ang = float(np.degrees(np.arctan2(y1 - y2, x1 - x2))) % 180.0
        print(f"{n:6d} {mix.n_alive():6d} {np.abs(div).mean():11.3e} "
              f"{np.abs(div).max():10.3e} {np.abs(vor).mean():10.4f} "
              f"({x1:+.2f},{y1:+.2f})  ({x2:+.2f},{y2:+.2f})  "
              f"{sep:6.3f} {ang:7.1f}")

    dts = _runs.frame_seconds(all_frames, lambda d: 1.0 <= d < 600)
    if dts.size:
        print(f"# per-frame wall-clock over {dts.size} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f} s, "
              f"p90 {np.percentile(dts, 90):.1f} s")
    print("# sep: core separation (pre-merger ~1.6); angle: pair "
          "orientation in [0,180) deg — should advance as the pair "
          "co-rotates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
