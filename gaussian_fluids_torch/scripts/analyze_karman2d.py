"""Long-horizon analysis of a Karman-2D run from its saved checkpoints
(reference workload: dt=.05, last_time=10 -> 200 frames; N = 400x60 =
24,000 Gaussians, moving inflow domain), the JAX package's
``scripts/analyze_karman2d.py`` on the port.

For sampled frames, evaluates the field on the visualize domain (in the
scaled target space the checkpoints live in) and reports:
  * divergence residual (mean |div|, max |div|) outside the cylinder;
  * vortex-street structure: sign alternations of the cross-stream-max
    vorticity along x behind the cylinder (a laminar flow has 0-1, an
    established street several, migrating downstream over frames);
  * mean |vorticity| in the wake;
then the shedding frequency and Strouhal number from the cross-stream
velocity at a probe behind the cylinder, one sample per frame
(``GF_DT``: the run's frame spacing, default 0.05 s).

Usage: python -m gaussian_fluids_torch.scripts.analyze_karman2d
           RUN_DIR [stride] [--device cpu]
"""
import os
import sys

import numpy as np
import torch

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

RES_X, RES_Y = 250, 100


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 20))
    scene = get_scene_2d("karman")
    sf = scene.scaling_factor
    # the cylinder: centre and radius from the scene's info, scaled
    cx, cy = np.asarray(scene.info["obstacle_pos"]) * sf
    radius = scene.info["obstacle_radius"] * sf
    vx0, vx1, vy0, vy1 = (np.asarray(scene.visualize_domain) * sf)

    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt checkpoints found in "
                 f"{args.run_dir!r}")
    ns = sorted(all_frames)
    dts = _runs.frame_seconds(all_frames, lambda d: 0 < d < 600)
    if dts.size:
        print(f"# per-frame wall-clock over {len(dts)} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f}, "
              f"p90 {np.percentile(dts, 90):.1f}, mean {dts.mean():.1f}")

    sampled = sorted(set([n for n in all_frames if n % args.stride == 0]
                         + [max(all_frames)]))
    print(f"{'frame':>6} {'N':>7} {'mean|div|':>11} {'max|div|':>10} "
          f"{'wake mean|vor|':>14} {'street alternations':>20}")
    xs = np.linspace(vx0 + 1e-3, vx1 - 1e-3, RES_X)
    ys = np.linspace(vy0 + 1e-3, vy1 - 1e-3, RES_Y)
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    mask_cyl = ((pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2
                > (1.2 * radius) ** 2)
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        _, jac = field.eval_on_grid(mix, spec, pts)
        div = analysis.divergence_np(jac)[mask_cyl]
        vor = analysis.curl2d_np(jac).reshape(RES_Y, RES_X)
        alt, wake_vor = analysis.street_alternations(vor, xs, cx, radius)
        print(f"{n:6d} {mix.n_alive():7d} {np.abs(div).mean():11.3e} "
              f"{np.abs(div).max():10.3e} {wake_vor:14.4f} {alt:20d}")

    # The shedding frequency: v_y at a point a few diameters behind the
    # cylinder, one sample per frame; St = f D / U in original units (the
    # scaling cancels). Only the longest run of consecutive frames is
    # used: the crossing count assumes uniform spacing.
    dt_env = float(os.environ.get("GF_DT", "0.05"))
    print(f"# assuming frame spacing dt={dt_env} s "
          f"(set GF_DT to the run's --dt if different)")
    best = cur = [ns[0]]
    for a, b in zip(ns, ns[1:]):
        cur = cur + [b] if b == a + 1 else [b]
        if len(cur) > len(best):
            best = cur
    if len(best) < len(ns):
        print(f"# note: checkpoints are not consecutive; probing the "
              f"longest gapless run, frames {best[0]}..{best[-1]} "
              f"({len(best)} of {len(ns)})")
    probe = np.asarray([[cx + 6.0 * radius, cy]], np.float32)
    vy = []
    for n in best:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        with torch.no_grad():
            v = field.value(mix, spec, torch.as_tensor(probe,
                                                       device=mix.device),
                            need_dx=False)
        vy.append(float(v[0, 1]))
    crossings, dur, freq, st = analysis.shedding_stats(
        vy, dt_env, 2.0 * scene.info["obstacle_radius"],
        scene.info["v_magnitude"])
    if freq is not None:
        print(f"# probe v_y at x=cx+6r over frames "
              f"{best[len(vy) // 2]}..{best[-1]}"
              f": {crossings} mean-crossings in {dur:.2f}s -> shedding "
              f"f={freq:.3f} Hz, Strouhal St=f*D/U={st:.3f} "
              f"(rigid-cylinder reference ~0.2)")
    else:
        print(f"# no established shedding detected at the probe "
              f"({crossings} crossings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
