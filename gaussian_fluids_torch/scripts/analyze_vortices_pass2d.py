"""Fidelity analysis of a vortices_pass-family 2D run from its saved
checkpoints (reference workload: dt=.01, last_time=5 -> 500 frames;
variants vortices_pass / _narrow / _noslip / _particles), the JAX
package's ``scripts/analyze_vortices_pass2d.py`` on the port.

The scene is a vortex pair translating toward a gap between two circular
obstacles. For sampled frames this reports:
  * divergence residual (mean |div|, max |div|);
  * grid mean |vorticity| (conservation check);
  * the +/- vortex core positions: the pair must keep translating in +x
    and squeeze through the gap;
  * the boundary-flux residual mean |u.n| on each obstacle circle: how
    well the projection's free-slip constraint (reference
    2D/init_cond.py:325-346) holds, against the grid's mean speed.

Usage: python -m gaussian_fluids_torch.scripts.analyze_vortices_pass2d
           RUN_DIR [scene] [stride] [--device cpu]
"""
import sys

import numpy as np

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

RES = 160
M_FLUX = 256


def cores(vor, xs, ys):
    """Strongest positive and negative vorticity extremum (the pair)."""
    i, j = np.unravel_index(np.argmax(vor), vor.shape)
    k, l = np.unravel_index(np.argmin(vor), vor.shape)
    return (xs[j], ys[i], vor[i, j]), (xs[l], ys[k], vor[k, l])


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("scene", str, "vortices_pass"), ("stride", int, 50))
    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt in {args.run_dir}")

    scene_name = args.scene
    scene = get_scene_2d(scene_name)
    sf = scene.scaling_factor
    d = scene.visualize_domain
    xs = np.linspace(d[0] + 1e-3, d[1] - 1e-3, RES)
    ys = np.linspace(d[2] + 1e-3, d[3] - 1e-3, RES)
    pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    pts = pts.astype(np.float32)

    info = scene.info
    obstacles = []
    for k in ("obstacle_pos1", "obstacle_pos2", "obstacle_pos"):
        if k in info:
            obstacles.append((info[k], info["obstacle_radius"]))
    flux_probes = [analysis.circle_points(c, r, M_FLUX) for c, r in obstacles]

    sampled = [n for n in all_frames if n % args.stride == 0]
    if sampled[-1] != max(all_frames):
        sampled.append(max(all_frames))

    # no-slip variant: the circles carry a Dirichlet u=0 target (reference
    # 2D/init_cond.py:419-428), so the tangential velocity must vanish too
    noslip = scene_name == "vortices_pass_noslip"

    hdr_fl = " ".join(f"{'flux' + str(i):>9}" for i in range(len(obstacles)))
    if noslip:
        hdr_fl += " " + " ".join(
            f"{'slip' + str(i):>9}" for i in range(len(obstacles)))
    print(f"scene={scene_name}, obstacles={len(obstacles)}")
    print(f"{'frame':>6} {'N':>6} {'mean|div|':>11} {'max|div|':>10} "
          f"{'mean|vor|':>10} {'core+ (x,y)':>16} {'core- (x,y)':>16} "
          f"{hdr_fl}")
    flux_hist, slip_hist = [], []
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        val, jac = field.eval_on_grid(mix, spec, pts * sf)
        div = analysis.divergence_np(jac)
        vor = analysis.curl2d_np(jac).reshape(RES, RES)
        cp, cn = cores(vor, xs, ys)
        # the grid's mean flow speed normalizes the flux residual
        speed = np.linalg.norm(val / sf, axis=-1).mean()
        fl, sl = [], []
        for bp, bn in flux_probes:
            v = field.eval_on_grid(mix, spec,
                                   (bp * sf).astype(np.float32))[0] / sf
            mean_f, _ = analysis.flux_stats(v, bn)
            fl.append(mean_f / max(speed, 1e-12))
            if noslip:
                tang = np.stack([-bn[:, 1], bn[:, 0]], -1)
                mean_t, _ = analysis.flux_stats(v, tang)
                sl.append(mean_t / max(speed, 1e-12))
        if n >= 1:
            flux_hist.append(fl)
            slip_hist.append(sl)
        fl_s = " ".join(f"{f:9.4f}" for f in fl + sl)
        print(f"{n:6d} {mix.n_alive():6d} {np.abs(div).mean():11.3e} "
              f"{np.abs(div).max():10.3e} {np.abs(vor).mean():10.4f} "
              f"({cp[0]:+.2f},{cp[1]:+.2f})  ({cn[0]:+.2f},{cn[1]:+.2f})  "
              f"{fl_s}")

    dts = _runs.frame_seconds(all_frames, lambda d: 1.0 <= d < 600)
    if dts.size:
        print(f"# per-frame wall-clock over {dts.size} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f} s, "
              f"p90 {np.percentile(dts, 90):.1f} s")
    print("# flux columns: mean |u.n| on each obstacle circle / grid mean "
          "|u| (0 = perfectly impermeable)")
    if noslip:
        print("# slip columns: mean |u.t| (tangential) on each circle / "
              "grid mean |u| — the type-1 Dirichlet u=0 target adds this "
              "on top of impermeability")

    # the verdict over the frames after the first (frame 0 is the raw fit,
    # before any projection enforced the samplers): free-slip circles
    # near-impermeable, no-slip circles also without tangential slip
    if obstacles and flux_hist:
        med_fl = np.median(np.asarray(flux_hist), axis=0)
        ok = bool((med_fl < 0.05).all())
        msg = (f"median normalized obstacle flux per circle "
               f"{[f'{f:.4f}' for f in med_fl]} (threshold 0.05)")
        if noslip and slip_hist:
            med_sl = np.median(np.asarray(slip_hist), axis=0)
            ok = ok and bool((med_sl < 0.15).all())
            msg += (f"; median normalized tangential slip "
                    f"{[f'{s:.4f}' for s in med_sl]} (threshold 0.15)")
        print(f"# VERDICT obstacle constraint: {'PASS' if ok else 'WEAK'} "
              f"— {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
