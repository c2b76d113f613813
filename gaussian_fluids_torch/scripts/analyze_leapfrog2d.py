"""Long-horizon fidelity analysis of a Leapfrog-2D run from its saved
checkpoints (reference workload: dt=.025, last_time=40 -> 1600 frames),
the JAX package's ``scripts/analyze_leapfrog2d.py`` on the port.

For sampled frames, evaluates the field on a 160^2 grid and reports:
  * divergence residual (mean |div|, max |div|), the parity metric the
    reference prints per 100 epochs (2D/advance.py:271,286);
  * grid mean of |vorticity|: 2D vorticity is materially conserved, so a
    large decay means numerical dissipation;
  * the 4 vortex cores: local extrema of the vorticity field (2 positive,
    2 negative); the leapfrogging pairs must stay distinct and keep
    translating in +x for the run to preserve the structure.

Usage: python -m gaussian_fluids_torch.scripts.analyze_leapfrog2d
           RUN_DIR [stride] [--device cpu]
"""
import sys

import numpy as np

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

RES = 160


def cores(vor, xs, ys, k=2):
    """Positions of the k strongest positive and negative local extrema."""
    out = []
    for sign in (1.0, -1.0):
        v = vor * sign
        found = []
        vv = v.copy()
        for _ in range(k):
            i, j = np.unravel_index(np.argmax(vv), vv.shape)
            found.append((xs[j], ys[i], v[i, j]))
            # suppress a neighborhood so the next max is a distinct core
            r = RES // 10
            vv[max(0, i - r):i + r, max(0, j - r):j + r] = -np.inf
        out.append(found)
    return out


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 100))
    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt checkpoints found in "
                 f"{args.run_dir!r}")
    dts = _runs.frame_seconds(all_frames, lambda d: 1.0 <= d < 600)
    if dts.size:
        print(f"# per-frame wall-clock over {len(dts)} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f}, "
              f"p90 {np.percentile(dts, 90):.1f}, mean {dts.mean():.1f}")
    sampled = sorted(set([n for n in all_frames if n % args.stride == 0]
                         + [max(all_frames)]))
    print(f"{'frame':>6} {'mean|div|':>11} {'max|div|':>10} "
          f"{'mean|vor|':>10}  cores (+): (x, y, w)  cores (-): (x, y, w)")
    first_vor_sum = None
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        xs = np.linspace(spec.lo[0] + 1e-3, spec.hi[0] - 1e-3, RES)
        ys = np.linspace(spec.lo[1] + 1e-3, spec.hi[1] - 1e-3, RES)
        pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
        _, jac = field.eval_on_grid(mix, spec, pts)
        div = analysis.divergence_np(jac)
        vor = analysis.curl2d_np(jac).reshape(RES, RES)
        vor_sum = float(np.abs(vor).mean())
        if first_vor_sum is None:
            first_vor_sum = vor_sum
        cp, cn = cores(vor, xs, ys)

        def fmt(cs):
            return " ".join(f"({x:+.2f},{y:+.2f},{w:+.2f})"
                            for x, y, w in cs)

        print(f"{n:6d} {np.abs(div).mean():11.3e} {np.abs(div).max():10.3e} "
              f"{vor_sum:10.4f}  +:{fmt(cp)}  -:{fmt(cn)}")
    print(f"# |vor| retention vs first sampled frame: "
          f"{vor_sum / first_vor_sum * 100:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
