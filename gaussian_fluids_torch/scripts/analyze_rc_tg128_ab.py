"""Full-horizon fidelity A/B: ring_collide advanced with interpolated
targets (--target_grid 128) against the exact-target run, the JAX
package's ``scripts/analyze_rc_tg128_ab.py`` on the port. Both runs share
frame 0; for every common frame this compares what the projection is
asked to enforce:

  * divergence residual (mean |div| on a RES^3 grid);
  * mean |vorticity| and the ring radius (strong-core weighted, as in
    ``analyze_ring3d``);
  * wall impermeability (mean |u.n| on the box faces / mean |u|).

Verdict: the cached-target run passes if its per-frame mean |div| stays
within 25% of (or below) the exact run's and the ring radius tracks
within 0.02.

Usage: python -m gaussian_fluids_torch.scripts.analyze_rc_tg128_ab
           [exact_dir] [cached_dir] [stride] [res] [--device cpu]
"""
import sys

import numpy as np

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.scripts.analyze_ring3d import ring_rows
from gaussian_fluids_torch.utils import analysis


def main(argv=None):
    args = _runs.parse(__doc__, argv,
                       ("exact_dir", str, "output_3d_ring_collide"),
                       ("cached_dir", str, "output_3d_rc_tg128"),
                       ("stride", int, 4), ("res", int, 32))
    fe, fc = _runs.frames(args.exact_dir), _runs.frames(args.cached_dir)
    common = sorted(set(fe) & set(fc))
    if len(common) < 2:
        sys.exit(f"not enough common frames: exact {sorted(fe)[-3:]}, "
                 f"cached {sorted(fc)[-3:]}")
    sampled = sorted(set([n for n in common if n % args.stride == 0]
                         + [common[-1]]))

    xs = np.linspace(0.0, 1.0, args.res, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                   -1).reshape(-1, 3)
    wall_pts, wall_nrm = analysis.box_points((0.0, 0.0, 0.0),
                                             (1.0, 1.0, 1.0), 256)
    wall_pts = wall_pts.astype(np.float32)

    def metrics(ck):
        mix, spec = load_checkpoint(ck, device=args.device)
        return ring_rows(mix, spec, pts, wall_pts, wall_nrm)

    print(f"# exact={args.exact_dir} cached={args.cached_dir} "
          f"res={args.res}")
    print(f"{'frame':>6} | {'mean|div| ex':>12} {'cached':>10} "
          f"{'ratio':>6} | {'mean|vor| ex':>12} {'cached':>10} | "
          f"{'r_ring ex':>9} {'cached':>7} | {'wallflux ex':>11} "
          f"{'cached':>7}")
    worst_ratio, worst_dr = 0.0, 0.0
    for n in sampled:
        me, mc = metrics(fe[n]), metrics(fc[n])
        ratio = mc["div_mean"] / max(me["div_mean"], 1e-12)
        dr = abs(mc["r_ring"] - me["r_ring"])
        if n > 0:  # frame 0 is shared, ratio 1 by construction
            worst_ratio = max(worst_ratio, ratio)
            worst_dr = max(worst_dr, dr)
        print(f"{n:6d} | {me['div_mean']:12.3e} {mc['div_mean']:10.3e} "
              f"{ratio:6.2f} | {me['vor_mean']:12.4f} "
              f"{mc['vor_mean']:10.4f} | {me['r_ring']:9.3f} "
              f"{mc['r_ring']:7.3f} | {me['wallflux']:11.4f} "
              f"{mc['wallflux']:7.4f}")

    ok = worst_ratio <= 1.25 and worst_dr <= 0.02
    print(f"# VERDICT: {'PASS' if ok else 'FAIL'} — worst cached/exact "
          f"mean|div| ratio {worst_ratio:.2f} (gate 1.25), worst |r_ring| "
          f"drift {worst_dr:.3f} (gate 0.02) over frames {sampled[0]}..."
          f"{sampled[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
