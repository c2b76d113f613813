"""Physics validation of a smoke-density replay from its .vti sequence,
the JAX package's ``scripts/analyze_density3d.py`` on the port.

The replay is semi-Lagrangian: every grid node RK4-backtraces through the
frame's velocity checkpoint and trilinearly interpolates the previous
density. Trilinear interpolation is a convex combination of the 8
surrounding nodes, which gives two strict invariants this analyzer
enforces, plus scene-level physics it reports:

  * max density non-increasing and min >= 0 per frame (convexity);
  * total mass roughly conserved (bounded, neither draining nor growing);
  * per-tag density centre of mass and axial / radial spread about it.

Pure numpy over the .vti files (``io/vti.read_vti_array``): it evaluates
no field, so ``--device`` is accepted and unused. Exits 1 when an
invariant fails.

Usage: python -m gaussian_fluids_torch.scripts.analyze_density3d
           RUN_DIR [stride]
"""
import glob
import os
import re
import sys

import numpy as np

from gaussian_fluids_torch.io.vti import read_vti_array
from gaussian_fluids_torch.scripts import _runs


def sequences(run_dir):
    pat = re.compile(r"density_([a-z])_(\d+)\.vti$")
    out = {}
    for f in glob.glob(os.path.join(run_dir, "density_*_*.vti")):
        m = pat.search(f)
        if m:
            out.setdefault(m.group(1), {})[int(m.group(2))] = f
    return {tag: dict(sorted(fr.items())) for tag, fr in sorted(out.items())}


def stats(V):
    mass = float(V.sum())
    vmax = float(V.max())
    vmin = float(V.min())
    com = np.zeros(3)
    spread_r = spread_ax = float("nan")
    if mass > 0:
        nx, ny, nz = V.shape
        # density-weighted moments of normalized [0, 1) node coordinates
        # through axis sums (no 512^3 meshgrid)
        axsum = [V.sum(axis=tuple(j for j in range(3) if j != i))
                 for i in range(3)]
        coords = [np.arange(n) / n for n in (nx, ny, nz)]
        com = np.array([float((c * s).sum()) / mass
                        for c, s in zip(coords, axsum)])
        # spreads about the centre of mass: axial along x (ring_collide's
        # collision axis), radial sqrt(y^2 + z^2)
        spread_ax = float((np.abs(coords[0] - com[0]) * axsum[0]).sum()
                          / mass)
        y2 = ((coords[1] - com[1]) ** 2 * axsum[1]).sum() / mass
        z2 = ((coords[2] - com[2]) ** 2 * axsum[2]).sum() / mass
        spread_r = float(np.sqrt(y2 + z2))
    return mass, vmax, vmin, com, spread_ax, spread_r


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 1))
    seqs = sequences(args.run_dir)
    if not seqs:
        print(f"no density_*_*.vti in {args.run_dir}")
        return 1
    failures = []
    for tag, fr in seqs.items():
        print(f"== density '{tag}' ({len(fr)} frames)")
        print(f"{'frame':>5} {'mass/mass0':>10} {'max':>9} {'min':>10} "
              f"{'com':>23} {'ax_spread':>9} {'r_spread':>9}")
        mass0 = prev_max = None
        ks = [k for i, k in enumerate(sorted(fr)) if i % args.stride == 0]
        if sorted(fr)[-1] not in ks:
            ks.append(sorted(fr)[-1])
        for k in ks:
            mass, vmax, vmin, com, sax, sr = stats(read_vti_array(fr[k]))
            if mass0 is None:
                mass0 = mass if mass else 1.0
            if vmin < -1e-6:
                failures.append(f"{tag}[{k}]: min {vmin} < 0")
            if prev_max is not None and vmax > prev_max * (1 + 1e-5):
                failures.append(
                    f"{tag}[{k}]: max grew {prev_max} -> {vmax}")
            prev_max = vmax
            com_s = "(" + ",".join(f"{c:.3f}" for c in com) + ")"
            print(f"{k:>5} {mass / mass0:>10.4f} {vmax:>9.4f} "
                  f"{vmin:>10.2e} {com_s:>23} {sax:>9.4f} {sr:>9.4f}")
    if failures:
        print("FAILED invariants:")
        for f in failures:
            print("  " + f)
        return 1
    print("invariants OK (min >= 0, max non-increasing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
