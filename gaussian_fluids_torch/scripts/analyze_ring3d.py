"""Long-horizon analysis of a 3D vortex-ring run (ring_collide /
single_vortex_ring / leapfrog / ring_with_obstacle) from its saved
checkpoints, the JAX package's ``scripts/analyze_ring3d.py`` on the port.

For sampled frames, evaluates the field on a RES^3 grid over the unit
domain and reports:
  * divergence residual (mean |div|, max |div|), the parity metric the
    reference prints per 100 epochs (3D/advance.py:271,295);
  * mean |vorticity| (material conservation up to stretching);
  * the vorticity-weighted ring radius E_|w|[ sqrt((y-.5)^2 + (z-.5)^2) ]:
    for ring_collide the merged ring expands, so it grows after the
    collision;
  * the vorticity-weighted axial spread E_|w|[ |x - .5| ]: the rings
    approach the collision plane, so it shrinks and stays small;
  * the wall flux: mean |u.n| on the domain box's faces over the grid's
    mean |u|; with a scene that has an obstacle mesh
    (ring_with_obstacle), the same on 1024 points of the mesh.

The mesh's probe points come from the port's own seeded generator
(``torch.Generator`` seeded 0), not the JAX script's ``jax.random`` key:
the two streams differ, so that column is a sampling of its own.

Usage: python -m gaussian_fluids_torch.scripts.analyze_ring3d
           RUN_DIR [stride] [res] [scene] [--device cpu]
"""
import sys

import numpy as np
import torch

from gaussian_fluids_torch.io.checkpoint import load_checkpoint
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scripts import _runs
from gaussian_fluids_torch.utils import analysis

MESH_PROBES = 1024


def mesh_probes(scene_name):
    """(points, normals) on the scene's obstacle mesh, or (None, None)."""
    if scene_name is None:
        return None, None
    from gaussian_fluids_torch.scenes import get_scene_3d
    scene = get_scene_3d(scene_name)
    if scene.mesh_sampler is None:
        return None, None
    p, nr = scene.mesh_sampler.sample(torch.Generator().manual_seed(0),
                                      MESH_PROBES)
    return p.numpy().astype(np.float32), nr.numpy()


def ring_rows(mix, spec, pts, wall_pts, wall_nrm, mesh_pts=None,
              mesh_nrm=None):
    """The row's numbers of one frame: mean and max |div|, mean |vor|, the
    ring radius and axial spread of the strong cores, the wall flux and
    (with mesh probes) the mesh flux, over the grid's mean speed."""
    r_perp = np.sqrt((pts[:, 1] - 0.5) ** 2 + (pts[:, 2] - 0.5) ** 2)
    ax_dist = np.abs(pts[:, 0] - 0.5)
    val, jac = field.eval_on_grid(mix, spec, pts)
    div = analysis.divergence_np(jac)
    vor = analysis.curl3d_np(jac)
    w = np.linalg.norm(vor, axis=-1)
    speed = np.linalg.norm(val, axis=-1).mean()
    wall_v = field.eval_on_grid(mix, spec, wall_pts)[0]
    wall_flux, _ = analysis.flux_stats(wall_v, wall_nrm)
    # ring geometry from the strong cores only: the weak background
    # vorticity fills the whole domain and would dilute the weighted radius
    wm = w * (w > 0.25 * w.max())
    wsum = wm.sum() + 1e-30
    out = {"div_mean": np.abs(div).mean(), "div_max": np.abs(div).max(),
           "vor_mean": np.linalg.norm(vor, axis=-1).mean(),
           "r_ring": (wm * r_perp).sum() / wsum,
           "ax_spread": (wm * ax_dist).sum() / wsum,
           "wallflux": wall_flux / max(speed, 1e-12)}
    if mesh_pts is not None:
        mv = field.eval_on_grid(mix, spec, mesh_pts)[0]
        mf, _ = analysis.flux_stats(mv, mesh_nrm)
        out["meshflux"] = mf / max(speed, 1e-12)
    return out


def main(argv=None):
    args = _runs.parse(__doc__, argv, ("run_dir", str, ...),
                       ("stride", int, 5), ("res", int, 32),
                       ("scene", str, None))
    all_frames = _runs.frames(args.run_dir)
    if not all_frames:
        sys.exit(f"no gaussian_velocity_*.pt checkpoints found in "
                 f"{args.run_dir!r}")
    dts = _runs.frame_seconds(all_frames, lambda d: 1.0 <= d < 3600)
    if dts.size:
        print(f"# per-frame wall-clock over {len(dts)} consecutive frames: "
              f"median {np.median(dts):.1f} s, "
              f"p10 {np.percentile(dts, 10):.1f}, "
              f"p90 {np.percentile(dts, 90):.1f}, mean {dts.mean():.1f}")

    xs = np.linspace(0.0, 1.0, args.res, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                   -1).reshape(-1, 3)
    # the domain walls' impermeability (the boundary constraint the 3D
    # projection enforces at lambda=10, reference 3D/advance.py:230-235)
    wall_pts, wall_nrm = analysis.box_points((0.0, 0.0, 0.0),
                                             (1.0, 1.0, 1.0), 256)
    wall_pts = wall_pts.astype(np.float32)
    mesh_pts, mesh_nrm = mesh_probes(args.scene)

    sampled = sorted(set([n for n in all_frames if n % args.stride == 0]
                         + [max(all_frames)]))
    mesh_hdr = f" {'meshflux':>9}" if mesh_pts is not None else ""
    print(f"{'frame':>6} {'N':>7} {'mean|div|':>11} {'max|div|':>10} "
          f"{'mean|vor|':>10} {'r_ring':>7} {'ax_spread':>9} "
          f"{'wallflux':>9}{mesh_hdr}")
    for n in sampled:
        mix, spec = load_checkpoint(all_frames[n], device=args.device)
        r = ring_rows(mix, spec, pts, wall_pts, wall_nrm, mesh_pts,
                      mesh_nrm)
        mesh_col = f" {r['meshflux']:9.4f}" if "meshflux" in r else ""
        print(f"{n:6d} {mix.n_alive():7d} {r['div_mean']:11.3e} "
              f"{r['div_max']:10.3e} {r['vor_mean']:10.4f} "
              f"{r['r_ring']:7.3f} {r['ax_spread']:9.3f} "
              f"{r['wallflux']:9.4f}{mesh_col}")
    print("# wallflux: mean |u.n| on the domain box faces / grid mean |u| "
          "(0 = impermeable walls)"
          + ("; meshflux: same on the obstacle mesh surface"
             if mesh_pts is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
