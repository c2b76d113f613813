"""3D simulation entry point.

    python -m gaussian_fluids_torch.advance3d --init_cond ring_collide \
        --dir D --dt .02 --last_time 1 [--mesh BxG]

``--mesh`` runs the frame loop on B x G ranks (``parallel/mesh.py``).
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.parallel.mesh import launch, mesh_from_shape
from gaussian_fluids_torch.solver.simulate3d import advance_3d


def _rank_main(mesh, args, kwargs):
    return advance_3d(*args, **kwargs, mesh=mesh)


def main(argv=None):
    args = parse_args_3d(argv, default_max_epoch=20000)
    run = (args.init_cond, args.dir, args.dt, args.last_time)
    kwargs = dict(start_frame=args.start_frame, max_epoch=args.max_epoch,
                  boundary_lambda=args.boundary, seed=args.seed,
                  viz=not args.no_viz, target_grid_res=args.target_grid)
    if args.mesh:
        shape = mesh_from_shape(args.mesh, args.target_grid, args.device)
        return launch(_rank_main, shape, (run, kwargs),
                      device=args.device)[0]
    return advance_3d(*run, **kwargs, device=args.device)


if __name__ == "__main__":
    main()
