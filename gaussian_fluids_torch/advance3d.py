"""3D simulation entry point.

    python -m gaussian_fluids_torch.advance3d --init_cond ring_collide \
        --dir D --dt .02 --last_time 1 [--mesh BxG]

``--mesh`` runs the frame loop on B x G ranks (``parallel/mesh.py``);
``--profile DIR`` traces the run (under ``--mesh`` each rank into
``DIR/rank{r}/``).
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.parallel.mesh import launch, mesh_from_shape
from gaussian_fluids_torch.solver.simulate3d import advance_3d
from gaussian_fluids_torch.utils.profiling import maybe_trace, rank_dir


def _rank_main(mesh, args, kwargs, profile=None):
    with maybe_trace(rank_dir(profile, mesh.rank), mesh.device):
        return advance_3d(*args, **kwargs, mesh=mesh)


def main(argv=None):
    args = parse_args_3d(argv, default_max_epoch=20000)
    run = (args.init_cond, args.dir, args.dt, args.last_time)
    kwargs = dict(start_frame=args.start_frame, max_epoch=args.max_epoch,
                  boundary_lambda=args.boundary, seed=args.seed,
                  viz=not args.no_viz, target_grid_res=args.target_grid)
    if args.mesh:
        shape = mesh_from_shape(args.mesh, args.target_grid, args.device)
        # each rank traces itself, the launching process nothing
        return launch(_rank_main, shape, (run, kwargs, args.profile),
                      device=args.device)[0]
    with maybe_trace(args.profile, args.device):
        return advance_3d(*run, **kwargs, device=args.device)


if __name__ == "__main__":
    main()
