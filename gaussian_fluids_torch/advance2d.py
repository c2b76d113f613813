"""2D simulation entry point.

    python -m gaussian_fluids_torch.advance2d --init_cond leapfrog \
        --dir D --dt .025 --last_time 40 [--mesh BxG]

``--mesh`` runs the frame loop on B x G ranks (``parallel/mesh.py``).
"""

from gaussian_fluids_torch.cli import parse_args_2d
from gaussian_fluids_torch.parallel.mesh import launch, mesh_from_shape
from gaussian_fluids_torch.solver.simulate2d import advance_2d


def _rank_main(mesh, args, kwargs):
    return advance_2d(*args, **kwargs, mesh=mesh)


def main(argv=None):
    args = parse_args_2d(argv, default_max_epoch=20000)
    run = (args.init_cond, args.dir, args.dt, args.last_time)
    kwargs = dict(start_frame=args.start_frame, max_epoch=args.max_epoch,
                  seed=args.seed, target_grid_res=args.target_grid)
    if args.mesh:
        shape = mesh_from_shape(args.mesh, args.target_grid, args.device)
        return launch(_rank_main, shape, (run, kwargs),
                      device=args.device)[0]
    return advance_2d(*run, **kwargs, device=args.device)


if __name__ == "__main__":
    main()
