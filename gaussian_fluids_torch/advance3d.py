"""3D simulation entry point.

    python -m gaussian_fluids_torch.advance3d --init_cond ring_collide \
        --dir D --dt .02 --last_time 1
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.solver.simulate3d import advance_3d


def main(argv=None):
    args = parse_args_3d(argv, default_max_epoch=20000)
    return advance_3d(args.init_cond, args.dir, args.dt, args.last_time,
                      start_frame=args.start_frame,
                      max_epoch=args.max_epoch,
                      boundary_lambda=args.boundary, seed=args.seed,
                      viz=not args.no_viz,
                      target_grid_res=args.target_grid, device=args.device)


if __name__ == "__main__":
    main()
