"""2D simulation entry point.

    python -m gaussian_fluids_torch.advance2d --init_cond leapfrog \
        --dir D --dt .025 --last_time 40
"""

from gaussian_fluids_torch.cli import parse_args_2d
from gaussian_fluids_torch.solver.simulate2d import advance_2d


def main(argv=None):
    args = parse_args_2d(argv, default_max_epoch=20000)
    return advance_2d(args.init_cond, args.dir, args.dt, args.last_time,
                      start_frame=args.start_frame,
                      max_epoch=args.max_epoch, seed=args.seed,
                      target_grid_res=args.target_grid, device=args.device)


if __name__ == "__main__":
    main()
