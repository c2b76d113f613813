"""2D initial fitting entry point.

    python -m gaussian_fluids_torch.initialize2d --init_cond leapfrog --dir D
"""

from gaussian_fluids_torch.cli import parse_args_2d
from gaussian_fluids_torch.solver.simulate2d import initialize_2d
from gaussian_fluids_torch.utils.profiling import maybe_trace


def main(argv=None):
    args = parse_args_2d(argv, default_max_epoch=10000)
    with maybe_trace(args.profile, args.device):
        return initialize_2d(args.init_cond, args.dir, max_epoch=args.max_epoch,
                             seed=args.seed, viz=not args.no_viz,
                             device=args.device)


if __name__ == "__main__":
    main()
