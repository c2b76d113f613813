"""3D initial fitting entry point.

    python -m gaussian_fluids_torch.initialize3d --init_cond ring_collide \
        --dir D --max_epoch 500
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.solver.simulate3d import initialize_3d
from gaussian_fluids_torch.utils.profiling import maybe_trace


def main(argv=None):
    args = parse_args_3d(argv, default_max_epoch=500)
    with maybe_trace(args.profile, args.device):
        return initialize_3d(args.init_cond, args.dir, max_epoch=args.max_epoch,
                             seed=args.seed, viz=not args.no_viz,
                             device=args.device)


if __name__ == "__main__":
    main()
