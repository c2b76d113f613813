"""Offline smoke-density replay entry point: advects the scene's ring
densities through the saved velocity checkpoints of a 3D run and writes
``density_{tag}_{frame}.vti`` volumes with their pooled ``.npz`` twins.

    python -m gaussian_fluids_torch.advance_density3d \
        --init_cond ring_collide --dt .02 --dir D [--density_res_multiplier 4]

The grid is the scene's ``visualize_res`` times the multiplier (512^3 for
ring_collide by default). Runs on the card unless ``--device cpu``.
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.solver.simulate3d import advance_density


def main(argv=None):
    args = parse_args_3d(argv)
    return advance_density(args.init_cond, args.dir, args.dt,
                           res_multiplier=args.density_res_multiplier,
                           start_frame=args.start_frame, device=args.device)


if __name__ == "__main__":
    main()
