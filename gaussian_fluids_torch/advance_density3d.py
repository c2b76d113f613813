"""Offline smoke-density replay entry point: advects the scene's ring
densities through the saved velocity checkpoints of a 3D run and writes
``density_{tag}_{frame}.vti`` volumes with their pooled ``.npz`` twins.

    python -m gaussian_fluids_torch.advance_density3d \
        --init_cond ring_collide --dt .02 --dir D [--density_res_multiplier 4]

The grid is the scene's ``visualize_res`` times the multiplier (512^3 for
ring_collide by default). Runs on the card unless ``--device cpu``;
``--mesh BxG`` shards each step over B x G ranks (``parallel/density.py``);
``--profile DIR`` traces the replay (under ``--mesh`` each rank into
``DIR/rank{r}/``).
"""

from gaussian_fluids_torch.cli import parse_args_3d
from gaussian_fluids_torch.parallel.mesh import launch, mesh_from_shape
from gaussian_fluids_torch.solver.simulate3d import advance_density
from gaussian_fluids_torch.utils.profiling import maybe_trace, rank_dir


def _rank_main(mesh, args, kwargs, profile=None):
    with maybe_trace(rank_dir(profile, mesh.rank), mesh.device):
        return advance_density(*args, **kwargs, mesh=mesh)


def main(argv=None):
    args = parse_args_3d(argv)
    run = (args.init_cond, args.dir, args.dt)
    kwargs = dict(res_multiplier=args.density_res_multiplier,
                  start_frame=args.start_frame)
    if args.mesh:
        shape = mesh_from_shape(args.mesh, device=args.device)
        # each rank traces itself, the launching process nothing
        return launch(_rank_main, shape, (run, kwargs, args.profile),
                      device=args.device)[0]
    with maybe_trace(args.profile, args.device):
        return advance_density(*run, **kwargs, device=args.device)


if __name__ == "__main__":
    main()
