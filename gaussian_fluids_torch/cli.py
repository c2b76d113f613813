"""Command-line flags of the entry points — the JAX package's
``cli.parse_args_2d`` / ``parse_args_3d`` flag surface, with the same
defaults. ``--no_viz`` switches off what the JAX CLI draws by default: in
2D the reference figures and every frame's PNGs, in 3D the ``.vti``
volumes and the loss curves ``loss_{n}.png``. Where matplotlib is missing
(the card's machine has none) a run prints one line saying so and draws
no PNG; the volumes and the curves' collection go on
(``io/viz2d.py``). ``--target_grid`` reaches the advance entry points'
clone and projection; the initialize entry points accept it and, as the
JAX CLI's, do not use it. ``--mesh BxG`` runs the advance entry points on
a B x G mesh of ranks (``parallel/``): one GPU each over NCCL, or with
``--device cpu`` B*G gloo processes; the initialize entry points accept
it and, as the JAX CLI's, do not use it. ``--profile DIR`` records a
``torch.profiler`` trace of the run (``utils/profiling.py``).
"""

from __future__ import annotations

import argparse


def _parser(dim: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Gaussian Fluids {dim}D in PyTorch on one NVIDIA GPU. "
                    + ("Draws the JAX CLI's figures (PNG) unless --no_viz."
                       if dim == 2 else
                       "Writes the JAX CLI's .vti volumes and loss_{n}.png "
                       "curves unless --no_viz.")
                    + " Without matplotlib no PNG is drawn, and the run "
                      "says so in one line.")
    p.add_argument("--device", type=str, default="0",
                   help="'cpu' runs on the CPU; an index K runs on "
                        "cuda:K (default: the first GPU)")
    p.add_argument("--dir", type=str,
                   default="output_fast" if dim == 2 else "output_3d")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--init_cond", type=str,
                   default="taylor_vortex" if dim == 2 else "leapfrog",
                   help="scene: taylor_vortex, leapfrog, taylor_green, "
                        "karman, vortices_pass, vortices_pass_narrow, "
                        "vortices_pass_noslip or vortices_pass_particles"
                        if dim == 2 else
                        "scene: leapfrog, single_vortex_ring, "
                        "ring_collide or ring_with_obstacle")
    p.add_argument("--dt", type=float, default=0.01 if dim == 2 else 0.02)
    p.add_argument("--last_time", type=float,
                   default=10.0 if dim == 2 else 100.0)
    if dim == 3:
        p.add_argument("--boundary", type=float, default=10.0)
        p.add_argument("--density_res_multiplier", type=int, default=4,
                       help="density replay grid = visualize_res * this "
                            "(4 gives ring_collide's 512^3)")
    p.add_argument("--target_grid", type=int, default=0,
                   help="cached covector-target grid resolution "
                        "(0 = exact per-epoch RK4 targets, the "
                        "reference behavior; >0 trades target "
                        "accuracy for a much cheaper epoch)")
    p.add_argument("--max_epoch", type=int, default=None,
                   help="override the per-phase epoch budget")
    p.add_argument("--mesh", type=str, default=None,
                   help="'BxG' (or 'B'): run the frame loop or the replay "
                        "on a B x G mesh of ranks, B splitting each batch "
                        "and G the Gaussians; one GPU per rank from "
                        "--device on (NCCL), or B*G processes with "
                        "--device cpu (gloo). Not with --target_grid")
    p.add_argument("--no_viz", action="store_true",
                   help="draw no figures (by default: the reference "
                        "figures and every frame's vorticity, divergence "
                        "and velocity PNGs)"
                        if dim == 2 else
                        "write no .vti volumes and no loss curves (by "
                        "default: the analytic field's four reference "
                        "volumes, every frame's vorticity and divergence, "
                        "and loss_{n}.png)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the run into "
                        "DIR/trace.json (the first GF_PROFILE_SECONDS "
                        "seconds, default 300, 0 = all of it); under "
                        "--mesh each rank traces itself into DIR/rank{r}/ "
                        "and the launching process traces nothing")
    return p


def device_of(flag: str) -> str:
    if flag == "cpu":
        return "cpu"
    return f"cuda:{int(flag)}" if flag.isdigit() else "cuda"


def parse_mesh(s):
    """'BxG' or 'B' -> (n_batch, n_gauss); None/'' -> None (the JAX
    package's ``cli.parse_mesh``)."""
    if not s:
        return None
    parts = s.lower().split("x")
    if len(parts) > 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise SystemExit(f"--mesh expects 'BxG' or 'B' with positive "
                         f"integers, got {s!r}")
    b = int(parts[0])
    g = int(parts[1]) if len(parts) == 2 else 1
    return (b, g)


def _parse(dim, argv, default_max_epoch):
    p = _parser(dim)
    args = p.parse_args(argv)
    if args.max_epoch is None:
        args.max_epoch = default_max_epoch
    args.mesh = parse_mesh(args.mesh)
    args.device = device_of(args.device)
    return args


def parse_args_2d(argv=None, default_max_epoch=20000):
    return _parse(2, argv, default_max_epoch)


def parse_args_3d(argv=None, default_max_epoch=20000):
    return _parse(3, argv, default_max_epoch)
