"""The Karman-2D covector target with the fused RK4 kernel, timed in two
checkouts of the repo alternately in one run.

    python -m gaussian_fluids_torch.covector_ab --trees A B
        [--rounds 2] [--calls 300]

Each round starts one process per checkout in the order A, B, B, A. A
process imports the port from its checkout, builds the seeded Karman-2D
state (``utils.seeded_state.karman_state``: 24,576 rows, 512 queries
sorted along x) and calls ``solver.covector.advected_vorticity_2d`` under
``GF_FUSED_RK4=1`` over one step of the 2D CLI's default dt: the median
wall milliseconds of ``--calls`` calls with a synchronise after each, and
from ``torch.profiler`` over 10 calls the device milliseconds, host
operators and device launches a call (``epoch_profile.profile_epoch``).
Prints one JSON line per process, one summary line with each checkout's
median over its processes, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

KARMAN_DT = 0.01             # the 2D CLI's default


def worker(calls: int, dt: float) -> dict:
    """One checkout's numbers; imports the port from the working
    directory."""
    import time

    import torch

    from gaussian_fluids_torch.epoch_profile import profile_epoch
    from gaussian_fluids_torch.ops import rk4_fused
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import covector
    from gaussian_fluids_torch.utils.seeded_state import karman_state

    os.environ["GF_FUSED_RK4"] = "1"
    dev = torch.device("cuda")
    mix, spec, x = karman_state(dev)
    scene = get_scene_2d("karman")
    adv, sf = scene.advance_domain_at(1, dt), scene.scaling_factor
    lo = torch.tensor([adv[0] * sf, adv[2] * sf], device=dev)
    hi = torch.tensor([adv[1] * sf, adv[3] * sf], device=dev)

    def target():
        return covector.advected_vorticity_2d(mix, spec, x, dt, lo, hi,
                                              presorted=True)
    rk4_fused.reset_launches()
    out = target()
    if rk4_fused.launches["rk4_fused"] != 1 or not torch.isfinite(out).all():
        raise RuntimeError("the fused covector target did not run the "
                           "fused kernel once, or is not finite")
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t = time.perf_counter()
        target()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    prof = profile_epoch(target, 10)
    return {"wall_ms": statistics.median(walls),
            "device_ms": prof["device_ms_per_epoch"],
            "host_ops": prof["host_ops_per_epoch"],
            "launches": prof["device_launches_per_epoch"]}


def _run(tree: Path, calls: int) -> dict:
    code = (f"import json, runpy; w = runpy.run_path({str(Path(__file__))!r}"
            f", run_name='covector_ab_worker')['worker']; "
            f"print(json.dumps(w({calls}, {KARMAN_DT})))")
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exit {res.returncode}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, type=Path, required=True,
                    metavar=("A", "B"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    runs = {str(t): [] for t in trees}
    for rnd in range(args.rounds):
        for t in (trees[0], trees[1], trees[1], trees[0]):
            r = _run(t, args.calls)
            runs[str(t)].append(r)
            print(json.dumps({"tree": str(t), "round": rnd, **r}),
                  flush=True)
    print(json.dumps({"summary": {
        t: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
        for t, rs in runs.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())


if __name__ == "__main__":
    main()
