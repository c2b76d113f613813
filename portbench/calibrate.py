"""The readings the limits of ``correct`` are set from, on the card at the
cell's own size, many seeds in one process.

    python -m portbench.calibrate --workload <name> --seeds 1 2 3 ...
        [--controls 3]

For each seed it prints one JSON line with the program's numbers against
the plain reference (the lower reading: sound runs). For the first
``--controls`` seeds it also prints the control's numbers: the plain
reference in the program's place, its pair arithmetic in bfloat16, the
nearest precision below the configuration's float32 that changes the
arithmetic (the field runs no matrix product that TF32 would touch);
and, for a training cell, the reference with half of each batch left out
(the mean taken over the rest). A state left unchanged reads 1 on the
step gap by construction and needs no run. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import compare, harness  # noqa: E402
from portbench.reference import replay as ref_replay  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def project_readings(cell, seeds, controls, dev):
    """One set-up; for each seed one timed call on each frame, as the
    window makes them, against the reference of that frame."""
    from portbench.drivers.project import Driver
    drv = Driver(cell, seeds[0], dev)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        drv.seed, drv.records = seed, []
        for c in range(drv.cycle):
            drv.call(c)
        drv.synchronize()
        emit(seed=seed, side="program", numbers=drv.check(),
             calls=[[f, rec] for f, _, rec in drv.records],
             seconds=time.perf_counter() - t0)
        if i < controls:
            base = {f: drv.reference_steps(f) for f in drv.frames}
            for side, kw in (("control_bf16", {"pair_dtype": torch.bfloat16}),
                             ("fault_half_batch", {"half_batch": True})):
                gaps = [compare.training_gaps(drv.reference_steps(f, **kw),
                                              base[f]) for f in drv.frames]
                emit(seed=seed, side=side,
                     numbers={k: max(g[k] for g in gaps) for k in gaps[0]},
                     frames=gaps)


def replay_readings(cell, seeds, controls, dev):
    from portbench.drivers.replay import Driver
    drv = Driver(cell, seeds[0], dev)
    outs = {}
    from gaussian_fluids_torch.solver import simulate3d
    for j, f in drv.order:
        mix, spec, band = drv.mixes[f]
        outs[(j, f)] = simulate3d.advected_density(
            drv.densities[j], mix, spec, drv.domain, drv.dt, drv.grid,
            chunk=drv.chunk, band=band).reshape(-1)
    drv.release()
    tr = cell.traffic
    for i, seed in enumerate(seeds):
        nodes = ref_replay.sample_nodes(drv.densities,
                                        int(tr["check_nodes"]), seed,
                                        int(tr["check_margin"])).to(dev)
        for side, dtype in (("program", torch.float32),
                            ("control_bf16", torch.bfloat16)):
            if side != "program" and i >= controls:
                continue
            gap = 0.0
            for (j, f), out in outs.items():
                base = ref_replay.step_at(drv.frame_path(f),
                                          drv.densities[j], nodes,
                                          drv.domain, drv.dt)
                got = out[nodes] if side == "program" else \
                    ref_replay.step_at(drv.frame_path(f), drv.densities[j],
                                       nodes, drv.domain, drv.dt, dtype)
                gap = max(gap, compare.density_gap(got, base))
            emit(seed=seed, side=side, numbers={"density_gap": gap})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.require_cards(1)
    dev = torch.device("cuda")
    cell = harness.find_cell(args.workload)
    emit(workload=cell.name, card=torch.cuda.get_device_name(dev),
         power_limit=harness.power_limit())
    if cell.traffic["kind"] == "project":
        project_readings(cell, args.seeds, args.controls, dev)
    else:
        replay_readings(cell, args.seeds, args.controls, dev)


if __name__ == "__main__":
    main()
