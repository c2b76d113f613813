"""The readings the limits of ``karman.project`` are set from, on the card
at the cell's own size, many seeds in one process: ``portbench/calibrate.py``
for a projection cell, with the Karman driver (``drivers/project_karman``).

    python -m portbench.calibrate_karman --seeds 1 2 3 ... [--controls 3]
        [--epochs E]

For each seed one JSON line with the program's numbers against the plain
reference (one timed call on each frame, as the window makes them, or
cut to ``--epochs``: the check reads the first three steps, whose draws
and arithmetic a shorter call leaves as they are); for
the first ``--controls`` seeds also the control's (the reference's pair
arithmetic in bfloat16) and the fault's (the reference with half of each
of its three batches left out) against the reference in float32. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import time

import torch

from portbench import calibrate, compare, harness

WORKLOAD = "karman.project"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.require_cards(1)
    dev = torch.device("cuda")
    cell = harness.find_cell(WORKLOAD)
    calibrate.emit(workload=cell.name, card=torch.cuda.get_device_name(dev),
                   power_limit=harness.power_limit())
    drv = harness.driver_class(cell.traffic["kind"])(cell, args.seeds[0], dev)
    drv.epochs = args.epochs or drv.epochs
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv.seed, drv.records = seed, []
        for c in range(drv.cycle):
            drv.call(c)
        drv.synchronize()
        calibrate.emit(seed=seed, side="program", numbers=drv.check(),
                       calls=[[f, rec] for f, _, rec in drv.records],
                       seconds=time.perf_counter() - t0)
        if i >= args.controls:
            continue
        base = {f: drv.reference_steps(f) for f in drv.frames}
        for side, kw in (("control_bf16", {"pair_dtype": torch.bfloat16}),
                         ("fault_half_batch", {"half_batch": True})):
            gaps = [compare.training_gaps(drv.reference_steps(f, **kw),
                                          base[f]) for f in drv.frames]
            calibrate.emit(seed=seed, side=side,
                           numbers={k: max(g[k] for g in gaps)
                                    for k in gaps[0]}, frames=gaps)


if __name__ == "__main__":
    main()
