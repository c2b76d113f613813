"""What the run analyzers share: their arguments, the checkpoints of a
run directory, and the per-frame wall-clock read from checkpoint
mtimes."""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from gaussian_fluids_torch.cli import device_of

_CKPT = re.compile(r"gaussian_velocity_(\d+)\.pt$")


def parse(doc: str, argv, *positionals):
    """The analyzer's arguments: ``positionals`` are (name, type, default)
    in the JAX script's order (a default of ``...`` makes one required),
    then ``--device`` as the entry points take it; ``args.device`` comes
    back as a torch device string."""
    p = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for name, typ, default in positionals:
        if default is ...:
            p.add_argument(name, type=typ)
        else:
            p.add_argument(name, type=typ, nargs="?", default=default)
    p.add_argument("--device", type=str, default="0",
                   help="'cpu' evaluates on the CPU; an index K on cuda:K "
                        "(default: the first GPU)")
    args = p.parse_args(argv)
    args.device = device_of(args.device)
    return args


def frames(run_dir: str) -> dict:
    """{n: path} of the run's ``gaussian_velocity_{n}.pt``, by frame."""
    out = {}
    for f in glob.glob(os.path.join(run_dir, "gaussian_velocity_*.pt")):
        m = _CKPT.search(f)
        if m:
            out[int(m.group(1))] = f
    return dict(sorted(out.items()))


def frame_seconds(all_frames: dict, keep, consecutive: bool = True
                  ) -> np.ndarray:
    """Seconds between consecutive frames' checkpoint mtimes, those for
    which ``keep(delta)`` holds (the scripts drop a restored copy's shared
    mtime and a restart of the run, each at its own thresholds);
    ``consecutive=False`` also takes the delta across a gap in the frame
    numbers, as ``report_runs`` does."""
    ns = sorted(all_frames)
    dts = [os.path.getmtime(all_frames[b]) - os.path.getmtime(all_frames[a])
           for a, b in zip(ns, ns[1:]) if b == a + 1 or not consecutive]
    return np.asarray([d for d in dts if keep(d)])
