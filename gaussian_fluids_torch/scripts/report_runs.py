"""One line per production run directory, the JAX package's
``scripts/report_runs.py`` on the port: the frames, the growth of N
(first -> peak (frame) -> last, from each checkpoint's ``positions``)
and the per-frame wall-clock from checkpoint mtimes, without the deltas
under 1 s (a restored copy's shared mtime) and those of 5x the median
or more (a restart of the run). Reads files only, on the host.

With ``--frames``, it reads advance logs instead (a step's log of
``production``): per frame the ``[frame k]`` line's seconds and its
clone / advect / project / viz / save split, the epochs of each phase
(``[clone] Total epoch``, ``[projection] Total epoch``) and whether
patience stopped it, and N, summarised in one line a log.

Usage: python -m gaussian_fluids_torch.scripts.report_runs [dir ...]
       (default: every output_* directory of the current one)
       python -m gaussian_fluids_torch.scripts.report_runs --frames LOG ...
"""
import glob
import os
import re
import sys

import numpy as np
import torch

from gaussian_fluids_torch.scripts import _runs


def checkpoint_n(path) -> int:
    d = torch.load(path, map_location="cpu", weights_only=False)
    return int(d["positions"].shape[0])


def report(run_dir):
    frames = _runs.frames(run_dir)
    if not frames:
        return None
    ks = list(frames)
    ns = {k: checkpoint_n(f) for k, f in frames.items()}
    k_peak = max(ks, key=lambda k: (ns[k], -k))
    # a gap in the frame numbers is one delta, as in the JAX script
    dt = _runs.frame_seconds(frames, lambda d: d >= 1.0, consecutive=False)
    if dt.size:
        dt = dt[dt < 5 * np.median(dt)]
    wall = (f"median {np.median(dt):.1f} s, p10 {np.percentile(dt, 10):.1f},"
            f" p90 {np.percentile(dt, 90):.1f} (n={dt.size})"
            if dt.size else "n/a")
    return (f"{run_dir}: frames {ks[0]}..{ks[-1]} ({len(ks)} ckpts), "
            f"N {ns[ks[0]]} -> peak {ns[k_peak]} (frame {k_peak}) -> "
            f"{ns[ks[-1]]}, per-frame wall {wall}")


_FRAME = re.compile(
    r"\[frame (\d+)\] solve ([\d.]+)s \(clone ([\d.]+) advect ([\d.]+) "
    r"project ([\d.]+)\) viz ([\d.]+)s save ([\d.]+)s \(N=(\d+)/(\d+)\)")
_TOTAL = re.compile(r"\[(clone|projection)\] Total epoch: (\d+)( \(Reached)?")
_DIV = re.compile(r"\[projection\] .*loss_div: ([^,]+), loss_div_max: ([^,]+)")


def frame_records(log) -> list:
    """One dict a ``[frame k]`` line of an advance log: its seconds, their
    split, N, capacity, each phase's epochs and patience stop (None where
    the phase ran no loop, as the 3D clone when nothing splits) and the
    projection's last test ``loss_div`` (the mean squared divergence on
    its test grid) and ``loss_div_max``."""
    out, phases, div = [], {}, (None, None)
    with open(log, errors="replace") as fh:
        for ln in fh:
            m = _TOTAL.search(ln)
            if m:
                phases[m.group(1)] = (int(m.group(2)), m.group(3) is None)
                continue
            m = _DIV.search(ln)
            if m:
                div = (float(m.group(1)), float(m.group(2)))
                continue
            m = _FRAME.search(ln)
            if m:
                g = m.groups()
                rec = dict(zip(("solve", "clone", "advect", "project", "viz",
                                "save"), map(float, g[1:7])))
                rec.update(frame=int(g[0]), n=int(g[7]), capacity=int(g[8]),
                           seconds=rec["solve"] + rec["viz"] + rec["save"],
                           clone_epochs=phases.get("clone"),
                           project_epochs=phases.get("projection"),
                           loss_div=div[0], loss_div_max=div[1])
                out.append(rec)
                phases, div = {}, (None, None)
    return out


def _stats(xs) -> str:
    return (f"median {np.median(xs):.1f}, p10 {np.percentile(xs, 10):.1f}, "
            f"p90 {np.percentile(xs, 90):.1f}")


def frame_summary(log):
    recs = frame_records(log)
    if not recs:
        return None
    sec = [r["seconds"] for r in recs]
    parts = [f"{log}: frames {recs[0]['frame']}..{recs[-1]['frame']} "
             f"({len(recs)}), s a frame {_stats(sec)}, first {sec[0]:.1f}, "
             f"last {sec[-1]:.1f}; medians "
             + ", ".join(f"{k} {np.median([r[k] for r in recs]):.1f}"
                         for k in ("clone", "advect", "project", "viz",
                                   "save"))]
    for key, tag in (("clone_epochs", "clone"),
                     ("project_epochs", "projection")):
        ran = [r[key] for r in recs if r[key] is not None]
        if not ran:
            parts.append(f"{tag}: no epochs")
            continue
        ep = [e for e, _ in ran]
        parts.append(f"{tag} epochs {min(ep)}-{max(ep)} (median "
                     f"{np.median(ep):.0f}, {sum(s for _, s in ran)} of "
                     f"{len(ran)} stopped by patience)")
    ms = [1e3 * r["project"] / r["project_epochs"][0] for r in recs
          if r["project_epochs"]]
    if ms:
        parts.append(f"projection ms an epoch {_stats(ms)}")
    div = [r["loss_div"] for r in recs if r["loss_div"] is not None]
    if div:
        parts.append(f"last loss_div {min(div):.3e}-{max(div):.3e}")
    parts.append(f"N {recs[0]['n']} -> {recs[-1]['n']} (capacity "
                 f"{recs[0]['capacity']} -> {recs[-1]['capacity']})")
    return "; ".join(parts)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--frames"]:
        lines = [frame_summary(f) for f in argv[1:]]
    else:
        dirs = argv or sorted(
            d for d in glob.glob("output_*") if os.path.isdir(d))
        lines = [report(d) for d in dirs]
    for line in lines:
        if line:
            print(line)


if __name__ == "__main__":
    main()
