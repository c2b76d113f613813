"""The benchmark's harness: one run of one cell.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace 0|1

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (the file the manifest gives)
and its traffic mix (``portbench/traffic/<traffic>.json``, whose
``kind`` picks the driver in ``portbench/drivers/``); each end-to-end
metric is read by ``portbench/end_to_end/<name>.py`` and each per-layer
metric by ``portbench/per_layer/<name>.py``; the limits of the check
that decides ``correct`` are ``portbench/limits/<workload>.json``.

A run: set-up (the driver loads its inputs and warms the cell's shapes),
then the window: the driver's calls, each synchronised and each keeping
what the check compares, until ``--seconds`` have passed and a whole
cycle of the traffic's calls is done. With ``--trace 1`` a bounded
traced part follows, under ``torch.profiler``. Then the peak memory is
read, the program's state freed, the plain reference run and compared.
The last line on standard output is the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_fluids_tpu")


class RunError(RuntimeError):
    """A run that cannot produce a result: it exits non-zero."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


@dataclass
class Window:
    """What the window measured: the host clock from process start to
    the first timed call (``setup_s``) and over the window (``seconds``),
    and the units of work (epochs, density steps) it completed."""
    setup_s: float
    seconds: float
    units: int
    calls: int
    unit: str
    call_seconds: List[float] = dc_field(default_factory=list)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _lists(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(workload: str, manifest: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, traffic, metrics and
    limits, each found by name."""
    manifest = manifest or load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(PKG / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _lists(m, workload, reported)]
    lim_path = PKG / "limits" / f"{workload}.json"
    limits = {}
    if lim_path.exists():
        with open(lim_path) as f:
            limits = json.load(f)
    return Cell(workload, config, traffic, int(w.get("chips", 1)), e2e,
                layer, limits)


def load_module(path: Path):
    """A reader file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_reader_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    path = PKG / kind / f"{name}.py"
    if not path.exists():
        raise RunError(f"no reader {path.relative_to(ROOT)} for {name!r}")
    return load_module(path)


def driver_class(kind: str):
    mod = importlib.import_module(f"portbench.drivers.{kind}")
    return mod.Driver


def require_cards(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card "
                       "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards; "
                       f"{torch.cuda.device_count()} visible")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_window(drv, seconds: float, t_start: float) -> Window:
    """The driver's calls until ``seconds`` have passed and a whole cycle
    of calls is done; each call is synchronised, so the clock covers all
    its work."""
    setup_s = time.perf_counter() - t_start
    t0 = t = time.perf_counter()
    units = calls = 0
    each = []
    while True:
        units += drv.call(calls)
        drv.synchronize()
        calls += 1
        each.append(time.perf_counter() - t)
        t = time.perf_counter()
        if calls % drv.cycle == 0 and t - t0 >= seconds:
            break
    return Window(setup_s, t - t0, units, calls, drv.unit, each)


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit. A number the
    driver did not give, one with no limit, or one that is not finite,
    fails."""
    out = {}
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        ok = lim is not None and math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim, "ok": ok}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, require_card: bool = True,
        device: Optional[str] = None) -> dict:
    """One run of ``cell``; returns the result's fields."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if require_card:
        require_cards(cell.chips)
    dev = torch.device(device or "cuda")
    print(f"portbench: torch imported and the card found "
          f"{time.perf_counter() - t_start:.2f} s after start",
          file=sys.stderr)
    drv = driver_class(cell.traffic["kind"])(cell, seed, dev)
    win = run_window(drv, seconds, t_start)
    summary = None
    if trace:
        from portbench import tracing
        probes = [tuple(p) for m in cell.per_layer
                  for p in getattr(reader("per_layer", m["name"]),
                                   "PROBES", ())]
        summary = tracing.traced(drv, probes)
        summary.unit_seconds = win.seconds / win.units
        summary.flops_per_unit = drv.flops_per_unit()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    drv.release()
    t = time.perf_counter()
    numbers = drv.check()
    print(f"portbench: the reference and the comparison took "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    checks = judge(numbers, cell.limits)
    correct = all(c["ok"] for c in checks.values()) and bool(checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader("per_layer", m["name"]).read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": reader("end_to_end", m["name"])
                               .read(win), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    result = {"correct": correct, "attempted": win.units,
              "failed": drv.failed(checks), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["window"] = {"seconds": win.seconds, "units": win.units,
                        "calls": win.calls, "unit": win.unit,
                        "setup_s": win.setup_s,
                        "call_seconds": win.call_seconds}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m portbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(2)   # one process, few threads: a steadier host
    try:
        cell = find_cell(args.workload)
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the benchmark "
              f"and the port may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
