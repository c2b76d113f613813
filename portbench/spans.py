"""The port's own spans and counters (``gf.*``, ``gaussian_fluids_torch/
utils/profiling.py``) read from a traced part of a cell:

    python -m portbench.spans --workload <name> --seed <n> [--calls k]

runs the cell's set-up (as a run of the harness does), then
``k`` calls (the traffic's ``trace_calls`` by default) under
``torch.profiler`` with the port's ``counting()`` open, so that the port
keeps its spans and counters there, and prints one JSON line: the
accepted per-layer readings of the cell read from this trace, the
readings below, the idle time and the sort kernels by port span, and the
fallback counters' deltas. A program without the spans reads as the
harness's traced part reads it; the readings below are then absent.

``summarize`` is ``tracing.summarize`` with the port's spans taken as the
benchmark's own: an ``aten::`` operator inside a ``gf.*`` span is still
the program's own dispatch, and a span's annotation on the device's
timeline is no device operation. So ``host_ops`` and ``launches()`` read
the same with and without the spans. Beside it the ``SpanSummary`` keeps
the ``gf.*`` host spans and, for each device operation, the ``gf.*``
spans open, on any thread, when its launch was made (the runtime call
that holds its correlation id).

The readings (host milliseconds of a span are the union of its
intervals, over the units; under the profiler, whose own cost they
include):

  optim_host_ms_per_epoch       gf.epoch.pcgrad and gf.epoch.adam
  heads_host_ms_per_epoch       gf.epoch.heads
  worklist_sort_ms_per_epoch    device ms of sort kernels launched inside
                                gf.field.work_lists
  cells_live_tile_pct           the forward work lists' live tiles over
                                their R x C, counted inside gf.epoch.heads
  band_window_host_ms_per_step  gf.replay.band_window
  trilinear_host_ms_per_step    gf.replay.trilinear
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from portbench import tracing

PREFIXES = ("portbench.", "gf.")
GF = "gf."
SORTS = r"(?i)radix|sort"
# the CUDA API calls that put work on the device (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...); the device operation carries the
# same correlation id
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
OUTSIDE = "host: Python between operators"


class SpanSummary(tracing.Summary):
    """A ``tracing.Summary`` with the port's spans: ``gf_spans``
    [(name, start_s, end_s)], ``device_spans`` (per device operation,
    the gf.* spans open at its launch, outermost first) and ``counts``
    (the ``counting()`` scope's ``Counts``, or None)."""

    def __init__(self, *args, gf_spans=(), device_spans=None,
                 counts=None, **kw):
        super().__init__(*args, **kw)
        self.gf_spans = sorted(gf_spans, key=lambda h: (h[1], -h[2]))
        self.device_spans = list(device_spans) if device_spans \
            is not None else [()] * len(self.device)
        self.counts = counts

    def span_seconds(self, *names) -> float:
        """Host seconds in which any of the named spans was open."""
        return tracing.busy_seconds(h for h in self.gf_spans
                                    if h[0] in names)

    def device_seconds_in(self, pattern: str, span: str) -> float:
        """Device seconds of the operations whose name matches and
        whose launch was made inside ``span``."""
        rx = re.compile(pattern)
        return sum(e - s for (n, s, e), sp in
                   zip(self.device, self.device_spans)
                   if span in sp and rx.search(n))

    def device_seconds_by_span(self, pattern: str) -> Dict[str, float]:
        """Device seconds of the matching operations by the spans open at
        their launch, joined by '/'."""
        rx = re.compile(pattern)
        out = defaultdict(float)
        for (n, s, e), sp in zip(self.device, self.device_spans):
            if rx.search(n):
                out["/".join(sp) or "(no gf span)"] += e - s
        return dict(out)

    def gap_spans(self) -> List[Optional[str]]:
        """The innermost gf.* span open at each idle gap's middle."""
        names = tracing.host_at(self.gf_spans, [0.5 * (s + e) for s, e
                                                in self.gaps()])
        return [None if n == OUTSIDE else n for n in names]

    def idle_by_span(self) -> Dict[str, float]:
        out = defaultdict(float)
        for (s, e), sp in zip(self.gaps(), self.gap_spans()):
            out[sp or "(no gf span)"] += e - s
        return dict(out)

    def idle_in_spans(self) -> Optional[float]:
        """The share of the window's idle time inside some gf.* span:
        each gap cut to the union of the spans."""
        gaps = self.gaps()
        idle = sum(e - s for s, e in gaps)
        if idle <= 0 or not self.gf_spans:
            return None
        cover = tracing.union(self.gf_spans)
        inside, j = 0.0, 0
        for s, e in gaps:
            while j < len(cover) and cover[j][1] <= s:
                j += 1
            k = j
            while k < len(cover) and cover[k][0] < e:
                inside += min(e, cover[k][1]) - max(s, cover[k][0])
                k += 1
        return inside / idle

    def breakdown(self) -> dict:
        """``tracing.Summary.breakdown`` with each idle gap inside a
        port span named by that span and the operator in it
        (``gf.epoch.adam: aten::mul``, ``gf.epoch.heads: Python``);
        a gap outside every port span keeps its name."""
        out = super().breakdown()
        gaps = self.gaps()
        mids = [0.5 * (s + e) for s, e in gaps]
        ops = tracing.host_at([h for h in self.host_spans
                               if h[0].startswith("aten::")], mids)
        base = tracing.host_at(self.host_spans, mids)
        by = defaultdict(float)
        for (s, e), sp, op, b in zip(gaps, self.gap_spans(), ops, base):
            name = b if sp is None else \
                f"{sp}: {'Python' if op == OUTSIDE else op}"
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        out["idle_gaps"] = [[n, v] for n, v in top]
        return out


def open_at(spans, times) -> List[tuple]:
    """For each time (any order), the names of ``spans`` [(name, start,
    end)] open then, outermost first: one sweep in time order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    spans = sorted(spans, key=lambda h: (h[1], -h[2]))
    out: List[tuple] = [()] * len(times)
    stack, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][1] <= t:
            stack.append(spans[i])
            i += 1
        stack = [h for h in stack if h[2] >= t]
        out[k] = tuple(h[0] for h in stack)
    return out


def summarize(prof, units: int, needs, counts=None):
    """A ``SpanSummary`` from the profiler's raw events (see the module's
    note); times in seconds from the start of the benchmark's window
    span, as ``tracing.summarize``."""
    events = prof.profiler.kineto_results.events()
    win = [ev for ev in events if ev.name() == tracing.WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {tracing.WINDOW_SPAN} span")
    t0_ns = min(ev.start_ns() for ev in win)
    window_ns = max(ev.start_ns() + ev.duration_ns() for ev in win) - t0_ns
    device, corr, host, launches = [], [], [], {}
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for ev in events:
        name = ev.name()
        if name.startswith(PREFIXES) and ev.device_type() != cpu:
            continue
        s = (ev.start_ns() - t0_ns) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if e < 0.0 or s > window_ns * 1e-9:
            continue
        dt = ev.device_type()
        if dt == cuda and not ev.is_user_annotation():
            device.append((name, s, e))
            corr.append(ev.correlation_id())
        elif dt == cpu and name != tracing.WINDOW_SPAN:
            host.append((name, s, e, ev.start_thread_id()))
            if RUNTIME.match(name):
                launches[ev.correlation_id()] = s
    host.sort(key=lambda h: (h[3], h[1], -h[2]))
    top_ops = 0
    spans, gf = [], []
    stacks: Dict[int, list] = defaultdict(list)
    for name, s, e, tid in host:
        stack = stacks[tid]
        while stack and stack[-1][1] <= s:
            stack.pop()
        is_op = name.startswith("aten::")
        is_span = name.startswith(PREFIXES)
        if is_op and all(st[2] for st in stack):
            top_ops += 1
        if is_op or (is_span and not name.startswith(GF)):
            spans.append((name, s, e, len(stack)))
        if name.startswith(GF):
            gf.append((name, s, e))
        stack.append((name, e, is_span))
    spans.sort(key=lambda h: h[1])
    at = [launches.get(c) for c in corr]
    known = [i for i, t in enumerate(at) if t is not None]
    dev_spans: List[tuple] = [()] * len(device)
    for i, path in zip(known, open_at(gf, [at[i] for i in known])):
        dev_spans[i] = path
    return SpanSummary(window_ns * 1e-9, units, device, top_ops,
                                spans, needs, gf_spans=gf,
                                device_spans=dev_spans, counts=counts)


# ---- the readings ----

def _host_ms(s, *names) -> Optional[float]:
    if not s.units or not any(n in names for n, _, _ in s.gf_spans):
        return None
    return 1e3 * s.span_seconds(*names) / s.units


def optim_host_ms_per_epoch(s) -> Optional[float]:
    return _host_ms(s, "gf.epoch.pcgrad", "gf.epoch.adam")


def heads_host_ms_per_epoch(s) -> Optional[float]:
    return _host_ms(s, "gf.epoch.heads")


def band_window_host_ms_per_step(s) -> Optional[float]:
    return _host_ms(s, "gf.replay.band_window")


def trilinear_host_ms_per_step(s) -> Optional[float]:
    return _host_ms(s, "gf.replay.trilinear")


def worklist_sort_ms_per_epoch(s) -> Optional[float]:
    if not s.units or not any("gf.field.work_lists" in sp
                              for sp in s.device_spans):
        return None
    return 1e3 * s.device_seconds_in(SORTS, "gf.field.work_lists") / s.units


def cells_live_tile_pct(s) -> Optional[float]:
    if s.counts is None:
        return None
    live, tiles, _ = s.counts.sums("cells_live_tiles", "gf.epoch.heads")
    return 100.0 * live / tiles if tiles else None


READINGS = {
    "optim_host_ms_per_epoch.project3d": optim_host_ms_per_epoch,
    "heads_host_ms_per_epoch.project3d": heads_host_ms_per_epoch,
    "worklist_sort_ms_per_epoch.project3d": worklist_sort_ms_per_epoch,
    "cells_live_tile_pct.project3d": cells_live_tile_pct,
    "band_window_host_ms_per_step.replay512": band_window_host_ms_per_step,
    "trilinear_host_ms_per_step.replay512": trilinear_host_ms_per_step,
}


# ---- a traced part with the port's spans ----

def counting_scope():
    """The port's ``counting()``, or nothing where the program has none."""
    from gaussian_fluids_torch.utils import profiling
    fn = getattr(profiling, "counting", None)
    return fn() if fn is not None else contextlib.nullcontext()


def traced(drv, calls: int, probes=()):
    """The cell's first ``calls`` calls under the profiler, the port's
    counters and spans on, the need probes installed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if drv.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ps = [tracing.NeedProbe(m, f) for m, f in dict.fromkeys(probes)]
    units = 0
    drv.synchronize()
    with counting_scope() as counts:
        with profile(activities=acts) as prof, \
                contextlib.ExitStack() as stack:
            for p in ps:
                stack.enter_context(p)
            t = time.perf_counter()
            with record_function(tracing.WINDOW_SPAN):
                for i in range(calls):
                    units += drv.call(i)
                drv.synchronize()
            wall = time.perf_counter() - t
    needs = {p.key: p.least_seconds() for p in ps}
    out = summarize(prof, units, needs, counts)
    out.traced_wall_s = wall
    return out


def report(s, cell_metrics) -> dict:
    from portbench import harness
    existing = {}
    for m in cell_metrics:
        v = harness.reader("per_layer", m["name"]).read(s)
        if v is not None:
            existing[m["name"]] = v
    per = 1e3 / s.units if s.units else float("nan")
    names = sorted({n for n, _, _ in s.gf_spans})
    out = {
        "units": s.units, "window_s": s.window_s,
        "traced_wall_s": getattr(s, "traced_wall_s", None),
        "existing": existing,
        "readings": {k: f(s) for k, f in READINGS.items()},
        "idle_in_spans_pct": None if s.idle_in_spans() is None
        else 100.0 * s.idle_in_spans(),
        "idle_ms_per_unit_by_span": sorted(
            ([k, v * per] for k, v in s.idle_by_span().items()),
            key=lambda kv: -kv[1]),
        "sort_ms_per_unit_by_span": sorted(
            ([k, v * per] for k, v in
             s.device_seconds_by_span(SORTS).items()),
            key=lambda kv: -kv[1]),
        "sort_kernels_ms_per_unit": sorted(
            ([tracing.short(k)[:60], v * per] for k, v in
             _device_by_name(s, SORTS).items()), key=lambda kv: -kv[1]),
        "span_host_ms_per_unit": {n: s.span_seconds(n) * per
                                  for n in names},
        "spans_per_unit": len(s.gf_spans) / s.units if s.units else None,
        "breakdown": s.breakdown(),
    }
    if s.counts is not None:
        out["fallbacks"] = dict(s.counts.fallbacks)
        out["counts"] = {name: {"/".join(k): v for k, v in rows.items()}
                         for name, rows in s.counts.totals.items()}
    return out


def _device_by_name(s, pattern):
    rx = re.compile(pattern)
    out = defaultdict(float)
    for n, a, b in s.device:
        if rx.search(n):
            out[n] += b - a
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.spans",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=0)
    args = ap.parse_args(argv)
    from portbench import harness
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    harness.require_cards(cell.chips)
    dev = torch.device("cuda")
    drv = harness.driver_class(cell.traffic["kind"])(cell, args.seed, dev)
    calls = args.calls or int(drv.tr.get("trace_calls", drv.cycle))
    probes = [tuple(p) for m in cell.per_layer
              for p in getattr(harness.reader("per_layer", m["name"]),
                               "PROBES", ())]
    s = traced(drv, calls, probes)
    out = report(s, cell.per_layer)
    out["workload"], out["seed"] = args.workload, args.seed
    fb = out.get("fallbacks")
    print(f"portbench.spans: {args.workload}: idle inside gf spans "
          f"{out['idle_in_spans_pct']}%, fallbacks {fb}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
