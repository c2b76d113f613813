"""The traced part of a run: ``torch.profiler`` over the driver's first
``trace_calls`` calls, and the benchmark's own need counts.

From the profiler's raw events it keeps the device's operations (name,
start, end: kernels, copies, fills), the number of host operators the
program dispatched itself (``aten::`` operators inside no other
``aten::`` operator on their thread) and the host's ``aten::`` operators
and the benchmark's spans (``portbench.*``, recorded only around the
calls it makes into the port) by time, which name the device's idle gaps.

A need probe wraps one of the port's kernel entry points while the traced
part runs and keeps, per call, the shapes and a few whole calls' inputs;
afterwards the pairs inside the support are counted on a sample of each
kept call's queries, and each call's least time on need (its inputs read
once, its outputs written once, the support pairs' operations) is summed
per probe. The probe does no device work while the trace runs.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import re
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from portbench import frozen

KEPT_CALLS = 4          # calls whose inputs a probe keeps, per call shape
SAMPLE_ROWS = 256       # query rows of a kept call whose support is counted


class Summary:
    """What the per-layer readers read."""

    def __init__(self, window_s: float, units: int, device: List[tuple],
                 host_ops: int, host_spans: List[tuple],
                 needs: Dict[tuple, float]):
        self.window_s = window_s
        self.units = units
        self.device = device            # [(name, start_s, end_s)]
        self.host_ops = host_ops
        self.host_spans = host_spans    # [(name, start_s, end_s, depth)]
        self.needs = needs              # {(module, function): least s}
        self.unit_seconds: Optional[float] = None
        self.flops_per_unit: Optional[float] = None
        self.busy_s = busy_seconds(device)

    def device_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n))

    def launches(self) -> int:
        return len(self.device)

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the traced window."""
        out, t = [], 0.0
        for s, e in union(self.device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for n, s, e in self.device:
            by_op[short(n)] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        by_host = defaultdict(float)
        gaps = self.gaps()
        names = host_at(self.host_spans, [0.5 * (s + e) for s, e in gaps])
        for (s, e), name in zip(gaps, names):
            by_host[name] += e - s
        top = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in top]}


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 letters."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if name[:i].strip():
                    name = name[:i].strip()
                break
    return name[:120]


def union(events) -> List[Tuple[float, float]]:
    iv = sorted((s, e) for _, s, e in events)
    out: List[List[float]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events) -> float:
    return sum(e - s for s, e in union(events))


def host_at(spans, times) -> List[str]:
    """For each of the ascending ``times``, the innermost host span
    running then (an ``aten::`` operator or the benchmark's span around a
    call), else the Python between operators: one sweep over the spans,
    sorted by start, holding the open ones on a stack."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else
                   "host: Python between operators")
    return out


SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.traced"


def summarize(prof, units: int, needs) -> Summary:
    """A ``Summary`` from the profiler's raw events, times in seconds from
    the start of the benchmark's span around the traced calls, which sets
    the window. The benchmark's spans also appear on the device's
    timeline as annotations; they are no device work and are left out.
    Host operators are counted as ``epoch_profile`` counts them: an
    ``aten::`` operator is the program's own dispatch where no recorded
    event holds it but the benchmark's spans (the autograd engine's
    backward operators sit inside its ``evaluate_function`` events)."""
    events = prof.profiler.kineto_results.events()
    win = [ev for ev in events if ev.name() == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    t0_ns = min(ev.start_ns() for ev in win)
    window_ns = max(ev.start_ns() + ev.duration_ns() for ev in win) - t0_ns
    device, host = [], []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for ev in events:
        name = ev.name()
        if name.startswith(SPAN_PREFIX) and ev.device_type() != cpu:
            continue
        s = (ev.start_ns() - t0_ns) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if e < 0.0 or s > window_ns * 1e-9:
            continue
        dt = ev.device_type()
        if dt == cuda and not ev.is_user_annotation():
            device.append((name, s, e))
        elif dt == cpu and name != WINDOW_SPAN:
            host.append((name, s, e, ev.start_thread_id()))
    host.sort(key=lambda h: (h[3], h[1], -h[2]))
    top_ops = 0
    spans = []
    stacks: Dict[int, list] = defaultdict(list)
    for name, s, e, tid in host:
        stack = stacks[tid]
        while stack and stack[-1][1] <= s:
            stack.pop()
        is_op = name.startswith("aten::")
        is_span = name.startswith(SPAN_PREFIX)
        if is_op and all(st[2] for st in stack):
            top_ops += 1
        if is_op or is_span:
            spans.append((name, s, e, len(stack)))
        stack.append((name, e, is_span))
    spans.sort(key=lambda h: h[1])
    return Summary(window_ns * 1e-9, units, device, top_ops, spans, needs)


class NeedProbe:
    """Wraps ``module.function`` (a kernel entry of the port taking
    ``x``, ``muT``, ``ppT``, ``values``, ``clamp`` and, for a forward
    with Jacobian columns, ``njac``) and records its calls."""

    def __init__(self, module: str, function: str):
        self.key = (module, function)
        self.mod = importlib.import_module(module)
        self.fn = getattr(self.mod, function)
        self.sig = inspect.signature(self.fn)
        self.counts: Dict[tuple, int] = defaultdict(int)
        self.kept: Dict[tuple, list] = defaultdict(list)

    def __enter__(self):
        fn, sig = self.fn, self.sig

        def probe(*args, **kwargs):
            a = sig.bind(*args, **kwargs).arguments
            x = a["x"]
            b = int(a["nvalid"]) if a.get("nvalid") is not None \
                else x.shape[0]
            shape = (b, x.shape[1], a["muT"].shape[1], a["values"].shape[1],
                     int(a.get("njac", 0)))
            self.counts[shape] += 1
            if len(self.kept[shape]) < KEPT_CALLS:
                self.kept[shape].append((x, b, a["muT"], a["ppT"],
                                         float(a["clamp"])))
            return fn(*args, **kwargs)

        setattr(self.mod, self.fn.__name__, probe)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.fn.__name__, self.fn)
        return False

    @torch.no_grad()
    def least_seconds(self) -> Optional[float]:
        """The recorded calls' least time on need, summed."""
        if not self.counts:
            return None
        total = 0.0
        for shape, count in self.counts.items():
            _, _, _, vdim, njac = shape
            per = [call_least(x[:b], muT, ppT, clamp, vdim, njac)
                   for x, b, muT, ppT, clamp in self.kept[shape]]
            total += count * sum(per) / len(per)
        return total


def call_least(x, muT, ppT, clamp: float, vdim: int, njac: int) -> float:
    """One call's least seconds on need: the support pairs counted on a
    sample of its query rows, each paying a forward pair's operations;
    the queries and the live Gaussians' positions, precisions and values
    read once, the outputs written once."""
    b, d = x.shape
    npk = d * (d + 1) // 2
    live = ppT[npk] < 1e8
    mu = muT[:, live]
    pp = ppT[:npk, live]
    n_live = int(live.sum())
    rows = x[torch.linspace(0, b - 1, min(b, SAMPLE_ROWS),
                            device=x.device).long()]
    delta = [rows[:, k, None] - mu[k][None, :] for k in range(d)]
    quad = sum(pp[k] * delta[k] * delta[k] for k in range(d))
    off = [(i, j) for i in range(d) for j in range(i + 1, d)]
    for c, (i, j) in enumerate(off):
        quad = quad + 2.0 * pp[d + c] * delta[i] * delta[j]
    hits = int((torch.exp(-0.5 * quad) >= clamp).sum())
    pairs = hits * b / rows.shape[0]
    ops = pairs * frozen.fwd_flops_per_pair(d, vdim, njac)
    nbytes = 4 * (b * d + n_live * (d + npk + vdim)
                  + b * (1 + njac) * vdim)
    return frozen.least_seconds(ops, nbytes)


def traced(drv, probes) -> Summary:
    """The driver's first ``trace_calls`` calls under the profiler, with
    the need probes installed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    n = int(drv.tr.get("trace_calls", drv.cycle))
    acts = [ProfilerActivity.CPU]
    if drv.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ps = [NeedProbe(m, f) for m, f in dict.fromkeys(probes)]
    units = 0
    drv.synchronize()
    with profile(activities=acts) as prof, contextlib.ExitStack() as stack:
        for p in ps:
            stack.enter_context(p)
        with record_function(WINDOW_SPAN):
            for i in range(n):
                units += drv.call(i)
            drv.synchronize()
        t = time.perf_counter()
    print(f"portbench: the profiler stopped in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    t = time.perf_counter()
    needs = {p.key: p.least_seconds() for p in ps}
    out = summarize(prof, units, needs)
    print(f"portbench: traced {units} {drv.unit}s, {len(out.device)} device "
          f"operations, read in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    return out
