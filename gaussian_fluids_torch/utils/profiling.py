"""Profiling: ``--profile DIR`` of the entry points, as the JAX package's
``utils/profiling.py``, and the port's own spans and counters.

  * ``trace(log_dir, limit_s, device)`` records a ``torch.profiler``
    capture (CPU operators, and the card's kernels where the run is on
    a GPU) and writes it as a Chrome trace, ``log_dir/trace.json``;
  * ``maybe_trace(log_dir, device)`` is ``trace`` where a directory is
    given, with the window of ``GF_PROFILE_SECONDS`` (300 s; 0: the
    whole run), else nothing;
  * ``span(name)`` names a phase of the port (every name starts with
    ``gf.``); ``counting()`` turns the counters on (``count``) and
    reduces them when it closes.

The window ends at a chunk boundary, not from a timer thread. The JAX
package stops its capture from a ``threading.Timer``; ``torch.profiler``
ties a capture to the thread that started it, and a stop from another
thread finds none: on an H100 it raises "Can't disable Kineto
profiler when it's not running" and the export then fails, on the CPU
the export crashes. So ``poll()``, which the chunked loops call after
every chunk (``solver/loop.run_chunked``, the fit's log steps, the
replay's frames), stops a capture whose window has passed, in the
thread that started it: a capture ends at most one chunk late.

Spans. A span is kept only while a port capture (``trace``) or a
``counting()`` scope is open; otherwise ``span`` costs one check of a
module integer and returns a shared no-op context: no dispatcher call,
no record, no allocation. Kept, it pushes its name on the thread's stack
of open spans (which a counter reads), and while a ``torch.profiler``
capture runs it is a ``torch.profiler.record_function(name)``, so its
interval sits in the same trace as the card's kernels, on their clock.
A capture opened by another tool records no ``gf.*`` span unless that
tool opens ``counting()``: a reader that counts host operators by what
encloses them sees the trace it always saw.

Counters. Inside ``counting()``, ``count(name, value, total)`` keeps a
reference to ``value``, a device tensor the work computed anyway, with a
host integer ``total``, under the innermost open span; it launches
nothing. When the scope closes (after the window it measured) the values
are summed on the host, and the deltas of the kernels' fallback counters
over the scope are read (``gsr_cells.overflows()``,
``gsr_banded.guard_failures()``). Both synchronise with the card, at the
scope's entry and exit only.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"


class _Capture:
    def __init__(self, log_dir: str, limit_s: float, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self.device = torch.device(device)
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, TRACE_FILE)
        self.deadline = time.monotonic() + limit_s if limit_s > 0 else None
        self.prof = torch.profiler.profile(activities=acts)
        self.open = True
        self.prof.start()
        global _kept
        _kept += 1

    def stop(self):
        """End the capture, once the card has run what was queued, and
        write it."""
        global _kept
        if self.open:
            self.open = False
            _kept -= 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            self.prof.export_chrome_trace(self.path)


_captures: List[_Capture] = []


def poll() -> None:
    """Stop every open capture whose window has passed (called between
    chunks, in the thread that runs the loop)."""
    now = time.monotonic()
    for c in _captures:
        if c.deadline is not None and now >= c.deadline:
            c.stop()


@contextlib.contextmanager
def trace(log_dir: str, limit_s: float = 0, device="cuda"):
    """A ``torch.profiler`` capture of the block into
    ``log_dir/trace.json``: CPU activity, and CUDA activity where
    ``device`` is a GPU. ``limit_s`` > 0 ends it at the first chunk
    boundary past that many seconds (``poll``): the profiler holds every
    event in host memory until it stops, so an unbounded capture of a
    long run grows without limit."""
    cap = _Capture(log_dir, limit_s, device)
    _captures.append(cap)
    try:
        yield cap
    finally:
        _captures.remove(cap)
        cap.stop()


def maybe_trace(log_dir: Optional[str], device="cuda"):
    """``trace`` where ``log_dir`` is given, nothing where it is None: the
    CLI's ``--profile DIR``. The window is ``GF_PROFILE_SECONDS`` (default
    300; 0 = the whole run)."""
    if not log_dir:
        return contextlib.nullcontext()
    return trace(log_dir, float(os.environ.get("GF_PROFILE_SECONDS", "300")),
                 device)


def rank_dir(log_dir: Optional[str], rank: int) -> Optional[str]:
    """Rank r's trace directory under ``--mesh``: ``log_dir/rank{r}``."""
    return os.path.join(log_dir, f"rank{rank}") if log_dir else None


# ---- spans and counters ----

_kept = 0                      # open port captures and counting() scopes
_local = threading.local()     # .stack: the thread's open span names
_counts: Optional["Counts"] = None
_NULL = contextlib.nullcontext()


def _stack() -> List[str]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def __enter__(self):
        _stack().append(self.name)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        _stack().pop()
        return False


def span(name: str):
    """A context naming a phase of the port; see the module's note."""
    return _Span(name) if _kept else _NULL


class Counts:
    """What one ``counting()`` scope recorded. While it is open,
    ``items`` holds (name, spans, value, total), ``spans`` the open spans
    at the count, outermost first; once it has closed,
    ``totals[name][spans]`` is [sum of the values, sum of the totals,
    counts], and ``fallbacks`` the fallback counters' deltas over the
    scope: ``cells_overflows`` (launches of the cells kernels that swept
    the whole tile mask) and ``banded_guard_failures``."""

    def __init__(self):
        self.items: List[tuple] = []
        self.totals: Dict[str, Dict[Tuple[str, ...], list]] = {}
        self.fallbacks: Dict[str, int] = {}

    def sums(self, name: str, within: Optional[str] = None):
        """[sum of the values, sum of the totals, counts] of ``name``,
        of the counts made inside the span ``within`` where given."""
        out = [0, 0, 0]
        for spans, row in self.totals.get(name, {}).items():
            if within is None or within in spans:
                out = [a + b for a, b in zip(out, row)]
        return out


def count(name: str, value: torch.Tensor, total: int) -> None:
    """Record ``value`` (summed when the scope closes) against ``total``
    under the open spans, inside ``counting()``; else nothing."""
    rec = _counts
    if rec is not None:
        rec.items.append((name, tuple(_stack()), value, int(total)))


def counters_on() -> bool:
    """Whether a ``counting()`` scope is open: for a counter whose value
    the work would not compute otherwise."""
    return _counts is not None


def _fallback_counts() -> Dict[str, int]:
    from gaussian_fluids_torch.ops import gsr_banded, gsr_cells
    return {"cells_overflows": sum(gsr_cells.overflows().values()),
            "banded_guard_failures": gsr_banded.guard_failures()}


@contextlib.contextmanager
def counting():
    """Counters on, and spans kept, for the block; yields its ``Counts``,
    reduced to host numbers when the block ends. Open it outside the
    window it measures: its entry and exit synchronise with the card."""
    global _counts, _kept
    rec, outer = Counts(), _counts
    before = _fallback_counts()
    _counts = rec
    _kept += 1
    try:
        yield rec
    finally:
        _kept -= 1
        _counts = outer
        for name, sp, value, total in rec.items:
            row = rec.totals.setdefault(name, {}).setdefault(sp, [0, 0, 0])
            row[0] += int(value.sum())
            row[1] += total
            row[2] += 1
        rec.items = []
        after = _fallback_counts()
        rec.fallbacks = {k: after[k] - before[k] for k in after}
