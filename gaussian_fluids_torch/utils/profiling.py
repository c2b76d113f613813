"""Profiling and timing: ``--profile DIR`` of the entry points, as the JAX
package's ``utils/profiling.py``.

  * ``trace(log_dir, limit_s, device)`` records a ``torch.profiler``
    capture (CPU operators, and the card's kernels where the run is on
    a GPU) and writes it as a Chrome trace, ``log_dir/trace.json``;
  * ``maybe_trace(log_dir, device)`` is ``trace`` where a directory is
    given, with the window of ``GF_PROFILE_SECONDS`` (300 s; 0: the
    whole run), else nothing;
  * ``hard_sync`` waits for the card; ``StepTimer`` sums named phases.

The window ends at a chunk boundary, not from a timer thread. The JAX
package stops its capture from a ``threading.Timer``; ``torch.profiler``
ties a capture to the thread that started it, and a stop from another
thread finds none: on an H100 it raises "Can't disable Kineto
profiler when it's not running" and the export then fails, on the CPU
the export crashes. So ``poll()``, which the chunked loops call after
every chunk (``solver/loop.run_chunked``, the fit's log steps, the
replay's frames), stops a capture whose window has passed, in the
thread that started it: a capture ends at most one chunk late.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

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

    def stop(self):
        """End the capture, once the card has run what was queued, and
        write it."""
        if self.open:
            self.open = False
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


def hard_sync(tree):
    """Wait until the card has finished the work behind every tensor in
    ``tree`` (nested lists, tuples and dicts); returns ``tree``."""
    devs = set()

    def walk(t):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devs.add(t.device)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    for dev in devs:
        torch.cuda.synchronize(dev)
    return tree


class StepTimer:
    """Named wall-clock phase timer that waits for the card at the end of
    a phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """``sync``: a zero-argument callable giving the tensors to wait
        for at the end of the block (evaluated then, not at entry):

            with timer.phase('project', sync=lambda: carry):
                carry = run_chunk(carry, ...)
        """
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                hard_sync(sync() if callable(sync) else sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            lines.append(f"{k}: {self.totals[k]:.3f}s "
                         f"({self.counts[k]} calls, "
                         f"{self.totals[k] / max(self.counts[k], 1):.4f}s "
                         f"avg)")
        return "\n".join(lines)
