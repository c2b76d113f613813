"""Device timing of a call on the card, for the smoke run and the A/B
scripts."""

from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, reps: int = 30) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` calls. A sleep
    kernel first keeps the card busy while the host queues every call and
    its events, so host overhead between calls does not enter the gaps."""
    for _ in range(min(reps, 3)):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t   # the host's time to queue one call
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    # ~2e9 cycles a second: sleep for twice the queueing time of all calls
    torch.cuda._sleep(int(min(4e9, 1e7 + 2 * 2e9 * reps * host_s)))
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))
