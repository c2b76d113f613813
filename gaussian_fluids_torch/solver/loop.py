"""Chunked-optimization loop shared by projection and the clone re-fit.

Epochs run in chunks of ``check_iter``; the host reads the test metrics
only between chunks, for the patience-based early stop, so no epoch
synchronises with the device. Unlike the JAX package, which dispatches the
next chunk before it fetches the last one's metrics, chunks run in order
here: on one CUDA stream a metrics copy waits behind every kernel queued
before it, so speculating would only waste a chunk on early stop.
"""

from __future__ import annotations

import math


class Patience:
    """Early-stop bookkeeping: reset on a relative improvement, otherwise
    accumulate epochs."""

    def __init__(self, rel):
        self.best, self.iters, self.rel = math.inf, 0, rel

    def update(self, value, check_iter):
        if value < self.best * (1.0 - self.rel):
            self.best, self.iters = value, 0
        else:
            self.iters += check_iter


def run_chunked(carry, dispatch, max_epoch: int, check_iter: int,
                on_chunk, tag: str):
    """Run up to ``max_epoch`` epochs in ``check_iter`` chunks.

    ``dispatch(carry, n) -> (new_carry, metrics)`` runs one n-epoch chunk
    and returns its test metrics as a tuple of host floats (the one
    synchronisation per chunk). ``on_chunk(metrics, n) -> bool`` prints and
    updates patience; True stops early. Returns (carry, epochs_run)."""
    done = 0
    while done < max_epoch:
        n = min(check_iter, max_epoch - done)
        carry, mh = dispatch(carry, n)
        done += n
        # a diverged phase must halt loudly: NaN never beats Patience.best
        if not all(math.isfinite(float(v)) for v in mh):
            raise FloatingPointError(
                f"[{tag}] non-finite test metrics after {done} epochs: {mh}")
        if on_chunk(mh, n):
            print(f"[{tag}] Total epoch:", done)
            return carry, done
    if max_epoch > 0:
        print(f"[{tag}] Total epoch:", max_epoch,
              "(Reached maximum iteration number)")
    return carry, done
