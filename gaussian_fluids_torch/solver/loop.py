"""Chunked-optimization loop shared by projection and the clone re-fit.

Epochs run in chunks of ``check_iter``; the host reads the test metrics
only between chunks, for the patience-based early stop, so no epoch
synchronises with the device. Unlike the JAX package, which dispatches the
next chunk before it fetches the last one's metrics, chunks run in order
here: on one CUDA stream a metrics copy waits behind every kernel queued
before it, so speculating would only waste a chunk on early stop.

The per-chunk target structure lives here too: ``Runner``, the pieces
of one projection or clone config, and its ``run_chunk``; the exact-target
hoist's gate and sweeps (``hoist_default``, ``sorted_batches``,
``swept``): projection and clone both hoist a chunk's targets out of its
epochs.
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple, Optional

import torch

from gaussian_fluids_torch.ops import field, spatial
from gaussian_fluids_torch.utils import profiling
from gaussian_fluids_torch.utils.grids import sweep_group


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
        profiling.poll()
        if on_chunk(mh, n):
            print(f"[{tag}] Total epoch:", done)
            return carry, done
    if max_epoch > 0:
        print(f"[{tag}] Total epoch:", max_epoch,
              "(Reached maximum iteration number)")
    return carry, done


def run_chunk(epoch, chunk_inputs, carry, gen, n: int, hoist: bool = False,
              tgt: Optional[torch.Tensor] = None,
              auxes: Optional[list] = None):
    """n epochs on the inputs ``chunk_inputs`` draws for them, all first
    (the epochs draw nothing), in the JAX package's three target modes:
    per epoch (no targets: each epoch computes its own), hoisted (the
    batches sorted, their exact targets in ``sweep_group`` sweeps), or
    interpolated from ``tgt``, the grid of exact targets computed once a
    projection or clone. Returns the carry; each epoch's aux (its train
    losses, on the device) is appended to ``auxes`` where one is given."""
    for xs in chunk_inputs(carry, gen, n, hoist, tgt):
        with profiling.span("gf.epoch"):
            carry, aux = epoch(carry, xs, presorted=hoist and tgt is None)
        if auxes is not None:
            auxes.append(aux)
    return carry


class Runner(NamedTuple):
    """One projection or clone config's pieces. ``epoch(carry, xs,
    presorted=False)`` runs one epoch on its inputs xs;
    ``chunk_inputs(carry, gen, n, hoist, tgt)`` draws a chunk's n inputs
    in one of the three target modes (``run_chunk``);
    ``target_grid_fn`` computes the grid of exact targets; ``test_ref_fn``
    and ``test_fn`` give the test targets and metrics; ``sample`` draws
    one epoch's inputs (the projections; the tests feed the JAX package's
    draws in its place)."""
    epoch: Callable
    chunk_inputs: Callable
    target_grid_fn: Callable
    test_ref_fn: Callable
    test_fn: Callable
    sample: Optional[Callable] = None

    def run_chunk(self, carry, gen, n: int, hoist: bool = False,
                  tgt: Optional[torch.Tensor] = None,
                  auxes: Optional[list] = None):
        """:func:`run_chunk` on this config's epoch."""
        return run_chunk(self.epoch, self.chunk_inputs, carry, gen, n, hoist,
                         tgt, auxes)


def hoist_default(x: torch.Tensor) -> bool:
    """The JAX package's gate of the exact-target hoist, with the card in
    place of its accelerator: on where the field takes the centered
    kernel path (``field._use_kernel``: by default ``x`` on the card) or
    the sparse oracle, unless ``GF_HOIST_TARGETS=0``."""
    return (field._use_kernel(x) or field._use_sparse(x)) and \
        os.environ.get("GF_HOIST_TARGETS", "1") != "0"


def sorted_batches(data: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """(n, B, d) batches, each sorted by ``spatial.sort_key`` over the
    lattice bounds (lo, hi) stably: the order the epoch's own stable sort
    gives each batch alone. As the epochs, this sorts only where the
    field runs on a kernel."""
    if not field._use_kernel(data):
        return data
    with profiling.span("gf.chunk.sort"):
        o = torch.argsort(spatial.sort_key(data, lo, hi), dim=1, stable=True)
        return torch.gather(data, 1, o[..., None].expand_as(data))


def swept(fn, data: torch.Tensor):
    """``fn`` on the chunk's (n, B, d) batches concatenated in groups of
    ``sweep_group(n, B)`` batches, the outputs split back per batch: the
    hoist's few large target sweeps. ``fn(points) -> tensor or tuple``."""
    n, b, d = data.shape
    g = sweep_group(n, b)
    with profiling.span("gf.chunk.targets"):
        outs = [fn(c) for c in data.reshape(n // g, g * b, d)]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat(outs).reshape((n, b) + outs[0].shape[1:])
        return tuple(torch.cat(o).reshape((n, b) + o[0].shape[1:])
                     for o in zip(*outs))
