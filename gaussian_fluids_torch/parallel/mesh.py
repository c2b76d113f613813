"""The device mesh of a multi-device run: B x G ranks over
``torch.distributed``, one process each.

The JAX package lays a ``jax.sharding.Mesh`` with the axes (batch, gauss)
over the devices of one program (``parallel/sharding.py make_mesh``).
PyTorch has no such program: here every mesh position is a process (a
rank) started by :func:`launch`, and each axis is a set of process
groups. Rank r sits at (b, g) = divmod(r, G), row-major as the JAX mesh's
``reshape(n_batch, n_gauss)``; the ranks of one batch row (one b) form
its gauss group, those of one gauss column (one g) its batch group.

Backends: NCCL on the card, one rank per GPU (rank r on cuda:K+r, K the
``--device`` index); gloo on the CPU (``--device cpu``), which is how the
tests run. ``launch(..., shared_device=True)`` puts every rank on one GPU
over gloo with CUDA tensors, so a single card can hold the collectives'
sums against the single-device path; the smoke run asks for it, the CLI
never does. A run on the card never falls back to gloo or the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 900.0   # a collective that waits longer fails the run
GRACE_S = 10.0   # after a rank fails, how long the others get to exit


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (batch, gauss) mesh: the axes' sizes, its
    coordinates (b, g), its global rank, its device, the backend and the
    two process groups it belongs to."""
    n_batch: int
    n_gauss: int
    b: int
    g: int
    device: torch.device
    backend: str
    batch_group: object
    gauss_group: object

    @property
    def rank(self) -> int:
        return self.b * self.n_gauss + self.g

    @property
    def size(self) -> int:
        return self.n_batch * self.n_gauss

    @property
    def writer(self) -> bool:
        """Rank 0 writes the run's files and log lines."""
        return self.rank == 0

    def generator(self, seed: int) -> torch.Generator:
        """The sample generator of this rank's batch row, seeded from
        (seed, b): the ranks of one row draw the same batches, each row
        its own, so the global batch is the rows' batches together."""
        s = int(np.random.SeedSequence([int(seed), self.b])
                .generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(s)


def _groups(n_batch: int, n_gauss: int, rank: int):
    """(batch group, gauss group) of ``rank``. Every rank creates every
    group, in one order, as ``dist.new_group`` requires."""
    batch = gauss = None
    for g in range(n_gauss):
        grp = dist.new_group([b * n_gauss + g for b in range(n_batch)])
        if rank % n_gauss == g:
            batch = grp
    for b in range(n_batch):
        grp = dist.new_group([b * n_gauss + g for g in range(n_gauss)])
        if rank // n_gauss == b:
            gauss = grp
    return batch, gauss


def _make_mesh(shape, rank: int, device, backend: str) -> Mesh:
    n_batch, n_gauss = shape
    batch, gauss = _groups(n_batch, n_gauss, rank)
    b, g = divmod(rank, n_gauss)
    return Mesh(n_batch, n_gauss, b, g, device, backend, batch, gauss)


def reshape(mesh: Mesh, shape) -> Mesh:
    """This rank's place in another (n_batch, n_gauss) layout of the same
    ranks (B' * G' = B * G), with that layout's process groups. Every rank
    calls it, in the same order, as group creation requires."""
    if shape[0] * shape[1] != mesh.size:
        raise ValueError(f"mesh {shape[0]}x{shape[1]} does not hold the "
                         f"{mesh.size} ranks of {mesh.n_batch}x"
                         f"{mesh.n_gauss}")
    return _make_mesh(shape, mesh.rank, mesh.device, mesh.backend)


def refuse_target_grid(target_grid_res: int):
    """The sharded epochs evaluate exact per-epoch targets: a cached
    target grid is refused rather than silently ignored."""
    if target_grid_res:
        raise ValueError(
            "--target_grid is unsupported with --mesh: the sharded "
            "projection/clone epochs evaluate exact per-epoch targets")


def mesh_from_shape(mesh_shape, target_grid_res: int = 0,
                    device="cuda") -> Optional[Tuple[int, int]]:
    """The CLI's validation of ``--mesh``, as the JAX package's
    ``parallel.mesh_from_shape``: None -> None; ``--target_grid`` is
    refused (the sharded epochs evaluate exact per-epoch targets); on the
    card a mesh needs one GPU per rank from ``device``'s index on, and one
    larger than the visible GPUs is refused, never run on fewer. Returns
    the (n_batch, n_gauss) shape."""
    if mesh_shape is None:
        return None
    refuse_target_grid(target_grid_res)
    n_batch, n_gauss = mesh_shape
    n = n_batch * n_gauss
    dev = torch.device(device)
    if dev.type == "cuda":
        first = dev.index or 0
        visible = torch.cuda.device_count()
        if first + n > visible:
            raise ValueError(
                f"--mesh {n_batch}x{n_gauss} needs {n} GPUs from cuda:"
                f"{first} on, but only {visible} are visible")
    return int(n_batch), int(n_gauss)


def build_kernels():
    """Build every CUDA library once, in the launching process, so the
    ranks load them instead of each running ``nvcc``."""
    from gaussian_fluids_torch.ops import (cuda_build, gsr_banded, gsr_cells,
                                           gsr_centered, rk4_fused)
    cuda_build.build(gsr_centered.SOURCE, gsr_cells.SOURCE,
                     gsr_banded.SOURCE, rk4_fused.SOURCE)


def _record_error(tmp, rank, exc, caught):
    """Write this rank's error record (rank, the monotonic time it was
    caught, type, message, formatted traceback) into the launch's
    directory; written whole through a rename, so :func:`launch` never
    reads half a record."""
    rec = {"rank": rank, "caught": caught, "type": type(exc).__name__,
           "message": str(exc),
           "traceback": "".join(traceback.format_exception(exc))}
    path = os.path.join(tmp, f"error{rank}.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(rec, fh)
    os.replace(path + ".part", path)


def _worker(rank, fn, args, shape, devices, backend, tmp, threads):
    """One rank: join the process group, build the mesh, run
    ``fn(mesh, *args)`` and save what it returns for :func:`launch`.

    A rank that raises records its error before it leaves the process
    group: leaving closes its transport pairs, so a peer that waits in a
    collective fails next, and its record carries a later time."""
    if threads:
        torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")   # rank 0 writes the log lines
    n_batch, n_gauss = shape
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=n_batch * n_gauss, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = fn(_make_mesh(shape, rank, device, backend), *args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException as exc:
        _record_error(tmp, rank, exc, time.monotonic())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _first_error(tmp, n):
    """The earliest-caught of the ranks' error records, or None where no
    rank left one (a rank killed by a signal, for example)."""
    recs = []
    for r in range(n):
        path = os.path.join(tmp, f"error{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as fh:
                recs.append(pickle.load(fh))
    return min(recs, key=lambda rec: rec["caught"]) if recs else None


def _join(ctx, deadline, tmp, n) -> bool:
    """``ctx.join`` until ``deadline``. Where a rank failed, the others get
    ``GRACE_S`` seconds to exit and are then killed, and the error raised
    is the earliest rank's own: ``ctx.join`` raises for whichever failed
    process it reads first, often a peer whose collective broke when the
    failing rank left. Its own exception stands only where no rank left
    a record (a segfault)."""
    try:
        return ctx.join(None if deadline is None else
                        max(0.0, deadline - time.monotonic()),
                        grace_period=GRACE_S)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        rec = _first_error(tmp, n)
        if rec is None:
            raise
        proc = ctx.processes[rec["rank"]]
        raise mp.ProcessRaisedException(
            f"\n\n-- Rank {rec['rank']} terminated with the following "
            f"error ({rec['type']}: {rec['message']}):\n"
            f"{rec['traceback']}", rec["rank"], proc.pid) from exc


def launch(fn, mesh_shape, args=(), device="cuda",
           shared_device: bool = False, timeout: Optional[float] = None,
           threads: Optional[int] = None):
    """Run ``fn(mesh, *args)`` on B x G ranks, one process each
    (``torch.multiprocessing``, spawned), and return the list of what each
    rank returned (loaded on the CPU), rank 0 first. ``fn`` must be a
    module-level function: spawn pickles it by name.

    ``device``: "cpu" runs gloo ranks on the CPU; a CUDA device runs NCCL
    ranks, rank r on the GPU K + r (K its index; ``mesh_from_shape``
    refuses too few), or with ``shared_device`` gloo ranks all on that
    one GPU. The CUDA libraries are built here first. Rendezvous goes
    through a file store in a temporary directory; a collective that waits
    more than ``COLLECTIVE_TIMEOUT_S`` seconds fails; a rank that fails
    ends every rank and raises here; past ``timeout`` seconds (None: no
    limit) the ranks are killed and TimeoutError raised. The error raised
    for a failed run is that of the rank that failed first (each rank
    records its error and the time it caught it, ``_join``). ``threads`` sets
    each rank's ``torch.set_num_threads`` (CPU ranks default to an equal
    share of the launching process's ``torch.get_num_threads()``)."""
    n_batch, n_gauss = mesh_shape
    n = n_batch * n_gauss
    dev = torch.device(device)
    if dev.type == "cuda":
        first = dev.index or 0
        if shared_device:
            backend, devices = "gloo", [f"cuda:{first}"] * n
        else:
            mesh_from_shape(mesh_shape, device=dev)
            backend = "nccl"
            devices = [f"cuda:{first + r}" for r in range(n)]
        build_kernels()
    else:
        backend, devices = "gloo", ["cpu"] * n
        # the ranks share the launching process's threads; more would
        # only spin against each other
        threads = threads or max(1, torch.get_num_threads() // n)
    tmp = tempfile.mkdtemp(prefix="gf_mesh_")
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, tuple(args), (n_batch, n_gauss), devices,
                           backend, tmp, threads),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not _join(ctx, deadline, tmp, n):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"mesh {n_batch}x{n_gauss}: ranks still running after "
                    f"{timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
