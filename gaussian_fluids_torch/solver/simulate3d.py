"""3D end-to-end flows: initialization, the frame loop
clone -> advect -> project -> save, and the offline smoke-density replay,
as in the JAX package's ``solver/simulate3d.py``. With ``viz`` (the
default, as there) they write that package's ``.vti`` volumes: the
obstacle's ``obstacle.obj``, the analytic field's ``velocity_ref``,
``vorticity_ref``, ``divergence_ref`` and ``helicity_ref``, and each
frame's ``vorticity_{n}`` and ``divergence_{n}``; the single-device frame
loop also collects its projection's loss curves and draws them as
``loss_{n}.png`` (``io/viz2d.plot_loss_curves``), where matplotlib is
present (``viz2d.figures_on``: without it one line says so, and the
volumes and the curves' collection go on). Under a mesh (``--mesh``)
the frame loop and the replay run on every rank of it, their epochs and
steps sharded (``parallel/driver.py``, ``parallel/density.py``); rank 0
writes the files.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.io import checkpoint, viz2d, vti
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field, gsr_banded, interp
from gaussian_fluids_torch.ops.advect import rk4_pos_stages
from gaussian_fluids_torch.scenes import get_scene_3d
from gaussian_fluids_torch.solver import losses
from gaussian_fluids_torch.solver.advect_field import advect_covector_field_3d
from gaussian_fluids_torch.solver.clone import clone_velocity_field
from gaussian_fluids_torch.solver.fit import fit_velocity_with_gradient
from gaussian_fluids_torch.solver.project import ProjectWeights, project_3d
from gaussian_fluids_torch.solver.simulate2d import _generator
from gaussian_fluids_torch.utils import profiling
from gaussian_fluids_torch.utils.grids import grid_nodes, grid_points_3d

FIT_LRS_3D = {"positions": 1e-3, "scalings": 1e-3, "rotations": 1e-3,
              "values": 1e-3}


def _box(domain):
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    return (x_min, y_min, z_min), (x_max, y_max, z_max)


def _write_volumes(out_dir, names, field_fn, domain, shape, device):
    """``field_fn`` ((c, 3) points -> (c, len(names))) on the grid nodes,
    evaluated once, its columns written as ``{name}.vti`` with the JAX
    package's ``write_vti_field`` geometry."""
    vol = vti.grid_values(field_fn, domain, shape, device=device)
    spacing = vti.field_spacing(domain, shape)
    for i, name in enumerate(names):
        vti.write_vti_array(vol[..., i], domain[0::2], spacing,
                            os.path.join(out_dir, f"{name}.vti"))


def _reference_fields_fn(scene):
    """(c, 3) points -> (c, 4): the analytic field's |u|, |curl u|, div u
    and helicity u . curl u, from one velocity and one Jacobian
    evaluation."""
    def f(x):
        vel = scene.velocity(x)
        jac = scene.velocity_jac(x)
        vor = losses.curl3d(jac)
        return torch.stack([torch.linalg.vector_norm(vel, dim=-1),
                            torch.linalg.vector_norm(vor, dim=-1),
                            losses.divergence(jac), (vor * vel).sum(-1)], -1)
    return f


def _frame_fields_fn(mix: GaussianMixture, spec: FieldSpec):
    """(c, 3) points -> (c, 2): the mixture's |curl u| and div u, from one
    value + Jacobian evaluation (``field.value_and_jac_chunked``)."""
    def f(x):
        jac = field.value_and_jac_chunked(mix, spec, x)[1]
        return torch.stack([
            torch.linalg.vector_norm(losses.curl3d(jac), dim=-1),
            losses.divergence(jac)], -1)
    return f


def _write_frame_vti(out_dir, tag, mix, spec, scene, viz_res=None):
    """``vorticity_{tag}.vti`` and ``divergence_{tag}.vti`` of the mixture
    on the scene's grid (``viz_res`` overrides it)."""
    _write_volumes(out_dir, (f"vorticity_{tag}", f"divergence_{tag}"),
                   _frame_fields_fn(mix, spec), scene.domain,
                   tuple(viz_res or scene.visualize_res), mix.device)


def initialize_3d(init_cond: str, out_dir: str, max_epoch: int = 500,
                  batch_size: int = 8192, seed: int = 42, viz: bool = True,
                  particle_count=None, viz_res=None, verbose: int = 1,
                  device="cuda"):
    """Fit the scene's ring field; writes gaussian_velocity_0.pt, an
    obstacle scene's obstacle.obj, and with ``viz`` the four reference
    volumes and the frame-0 volumes (on the scene's grid, or
    ``viz_res``). Returns (mix, spec)."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = get_scene_3d(init_cond)
    lo, hi = _box(scene.domain)
    xn, yn, zn = particle_count or scene.particle_count
    pos = grid_points_3d(*scene.domain, xn, yn, zn)
    spec = FieldSpec.create(lo, hi, pos.shape[0], d=3, vdim=3)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    print("Particle count:", pos.shape[0])
    if scene.mesh_sampler is not None:
        scene.mesh_sampler.save_obj(os.path.join(out_dir, "obstacle.obj"))
    if viz:
        with torch.no_grad():
            _write_volumes(out_dir, ("velocity_ref", "vorticity_ref",
                                     "divergence_ref", "helicity_ref"),
                           _reference_fields_fn(scene), scene.domain,
                           tuple(viz_res or scene.visualize_res), device)
    mix = fit_velocity_with_gradient(
        mix, spec, scene.velocity, scene.velocity_jac, lo, hi,
        lrs=dict(FIT_LRS_3D), batch_size=batch_size, max_epoch=max_epoch,
        gen=_generator(seed, device), verbose=verbose)
    checkpoint.save_checkpoint(
        os.path.join(out_dir, "gaussian_velocity_0.pt"), mix, spec)
    if viz:
        _write_frame_vti(out_dir, "0", mix, spec, scene, viz_res)
    return mix, spec


def advance_3d(init_cond: str, out_dir: str, dt: float, last_time: float,
               start_frame: int = 0, max_epoch: int = 20000,
               batch_size: int = 8192, boundary_lambda: float = 10.0,
               seed: int = 42, viz: bool = True, viz_res=None,
               test_res: Optional[tuple] = None, verbose: int = 1,
               target_grid_res: int = 0, device="cuda", mesh=None):
    """Frame loop from gaussian_velocity_{start_frame}.pt; writes one
    checkpoint per frame (``target_grid_res`` > 0: the clone's and the
    projection's cached-target grids, ``--target_grid``) and, with
    ``viz``, the start frame's and every frame's vorticity and divergence
    volumes, and on one device the projection's loss curves (drawn as
    ``loss_{n}.png`` where matplotlib is present). Returns (mix, spec,
    frames), ``frames`` holding per frame its number, alive count, seconds
    per phase (clone, advect, project, the volumes and curves, the save),
    the last test metrics of the clone and projection phases, and the
    curves (None without them). ``mesh``: as ``simulate2d.advance_2d``'s; rank 0
    writes the volumes and checkpoints."""
    if mesh is not None:
        from gaussian_fluids_torch.parallel import driver
        from gaussian_fluids_torch.parallel.mesh import refuse_target_grid
        refuse_target_grid(target_grid_res)
        device = mesh.device
    device = torch.device(device)
    writer = mesh is None or mesh.writer
    scene = get_scene_3d(init_cond)
    domain = scene.domain
    lo, hi = _box(domain)
    mix, spec = checkpoint.load_checkpoint(
        os.path.join(out_dir, f"gaussian_velocity_{start_frame}.pt"),
        device=device)
    gen = _generator(seed + start_frame, device)
    if mesh is not None:
        # rank 0's test metrics draw from the single-device generator
        gen, test_gen = mesh.generator(seed + start_frame), gen
    xnv, ynv, znv = test_res or scene.visualize_res
    test_x = grid_points_3d(*domain, xnv, ynv, znv)
    # the loss curves, as the JAX package: with viz, on one device only
    curves_on = viz and mesh is None
    draw = curves_on and viz2d.figures_on(True, "the loss_{n}.png curves")
    if viz and writer:
        _write_frame_vti(out_dir, str(start_frame), mix, spec, scene,
                         viz_res)

    frames = []
    t, cnt = 0.0, start_frame + 1
    while t < last_time:
        ft0 = time.perf_counter()
        if mesh is None:
            new_mix, clone_m = clone_velocity_field(
                mix, spec, lo=lo, hi=hi, test_x=test_x, gen=gen, seed=cnt,
                d=3, batch_size=batch_size, max_epoch=max_epoch,
                verbose=verbose, target_grid_res=target_grid_res)
        else:
            new_mix, clone_m = driver.clone_velocity_field_sharded(
                mix, spec, mesh=mesh, lo=lo, hi=hi, test_x=test_x, gen=gen,
                seed=cnt, d=3, batch_size=batch_size, max_epoch=max_epoch,
                verbose=verbose)
        ftc = time.perf_counter()
        new_mix = advect_covector_field_3d(new_mix, mix, spec, dt)
        if mesh is not None:
            new_mix = driver.broadcast_mixture(new_mix, mesh)
        fta = time.perf_counter()
        w = ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                           delta_pos=0.0, hel=1.0, val_reg=0.0)
        curves = None
        if mesh is None:
            new_mix, proj_m, curves = project_3d(
                new_mix, spec, mix, dt, domain=domain, test_x=test_x,
                gen=gen, scene_name=init_cond, weights=w,
                boundary_lambda=boundary_lambda, batch_size=batch_size,
                max_epoch=max_epoch, verbose=verbose,
                target_grid_res=target_grid_res, collect_curves=curves_on)
            if draw:
                viz2d.plot_loss_curves(
                    curves, os.path.join(out_dir, f"loss_{cnt}.png"))
        else:
            new_mix, proj_m = driver.project_3d_sharded(
                new_mix, spec, mix, dt, mesh=mesh, domain=domain,
                test_x=test_x, gen=gen, test_gen=test_gen,
                scene_name=init_cond, weights=w,
                boundary_lambda=boundary_lambda, batch_size=batch_size,
                max_epoch=max_epoch, verbose=verbose)
        mix = new_mix
        print(f"Wrote frame {cnt}")
        ft1 = time.perf_counter()
        if viz and writer:
            _write_frame_vti(out_dir, str(cnt), mix, spec, scene, viz_res)
        ft2 = time.perf_counter()
        if writer:
            checkpoint.save_checkpoint(
                os.path.join(out_dir, f"gaussian_velocity_{cnt}.pt"), mix,
                spec)
        ft3 = time.perf_counter()
        n_alive = mix.n_alive()
        if verbose:
            print(f"[frame {cnt}] solve {ft1 - ft0:.1f}s (clone "
                  f"{ftc - ft0:.1f} advect {fta - ftc:.1f} project "
                  f"{ft1 - fta:.1f}) viz {ft2 - ft1:.1f}s save "
                  f"{ft3 - ft2:.1f}s (N={n_alive}/{mix.capacity})",
                  flush=True)
        frames.append({"frame": cnt, "n_alive": n_alive,
                       "capacity": mix.capacity, "seconds": ft3 - ft0,
                       "clone_seconds": ftc - ft0,
                       "advect_seconds": fta - ftc,
                       "project_seconds": ft1 - fta,
                       "viz_seconds": ft2 - ft1, "save_seconds": ft3 - ft2,
                       "clone": clone_m, "project": proj_m,
                       "curves": curves})
        cnt += 1
        t += dt
    return mix, spec, frames


# ---- offline smoke replay (reference 3D/advance_density.py) ----

DENSITY_CHUNK = 262144   # grid nodes per chunk: one x-plane of the 512^3 grid


@functools.lru_cache(maxsize=2)
def _grid_chunks_device(domain: tuple, grid_shape: tuple, chunk: int,
                        device: torch.device):
    """(chunks, true count): the grid nodes of ``grid_points_3d`` built on
    ``device``, padded to whole chunks by repeating the last node and
    split into views. The grid is x-slowest, so the padded array stays
    sorted by x and the banded sweep runs presorted. Constant across frames
    and densities, so built once (a 512^3 grid is 1.6 GB)."""
    pts = grid_nodes(domain, grid_shape, device)
    n = pts.shape[0]
    pad = (-n) % chunk
    if pad:
        pts = torch.cat([pts, pts[-1:].expand(pad, 3)])
    return pts.split(chunk), n


def _suggest_band(mix: GaussianMixture, spec: FieldSpec, dt,
                  chunk: int = DENSITY_CHUNK) -> int:
    """The band of ``field.value_banded`` for this mixture: the widest
    window of Gaussian tiles that one query tile can meet, with a drift
    margin for the RK4 stage excursions. The JAX package computes it for
    its TPU tiles (tb = 1024, tn = 512); this computes it for the CUDA
    kernel's tiles (``gsr_banded.TB``, ``TN``) by the same scan, over the
    tile x extents the device guard holds the band to
    (``field.gaussian_tile_extents``: each row dilated by its own radius
    and a 1e-3 margin, where the JAX package dilates a tile by its
    largest), on the mixture as the replay orders it (slab-major, where
    the JAX package sorts along x: a window then spans two or three
    slabs' tiles, of which the kernel walks only those meeting a query
    tile's box). It is not
    rounded up to a multiple of 8 as the JAX package rounds it (there, to
    avoid recompiles; the CUDA kernel takes the band at run time). A band
    that turns out too narrow for some stage is caught by the device guard
    and swept in full, never a wrong answer. ``chunk`` is the number of
    points the banded evaluation is called with."""
    nlo, nhi = (e.cpu().numpy() for e in field.gaussian_tile_extents(
        mix, spec, gsr_banded.TN))
    nnt = nlo.shape[0]
    L = max(spec.hi[i] - spec.lo[i] for i in range(spec.d))
    # a query tile of TB of a chunk-point coordinate-sorted batch spans
    # ~tb/chunk of the domain for near-uniform points (4x slop); the drift
    # margin covers the RK4 stage excursions of O(1)-velocity flows
    margin = 0.05 * L + 2.0 * abs(float(dt))
    wB = min(L, 4.0 * L * gsr_banded.TB / chunk) + margin
    # widest window over every query interval [a, a + wB], with tile edges
    # as the candidate starts
    starts = np.concatenate([nlo, nhi]) - wB
    meet = (nhi[None, :] >= starts[:, None]) \
        & (nlo[None, :] <= (starts + wB)[:, None])
    any_row = meet.any(1)
    first = meet.argmax(1)
    last = nnt - 1 - meet[:, ::-1].argmax(1)
    width = max(1, int((last - first + 1)[any_row].max(initial=1)))
    return min(nnt, width + 2)


# Query rows per dense evaluation on the CPU: bounds its (rows, N) planes.
_DENSE_PAIRS = 1 << 22


def _stage_velocity(mix: GaussianMixture, spec: FieldSpec, band):
    """f(points) -> velocities for the RK4 stages of a density step where
    the stages are composed on the host (the CPU step, the sharded step,
    whose stages meet in a sum over ranks, and the multi-frame re-trace):
    the banded kernel on the card (points presorted along x, the host's
    window), the dense field in row blocks on the CPU."""
    if mix.device.type == "cuda":
        prep = field.banded_prep(mix, spec)

        def banded(q):
            with profiling.span("gf.replay.banded"):
                return field.value_banded_prepped(prep, q, band,
                                                  presorted=True)
        return banded
    rows = max(1, _DENSE_PAIRS // mix.capacity)
    return lambda q: torch.cat([
        field.value(mix, spec, q[s:s + rows], need_dx=False)
        for s in range(0, q.shape[0], rows)])


def _banded_rk4_chunk(prep, xc: torch.Tensor, dt: float, band: int,
                      density: torch.Tensor, domain, out: torch.Tensor,
                      offset: int) -> None:
    """One chunk of ``advected_density`` on the banded kernel: the RK4
    backtrace of ``xc`` by ``dt`` as four launches, each a whole stage on
    its tiles' own windows (``gsr_banded.RK4Stage``), the last one
    clamping and sampling ``density`` into ``out`` from node ``offset``.
    Each stage's points are a fresh buffer."""
    total = torch.empty_like(xc)
    x = xc
    for k in range(4):
        stage = gsr_banded.RK4Stage(k, dt, xc, total, density, domain, out,
                                    offset)
        with profiling.span("gf.replay.banded"):
            x = gsr_banded.gsr_value_banded(
                None, None, x, prep["muT"], prep["ppT"], prep["v"],
                prep["rad"], prep["lo"], prep["hi"], prep["clamp"], band,
                nvalid=xc.shape[0], rk4=stage)


@torch.no_grad()
def advected_density(density: torch.Tensor, mix: GaussianMixture,
                     spec: FieldSpec, domain, dt, grid_shape,
                     chunk: int = DENSITY_CHUNK,
                     band: Optional[int] = None) -> torch.Tensor:
    """One semi-Lagrangian step: RK4-backtrace every grid node through the
    velocity field, clamp to the domain, and trilinearly sample the old
    density (reference 3D/advance_density.py:52-59).

    On the card a chunk is four launches of the banded value kernel
    (``_banded_rk4_chunk``): grid chunks are x-sorted, so each query tile
    visits only a window of Gaussian tiles, which it finds itself;
    ``band`` is ``_suggest_band``'s when None, and ``mix`` must be
    slab-major (``slab_sorted``) or x-sorted; the chunk is rounded up to
    whole query tiles. The kernel does the stages' arithmetic, the clamp
    and the sample as the eager chain does them, bit for bit. On the CPU
    the dense field runs on the JAX package's N-bounded chunk. Every chunk
    is dispatched before anything is read back; the result stays on the
    device."""
    xn, yn, zn = grid_shape
    dev = mix.device
    if dev.type == "cuda":
        if band is None:
            band = _suggest_band(mix, spec, dt, chunk=chunk)
        prep = field.banded_prep(mix, spec)
        band = min(band, prep["nlo"].shape[0])
        chunk = -(-chunk // gsr_banded.TB) * gsr_banded.TB
        xcs, n = _grid_chunks_device(tuple(domain), tuple(grid_shape), chunk,
                                     dev)
        density = density.to(dev).contiguous()
        out = torch.empty(n, dtype=torch.float32, device=dev)
        for i, xc in enumerate(xcs):
            with profiling.span("gf.replay.chunk"):
                _banded_rk4_chunk(prep, xc, -float(dt), band, density,
                                  tuple(domain), out, i * chunk)
        return out.reshape(xn, yn, zn)
    # the JAX package's N-bounded CPU chunk, floored to a power of two so
    # it stays stable while the capacity drifts over a replay
    cap_chunk = max(4096, (1 << 29) // max(mix.capacity, 1))
    chunk = min(chunk, 1 << (cap_chunk.bit_length() - 1))
    f = _stage_velocity(mix, spec, band)
    lo = torch.tensor(domain[0::2], dtype=torch.float32, device=dev)
    hi = torch.tensor(domain[1::2], dtype=torch.float32, device=dev)
    xcs, n = _grid_chunks_device(tuple(domain), tuple(grid_shape), chunk,
                                 dev)
    density = density.to(dev)
    outs = []
    for xc in xcs:
        with profiling.span("gf.replay.chunk"):
            bk = torch.minimum(torch.maximum(rk4_pos_stages(f, xc, -dt), lo),
                               hi)
            with profiling.span("gf.replay.trilinear"):
                outs.append(interp.trilinear_interp(density, bk, domain))
    return torch.cat(outs)[:n].reshape(xn, yn, zn)


@torch.no_grad()
def advected_density_n(density0: torch.Tensor, out_dir: str, spec_domain,
                       dt, n_frames: int, grid_shape,
                       chunk: int = DENSITY_CHUNK) -> torch.Tensor:
    """Multi-frame re-trace variant (reference 3D/advance_density.py:61-71,
    unused by default): walk the grid nodes back through all ``n_frames``
    saved velocity checkpoints, then sample the INITIAL density once. Runs
    on the device of ``density0``."""
    xn, yn, zn = grid_shape
    dev = density0.device
    x = torch.as_tensor(grid_points_3d(*spec_domain, xn, yn, zn), device=dev)
    n = x.shape[0]
    for i in range(n_frames - 1, -1, -1):
        mix, spec = checkpoint.load_checkpoint(
            os.path.join(out_dir, f"gaussian_velocity_{i}.pt"), device=dev)
        mix = mix.slab_sorted(spec.clamp_threshold)
        band, fchunk = None, chunk
        if dev.type == "cuda":
            band = _suggest_band(mix, spec, dt, chunk=chunk)
        else:
            fchunk = min(chunk, max(4096, (1 << 29) // max(mix.capacity, 1)))
        f = _stage_velocity(mix, spec, band)
        outs = []
        for s in range(0, n, fchunk):
            xc = x[s:s + fchunk]
            # the banded kernel wants x-sorted queries: sort each chunk
            order = torch.argsort(xc[:, 0], stable=True)
            bk = torch.empty_like(xc)
            bk[order] = rk4_pos_stages(f, xc[order], -dt)
            outs.append(bk)
        x = torch.cat(outs)
    lo = torch.tensor(spec_domain[0::2], dtype=torch.float32, device=dev)
    hi = torch.tensor(spec_domain[1::2], dtype=torch.float32, device=dev)
    x = torch.minimum(torch.maximum(x, lo), hi)
    return interp.trilinear_interp(density0, x, spec_domain) \
        .reshape(xn, yn, zn)


def _write_density_small(host: np.ndarray, origin, spacing, path):
    """Mean-pool the full-resolution density to <= 64 cells per axis and
    save it as a compressed float16 .npz next to the .vti (~100s of KB
    against 512 MB at 512^3): the small durable record of a replay. Mass is
    kept exactly, moments to the pooled cells' resolution. Refuses a shape
    its pool factors do not divide, which would drop edge planes."""
    factors = [-(-s // 64) for s in host.shape]
    for s, f in zip(host.shape, factors):
        if s % f:
            raise ValueError(
                f"density shape {host.shape} not divisible by pooling "
                f"factors {factors}; mean-pooling would drop edge planes")
    v = host.reshape(
        host.shape[0] // factors[0], factors[0],
        host.shape[1] // factors[1], factors[1],
        host.shape[2] // factors[2], factors[2]).mean(axis=(1, 3, 5))
    np.savez_compressed(
        path, density=v.astype(np.float16),
        origin=np.asarray(origin, np.float64),
        spacing=np.asarray(
            [sp * f for sp, f in zip(spacing, factors)], np.float64),
        full_shape=np.asarray(host.shape, np.int64))


class _AsyncVtiWriter:
    """Single-slot pipelined volume writer: the volume is transposed to
    the file's x-fastest order on its device (``vti.x_fastest``) and the
    copy to the host queued right after the density it copies (into
    pinned memory, so the host does not wait); a background thread waits
    for it and writes the files while the next density's chunks run. At
    most one extra host volume is alive at a time. ``writes`` maps each
    .vti path written to its seconds (the write alone, after the copy) and
    bytes."""

    def __init__(self):
        self._pending = None
        self._error = None
        self.writes = {}

    def submit(self, volume: torch.Tensor, origin, spacing, path,
               small_path=None):
        self.drain()
        src = vti.x_fastest(volume)
        if src.is_cuda:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = src, None

        def work():
            try:
                if done is not None:
                    done.synchronize()
                arr = host.numpy()
                t0 = time.perf_counter()
                vti.write_vti_x_fastest(arr, origin, spacing, path)
                self.writes[path] = {
                    "seconds": time.perf_counter() - t0,
                    "bytes": os.path.getsize(path)}
                if small_path is not None:
                    _write_density_small(arr.transpose(2, 1, 0), origin,
                                         spacing, small_path)
            except BaseException as e:  # re-raised on the caller's thread
                self._error = e

        self._pending = threading.Thread(target=work)
        self._pending.start()

    def drain(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


class _Clock:
    """Seconds between marks: CUDA events on the card (read once, after
    the work is done; nothing waits while marking), the host clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []

    def mark(self) -> int:
        """Records a mark; returns its index."""
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())
        return len(self._marks) - 1

    def seconds(self, i: int) -> float:
        """From mark i to mark i + 1 (synchronises on the card)."""
        a, b = self._marks[i], self._marks[i + 1]
        if self._cuda:
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return b - a


def advance_density(init_cond: str, out_dir: str, dt: float,
                    res_multiplier: int = 4, grid_res=None,
                    verbose: int = 1, start_frame: int = 0,
                    device="cuda", mesh=None):
    """Replay loop: seed ring densities, then for every saved frame advect
    each density one step and write ``density_{tag}_{frame}.vti`` with its
    pooled ``density_small_{tag}_{frame}.npz`` (reference
    3D/advance_density.py:87-120). Every scene ``Ring`` seeds one density
    (ring1 -> a, ring2 -> b, ...), identical to the reference for
    ring_collide. The grid is ``visualize_res * res_multiplier`` (512^3 by
    default); ``grid_res`` overrides it. ``start_frame`` resumes from the
    replay's own ``density_{tag}_{start_frame}.vti``. Returns one record per
    advected frame: its number, the band (None on the CPU), the seconds
    per density and, per density, its .vti write (``_AsyncVtiWriter``
    ``writes``: seconds and bytes).

    ``mesh`` (this rank's ``parallel.Mesh``, which sets the device): each
    step is sharded over it (``parallel/density.py``; the records' band is
    None, each rank suggesting its shard's), every rank holds the whole
    volumes, and rank 0 writes them."""
    from gaussian_fluids_torch.scenes.fields3d import Ring
    if mesh is not None:
        from gaussian_fluids_torch.parallel.density import \
            advected_density_sharded
        device = mesh.device
    device = torch.device(device)
    writing = mesh is None or mesh.writer
    scene = get_scene_3d(init_cond)
    domain = scene.domain
    xn, yn, zn = grid_res or tuple(r * res_multiplier
                                   for r in scene.visualize_res)
    rings = [scene.info[k] for k in sorted(scene.info)
             if isinstance(scene.info[k], Ring)]
    if not rings:
        raise NotImplementedError(
            f"scene '{init_cond}' defines no rings to seed densities from")
    tags = [chr(ord("a") + i) for i in range(len(rings))]
    spacing = tuple((domain[2 * i + 1] - domain[2 * i]) / s
                    for i, s in enumerate((xn, yn, zn)))
    origin = (domain[0], domain[2], domain[4])
    writer = _AsyncVtiWriter()

    def vti_path(tag, frame):
        return os.path.join(out_dir, f"density_{tag}_{frame}.vti")

    def submit(tag, frame, volume):
        if not writing:
            return
        writer.submit(volume, origin, spacing, vti_path(tag, frame),
                      os.path.join(out_dir,
                                   f"density_small_{tag}_{frame}.npz"))

    if start_frame > 0:
        frame = start_frame
        dens = [torch.as_tensor(vti.read_vti_array(vti_path(tag, frame))
                                .copy(), device=device) for tag in tags]
    else:
        frame = 0
        dens = [interp.seed_ring_density((xn, yn, zn), domain, r.center,
                                         r.normal, r.radius, r.thickness,
                                         device=device)
                for r in rings]
        for tag, d in zip(tags, dens):
            submit(tag, frame, d)
    records = []
    clock = _Clock(device)
    while True:
        path = os.path.join(out_dir, f"gaussian_velocity_{frame}.pt")
        if not os.path.exists(path):
            break
        profiling.poll()
        mix, spec = checkpoint.load_checkpoint(path, device=device)
        # the banded kernel's window needs x-slabs; its culling, y-cells
        mix = mix.slab_sorted(spec.clamp_threshold)
        band = (_suggest_band(mix, spec, dt) if device.type == "cuda"
                and mesh is None else None)
        frame += 1
        marks = {}
        for i, tag in enumerate(tags):
            marks[tag] = clock.mark()
            if mesh is None:
                dens[i] = advected_density(dens[i], mix, spec, domain, dt,
                                           (xn, yn, zn), band=band)
            else:
                dens[i] = advected_density_sharded(
                    dens[i], mix, spec, domain, dt, (xn, yn, zn), mesh)
            clock.mark()
            submit(tag, frame, dens[i])
        records.append({"frame": frame, "band": band, "marks": marks})
        if verbose:
            print(f"Frame {frame} finished.", flush=True)
    writer.drain()
    for rec in records:
        rec["seconds"] = {tag: clock.seconds(m)
                          for tag, m in rec.pop("marks").items()}
        rec["vti_writes"] = {tag: writer.writes[vti_path(tag, rec["frame"])]
                             for tag in tags} if writing else {}
    return records
