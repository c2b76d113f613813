"""2D end-to-end flows: initialization (with Karman's zero-dt projection)
and the frame loop clone -> advect -> project -> save, as in the JAX
package's ``solver/simulate2d.py``. With ``viz`` (the default, as there)
they draw that package's figures: ``refvelocity``, ``refvorticity`` and
``refdivergence`` of the analytic field, and per frame n the velocity
quiver with the Gaussians' ellipses ``{n}.png``, ``clean_{n}``,
``vorticity_{n}`` and ``divergence_{n}``. The figures' field sweeps run in
the caller's thread (``figure_arrays``); the drawing, numpy only, runs on
one background worker with at most two frames outstanding, and a resumed
run draws the PNGs that an interrupted one left missing. Without
matplotlib (the card's machine) one line says so and nothing is drawn or
swept (``io/viz2d.figures_on``). Under a mesh (``--mesh``) the frame loop
runs on every rank of it, clone and projection sharded
(``parallel/driver.py``); rank 0 writes the checkpoints and figures.
"""

from __future__ import annotations

import functools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.io import checkpoint, viz2d
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.solver import losses
from gaussian_fluids_torch.solver.advect_field import advect_covector_field_2d
from gaussian_fluids_torch.solver.clone import clone_velocity_field
from gaussian_fluids_torch.solver.fit import (FIT_LRS_2D,
                                             fit_velocity_with_gradient)
from gaussian_fluids_torch.solver.project import ProjectWeights, project_2d
from gaussian_fluids_torch.utils import analysis
from gaussian_fluids_torch.utils.grids import grid_points_2d

LR_RATIO = 1.201956  # reference 2D/initialize.py:118,163


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


FIGURES_2D = ("the 2D figures (ref*.png, {n}.png, clean_{n}.png, "
              "vorticity_{n}.png, divergence_{n}.png)")


class _HostMix:
    """numpy rows of the alive Gaussians, enough of a mixture for
    ``viz2d.draw_ellipses``: the render worker never touches the card."""

    def __init__(self, mix):
        keep = mix.alive.cpu().numpy()
        self.positions = mix.positions.detach().cpu().numpy()[keep]
        self.scalings = mix.scalings.detach().cpu().numpy()[keep]
        self.rotations = mix.rotations.detach().cpu().numpy()[keep]
        self.values = mix.values.detach().cpu().numpy()[keep]

    def compact(self):
        return self


_render_pool = None
_render_pending: deque = deque()


def _viz_submit(fn):
    """Run ``fn`` on the single background render worker, with at most 2
    frames outstanding (memory stays flat, and a crash loses at most 2
    frames' PNGs, which ``advance_2d`` backfills on resume). A worker's
    exception is raised here at the next submit or flush."""
    global _render_pool
    if _render_pool is None:
        _render_pool = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="viz-render")
    while len(_render_pending) >= 2:
        _render_pending.popleft().result()
    _render_pending.append(_render_pool.submit(fn))


def flush_viz():
    """Wait for every queued render (the end of the frame loop)."""
    while _render_pending:
        _render_pending.popleft().result()


def figure_arrays(mix, spec, scene):
    """The field sweeps of one frame's figures, in the caller's thread:
    the velocity on the 30 x 30 grid of the scaled initialize domain and
    of the visualize domain (in its unscaled units), the vorticity and
    divergence on the visualize grid (one value and Jacobian sweep serves
    both), and the numpy copy of the mixture for the ellipses."""
    sf = scene.scaling_factor
    x0i, x1i, y0i, y1i = scene.initialize_domain
    x0v, x1v, y0v, y1v = scene.visualize_domain
    xnv, ynv = scene.visualize_res
    g_i = grid_points_2d(x0i * sf, x1i * sf, y0i * sf, y1i * sf, 30, 30)
    g_v = grid_points_2d(x0v, x1v, y0v, y1v, 30, 30)
    g_r = grid_points_2d(x0v, x1v, y0v, y1v, xnv, ynv)
    jac_r = field.eval_on_grid(mix, spec, g_r * sf)[1]
    return {"vel_i": field.eval_on_grid(mix, spec, g_i)[0],
            "vel_v": field.eval_on_grid(mix, spec, g_v * sf)[0] / sf,
            "vor": analysis.curl2d_np(jac_r),
            "div": analysis.divergence_np(jac_r),
            "host_mix": _HostMix(mix)}


def render_frame(out_dir, tag, arr, scene):
    """Draw one frame's four PNGs from ``figure_arrays``' arrays (numpy
    only)."""
    sf = scene.scaling_factor
    x0i, x1i, y0i, y1i = scene.initialize_domain
    x0v, x1v, y0v, y1v = scene.visualize_domain
    xnv, ynv = scene.visualize_res
    viz2d.show_field(lambda x: arr["vel_i"], x0i * sf, x1i * sf, y0i * sf,
                     y1i * sf, dim=2, x_n=30, y_n=30,
                     additional_drawing=lambda: viz2d.draw_ellipses(
                         arr["host_mix"]),
                     save_filename=os.path.join(out_dir, f"{tag}.png"))
    viz2d.show_field(lambda x: arr["vel_v"], x0v, x1v, y0v, y1v, dim=2,
                     x_n=30, y_n=30,
                     save_filename=os.path.join(out_dir, f"clean_{tag}.png"))
    viz2d.show_field(lambda x: arr["vor"], x0v, x1v, y0v, y1v, x_n=xnv,
                     y_n=ynv,
                     save_filename=os.path.join(out_dir,
                                                f"vorticity_{tag}.png"))
    viz2d.show_field(lambda x: arr["div"], x0v, x1v, y0v, y1v, x_n=xnv,
                     y_n=ynv,
                     save_filename=os.path.join(out_dir,
                                                f"divergence_{tag}.png"))


def _viz_frame(out_dir, tag, mix, spec, scene, asynchronous=False):
    """One frame's four PNGs: the sweeps here, the drawing on the render
    worker when ``asynchronous`` (the frame loop)."""
    arr = figure_arrays(mix, spec, scene)
    if asynchronous:
        _viz_submit(functools.partial(render_frame, out_dir, tag, arr,
                                      scene))
    else:
        render_frame(out_dir, tag, arr, scene)


def _reference_figures(out_dir, scene, device):
    """The analytic field's velocity, vorticity and divergence figures, on
    the visualize grid of the initialize domain (unscaled)."""
    x0, x1, y0, y1 = scene.initialize_domain
    xnv, ynv = scene.visualize_res

    def on(fn):
        return lambda x: fn(torch.as_tensor(
            x, dtype=torch.float32, device=device)).cpu().numpy()
    viz2d.show_field(on(scene.velocity), x0, x1, y0, y1, dim=2, x_n=30,
                     y_n=30,
                     save_filename=os.path.join(out_dir, "refvelocity.png"))
    viz2d.show_field(on(lambda p: losses.curl2d(scene.velocity_jac(p))),
                     x0, x1, y0, y1, x_n=xnv, y_n=ynv,
                     save_filename=os.path.join(out_dir, "refvorticity.png"))
    viz2d.show_field(on(lambda p: losses.divergence(scene.velocity_jac(p))),
                     x0, x1, y0, y1, x_n=xnv, y_n=ynv,
                     save_filename=os.path.join(out_dir,
                                                "refdivergence.png"))


def initialize_2d(init_cond: str, out_dir: str, max_epoch: int = 10000,
                  batch_size: int = 512, seed: int = 42, viz: bool = True,
                  particle_count=None, verbose: int = 1, device="cuda"):
    """Fit the scene's analytic field; writes gaussian_velocity_0.pt and,
    with ``viz``, the three reference figures and frame 0's. Returns
    (mix, spec)."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = get_scene_2d(init_cond)
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    lo, hi = (x0 * sf, y0 * sf), (x1 * sf, y1 * sf)
    x_n, y_n = particle_count or scene.particle_count
    pos = grid_points_2d(lo[0], hi[0], lo[1], hi[1], x_n, y_n)
    spec = FieldSpec.create(lo, hi, pos.shape[0], d=2, vdim=2)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    print(f"Particle count: {pos.shape[0]} ({x_n} x {y_n})")
    gen = _generator(seed, device)
    draw = viz2d.figures_on(viz, FIGURES_2D)
    if draw:
        _reference_figures(out_dir, scene, device)
    if init_cond == "karman":
        mix = _init_karman(mix, spec, scene, gen, max_epoch, batch_size,
                           verbose)
    else:
        mix = fit_velocity_with_gradient(
            mix, spec, scene.target_velocity, scene.target_velocity_jac, lo,
            hi, lrs=dict(FIT_LRS_2D), batch_size=batch_size,
            max_epoch=max_epoch, gen=gen, verbose=verbose)
    checkpoint.save_checkpoint(
        os.path.join(out_dir, "gaussian_velocity_0.pt"), mix, spec)
    if draw:
        _viz_frame(out_dir, "0", mix, spec, scene)
    return mix, spec


def _init_karman(mix, spec, scene, gen, max_epoch, batch_size, verbose):
    """Karman's initialization: fit the uniform inflow, then a zero-dt
    projection against a frozen copy carves the cylinder (reference
    2D/initialize.py:162-185)."""
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    lo, hi = (x0 * sf, y0 * sf), (x1 * sf, y1 * sf)
    mix = fit_velocity_with_gradient(
        mix, spec, scene.target_velocity, scene.target_velocity_jac, lo, hi,
        lrs={"positions": 1.6e-3, "scalings": 5e-3,
             "rotations": 5e-3 * LR_RATIO, "values": 5e-3},
        batch_size=batch_size, max_epoch=max_epoch, gen=gen, verbose=verbose)
    frozen = mixture_of({k: p.detach().clone()
                         for k, p in mix.params().items()}, mix.alive)
    xnv, ynv = scene.visualize_res
    adv = scene.advance_domain
    test_x = grid_points_2d(adv[0] * sf, adv[1] * sf, adv[2] * sf,
                            adv[3] * sf, xnv, ynv)
    return project_2d(
        mix, spec, frozen, 0.0, scene=scene, adv_domain=adv, test_x=test_x,
        gen=gen,
        weights=ProjectWeights(vor=1.0, div=10.0, aniso=10.0, vol=10.0,
                               delta_pos=0.0),
        boundary_lambda=10.0,
        lrs={"positions": 1e-4, "scalings": 1e-5,
             "rotations": 1e-5 * LR_RATIO, "values": 1e-4},
        batch_size=batch_size, max_epoch=min(10000, max_epoch),
        patience=10000, verbose=verbose)[0]


def advance_2d(init_cond: str, out_dir: str, dt: float, last_time: float,
               start_frame: int = 0, max_epoch: int = 20000,
               batch_size: int = 512, seed: int = 42, viz: bool = True,
               verbose: int = 1, test_res: Optional[tuple] = None,
               target_grid_res: int = 0, device="cuda", mesh=None):
    """Frame loop from gaussian_velocity_{start_frame}.pt; writes one
    checkpoint per frame. ``target_grid_res`` > 0 gives the clone and the
    projection their cached-target grids (``--target_grid``). Returns
    (mix, spec, frames), ``frames`` holding per frame its number, alive
    count, seconds (in all and per phase), the advance domain after it
    and the last test metrics of the clone and projection phases. The
    advance domain starts as the scene's at ``start_frame`` and moves
    after each advect (Karman's inflow).

    ``mesh`` (this rank's ``parallel.Mesh``, which sets the device): every
    clone re-fit and projection epoch runs sharded over it with exact
    per-epoch targets (so ``target_grid_res`` is refused), each batch row
    drawing from its own generator (``Mesh.generator``); the advect runs
    on every rank and rank 0's result is kept; rank 0 writes the
    checkpoints and figures. Every rank returns the same mixture.

    ``viz``: the start frame's figures (and those of up to two frames
    before it whose checkpoint exists but whose PNGs an interrupted run
    never drew), then every frame's, drawn asynchronously and flushed at
    the end."""
    if mesh is not None:
        from gaussian_fluids_torch.parallel import driver
        from gaussian_fluids_torch.parallel.mesh import refuse_target_grid
        refuse_target_grid(target_grid_res)
        device = mesh.device
    device = torch.device(device)
    scene = get_scene_2d(init_cond)
    sf = scene.scaling_factor
    adv_domain = scene.advance_domain_at(start_frame, dt)
    mix, spec = checkpoint.load_checkpoint(
        os.path.join(out_dir, f"gaussian_velocity_{start_frame}.pt"),
        device=device)
    gen = _generator(seed + start_frame, device)
    if mesh is not None:
        # rank 0's test metrics draw from the single-device generator
        gen, test_gen = mesh.generator(seed + start_frame), gen
    xnv, ynv = test_res or scene.visualize_res

    def test_grid(adv):
        return grid_points_2d(adv[0] * sf, adv[1] * sf, adv[2] * sf,
                              adv[3] * sf, xnv, ynv)

    draw = (mesh is None or mesh.writer) and viz2d.figures_on(viz,
                                                               FIGURES_2D)
    if draw:
        for k in range(max(0, start_frame - 2), start_frame):
            ck = os.path.join(out_dir, f"gaussian_velocity_{k}.pt")
            if (os.path.exists(ck) and not os.path.exists(
                    os.path.join(out_dir, f"divergence_{k}.png"))):
                m_k, _ = checkpoint.load_checkpoint(ck, device=device)
                _viz_frame(out_dir, str(k), m_k, spec, scene)
        _viz_frame(out_dir, str(start_frame), mix, spec, scene)

    frames = []
    t, cnt = 0.0, start_frame + 1
    while t < last_time:
        ft0 = time.perf_counter()
        adv_lo = (adv_domain[0] * sf, adv_domain[2] * sf)
        adv_hi = (adv_domain[1] * sf, adv_domain[3] * sf)
        if mesh is None:
            new_mix, clone_m = clone_velocity_field(
                mix, spec, lo=adv_lo, hi=adv_hi,
                test_x=test_grid(adv_domain), gen=gen, seed=cnt,
                max_epoch=max_epoch, batch_size=batch_size, verbose=verbose,
                target_grid_res=target_grid_res)
        else:
            new_mix, clone_m = driver.clone_velocity_field_sharded(
                mix, spec, mesh=mesh, lo=adv_lo, hi=adv_hi,
                test_x=test_grid(adv_domain), gen=gen, seed=cnt, d=2,
                max_epoch=max_epoch, batch_size=batch_size, verbose=verbose)
        ftc = time.perf_counter()
        new_mix = advect_covector_field_2d(new_mix, spec, dt)
        if mesh is not None:
            new_mix = driver.broadcast_mixture(new_mix, mesh)
        adv_domain = scene.extra_advect(adv_domain, dt)
        fta = time.perf_counter()
        w = ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                           delta_pos=0.5)
        if mesh is None:
            new_mix, proj_m = project_2d(
                new_mix, spec, mix, dt, scene=scene, adv_domain=adv_domain,
                test_x=test_grid(adv_domain), gen=gen, weights=w,
                boundary_lambda=1.0, batch_size=batch_size,
                max_epoch=max_epoch, verbose=verbose,
                target_grid_res=target_grid_res)
        else:
            new_mix, proj_m = driver.project_2d_sharded(
                new_mix, spec, mix, dt, mesh=mesh, scene=scene,
                adv_domain=adv_domain, test_x=test_grid(adv_domain), gen=gen,
                test_gen=test_gen, weights=w, boundary_lambda=1.0,
                batch_size=batch_size, max_epoch=max_epoch, verbose=verbose)
        mix = new_mix
        ft1 = time.perf_counter()
        if draw:
            _viz_frame(out_dir, str(cnt), mix, spec, scene,
                       asynchronous=True)
        ftv = time.perf_counter()
        if mesh is None or mesh.writer:
            checkpoint.save_checkpoint(
                os.path.join(out_dir, f"gaussian_velocity_{cnt}.pt"), mix,
                spec)
        ft2 = time.perf_counter()
        n_alive = mix.n_alive()
        if verbose:
            print(f"[frame {cnt}] solve {ft1 - ft0:.1f}s (clone "
                  f"{ftc - ft0:.1f} advect {fta - ftc:.1f} project "
                  f"{ft1 - fta:.1f}) viz {ftv - ft1:.1f}s save "
                  f"{ft2 - ftv:.1f}s (N={n_alive}/{mix.capacity})",
                  flush=True)
        frames.append({"frame": cnt, "n_alive": n_alive,
                       "capacity": mix.capacity, "seconds": ft2 - ft0,
                       "viz_seconds": ftv - ft1,
                       "clone_seconds": ftc - ft0,
                       "advect_seconds": fta - ftc,
                       "project_seconds": ft1 - fta,
                       "advance_domain": adv_domain,
                       "clone": clone_m, "project": proj_m})
        cnt += 1
        t += dt
    if draw:
        flush_viz()
    return mix, spec, frames
