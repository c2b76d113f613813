"""3D end-to-end flows: initialization and the frame loop
clone -> advect -> project -> save, as in the JAX package's
``solver/simulate3d.py`` run with ``viz=False`` (the VTI volumes and loss
plots are not ported yet).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.io import checkpoint
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.scenes import get_scene_3d
from gaussian_fluids_torch.solver.advect_field import advect_covector_field_3d
from gaussian_fluids_torch.solver.clone import clone_velocity_field
from gaussian_fluids_torch.solver.fit import fit_velocity_with_gradient
from gaussian_fluids_torch.solver.project import ProjectWeights, project_3d
from gaussian_fluids_torch.solver.simulate2d import _generator
from gaussian_fluids_torch.utils.grids import grid_points_3d

FIT_LRS_3D = {"positions": 1e-3, "scalings": 1e-3, "rotations": 1e-3,
              "values": 1e-3}


def _box(domain):
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    return (x_min, y_min, z_min), (x_max, y_max, z_max)


def initialize_3d(init_cond: str, out_dir: str, max_epoch: int = 500,
                  batch_size: int = 8192, seed: int = 42,
                  particle_count=None, verbose: int = 1, device="cuda"):
    """Fit the scene's ring field; writes gaussian_velocity_0.pt. Returns
    (mix, spec)."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    scene = get_scene_3d(init_cond)
    lo, hi = _box(scene.domain)
    xn, yn, zn = particle_count or scene.particle_count
    pos = grid_points_3d(*scene.domain, xn, yn, zn)
    spec = FieldSpec.create(lo, hi, pos.shape[0], d=3, vdim=3)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    print("Particle count:", pos.shape[0])
    mix = fit_velocity_with_gradient(
        mix, spec, scene.velocity, scene.velocity_jac, lo, hi,
        lrs=dict(FIT_LRS_3D), batch_size=batch_size, max_epoch=max_epoch,
        gen=_generator(seed, device), verbose=verbose)
    checkpoint.save_checkpoint(
        os.path.join(out_dir, "gaussian_velocity_0.pt"), mix, spec)
    return mix, spec


def advance_3d(init_cond: str, out_dir: str, dt: float, last_time: float,
               start_frame: int = 0, max_epoch: int = 20000,
               batch_size: int = 8192, boundary_lambda: float = 10.0,
               seed: int = 42, test_res: Optional[tuple] = None,
               verbose: int = 1, device="cuda"):
    """Frame loop from gaussian_velocity_{start_frame}.pt; writes one
    checkpoint per frame. Returns (mix, spec, frames), ``frames`` holding
    per frame its number, alive count, seconds per phase and the last test
    metrics of the clone and projection phases."""
    device = torch.device(device)
    scene = get_scene_3d(init_cond)
    domain = scene.domain
    lo, hi = _box(domain)
    mix, spec = checkpoint.load_checkpoint(
        os.path.join(out_dir, f"gaussian_velocity_{start_frame}.pt"),
        device=device)
    gen = _generator(seed + start_frame, device)
    xnv, ynv, znv = test_res or scene.visualize_res
    test_x = grid_points_3d(*domain, xnv, ynv, znv)

    frames = []
    t, cnt = 0.0, start_frame + 1
    while t < last_time:
        ft0 = time.perf_counter()
        new_mix, clone_m = clone_velocity_field(
            mix, spec, lo=lo, hi=hi, test_x=test_x, gen=gen, seed=cnt, d=3,
            batch_size=batch_size, max_epoch=max_epoch, verbose=verbose)
        ftc = time.perf_counter()
        new_mix = advect_covector_field_3d(new_mix, mix, spec, dt)
        fta = time.perf_counter()
        w = ProjectWeights(vor=1.0, div=1.0, aniso=10.0, vol=10.0,
                           delta_pos=0.0, hel=1.0, val_reg=0.0)
        new_mix, proj_m = project_3d(
            new_mix, spec, mix, dt, domain=domain, test_x=test_x, gen=gen,
            scene_name=init_cond, weights=w,
            boundary_lambda=boundary_lambda, batch_size=batch_size,
            max_epoch=max_epoch, verbose=verbose)
        mix = new_mix
        print(f"Wrote frame {cnt}")
        ft1 = time.perf_counter()
        checkpoint.save_checkpoint(
            os.path.join(out_dir, f"gaussian_velocity_{cnt}.pt"), mix, spec)
        ft2 = time.perf_counter()
        n_alive = mix.n_alive()
        if verbose:
            print(f"[frame {cnt}] solve {ft1 - ft0:.1f}s (clone "
                  f"{ftc - ft0:.1f} advect {fta - ftc:.1f} project "
                  f"{ft1 - fta:.1f}) save {ft2 - ft1:.1f}s "
                  f"(N={n_alive}/{mix.capacity})", flush=True)
        frames.append({"frame": cnt, "n_alive": n_alive,
                       "capacity": mix.capacity, "seconds": ft2 - ft0,
                       "clone_seconds": ftc - ft0,
                       "advect_seconds": fta - ftc,
                       "project_seconds": ft1 - fta,
                       "clone": clone_m, "project": proj_m})
        cnt += 1
        t += dt
    return mix, spec, frames
