"""Seeded states at the sizes of the main paths — Leapfrog-2D, Karman-2D
and Ring-Collide (3D): the inputs at which the smoke run checks each CUDA
kernel against its plain version, the card tests repeat those checks, and
the epoch profiler times a training epoch."""

from __future__ import annotations

import numpy as np
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.utils.grids import grid_points_2d, grid_points_3d


def leapfrog_state(device, seed: int = 0):
    """A Leapfrog-2D-sized mixture (the scene's 71x71 grid in [-5, 5]^2,
    capacity 6144, sorted along x as the solver keeps it) with seeded
    random shapes and values, and 512 sorted query points."""
    rng = np.random.RandomState(seed)
    pos = grid_points_2d(-5, 5, -5, 5, 71, 71)
    spec = FieldSpec.create((-5.0, -5.0), (5.0, 5.0), pos.shape[0], d=2,
                            vdim=2)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    cap = mix.capacity
    mix.scalings += torch.as_tensor(
        rng.uniform(-0.3, 0.3, (cap, 2)).astype(np.float32), device=device)
    mix.rotations += torch.as_tensor(
        rng.uniform(-1, 1, cap).astype(np.float32), device=device)
    mix.values = torch.as_tensor(
        (0.5 * rng.randn(cap, 2)).astype(np.float32),
        device=device) * mix.alive[:, None]
    x = rng.uniform(-5, 5, (512, 2)).astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0])], device=device)
    return mix, spec, x


def ring_collide_state(device, seed: int = 0, n_queries: int = 8192,
                       side: int = 40):
    """A Ring-Collide-sized mixture (the scene's 40^3 grid in [0, 1]^3,
    capacity 75,776, sorted along x as the solver keeps it) with seeded
    jitter of shapes, quaternions and values, and ``n_queries`` sorted
    query points (the scene's batch, 8192, by default). ``side`` 10 gives
    the Leapfrog-3D grid (1000 Gaussians, capacity 1024) for the tests."""
    rng = np.random.RandomState(seed)
    pos = grid_points_3d(0, 1, 0, 1, 0, 1, side, side, side)
    spec = FieldSpec.create((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), pos.shape[0],
                            d=3, vdim=3)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    cap = mix.capacity
    mix.scalings += torch.as_tensor(
        rng.uniform(-0.3, 0.3, (cap, 3)).astype(np.float32), device=device)
    mix.rotations += torch.as_tensor(
        rng.uniform(-0.3, 0.3, (cap, 4)).astype(np.float32), device=device)
    mix.values = torch.as_tensor(
        (0.1 * rng.randn(cap, 3)).astype(np.float32),
        device=device) * mix.alive[:, None]
    x = rng.uniform(0, 1, (n_queries, 3)).astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0])], device=device)
    return mix, spec, x


def karman_state(device, seed: int = 0, n_queries: int = 512):
    """A Karman-2D-sized mixture (the scene's 400x60 grid over its scaled
    initialize domain, 24,000 Gaussians, capacity 24,576, sorted along x)
    with seeded jitter of shapes and values around the uniform inflow, and
    ``n_queries`` sorted query points in the domain (the scene's batch,
    512, by default)."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    scene = get_scene_2d("karman")
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    lo, hi = (x0 * sf, y0 * sf), (x1 * sf, y1 * sf)
    rng = np.random.RandomState(seed)
    pos = grid_points_2d(lo[0], hi[0], lo[1], hi[1], *scene.particle_count)
    spec = FieldSpec.create(lo, hi, pos.shape[0], d=2, vdim=2)
    mix = GaussianMixture.create(pos, spec, device=device).spatially_sorted()
    cap = mix.capacity
    mix.scalings += torch.as_tensor(
        rng.uniform(-0.3, 0.3, (cap, 2)).astype(np.float32), device=device)
    mix.rotations += torch.as_tensor(
        rng.uniform(-1, 1, cap).astype(np.float32), device=device)
    inflow = np.float32([scene.info["v_magnitude"] * sf, 0.0])
    mix.values = torch.as_tensor(
        (0.1 * inflow[0] * rng.randn(cap, 2) + inflow).astype(np.float32),
        device=device) * mix.alive[:, None]
    x = rng.uniform(lo, hi, (n_queries, 2)).astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0])], device=device)
    return mix, spec, x


def karman_boundary_rows(scene, gen, n, device):
    """The Karman scene's boundary batches as one projection epoch draws
    them (the cylinder's n Dirichlet points, the edges' 5n flux points),
    sorted along x as one segment, with the order that undoes the sort:
    the boundary rows of the fused [data; boundary] projection geometry."""
    adv = torch.tensor(scene.advance_domain, device=device)
    b1 = scene.boundary_sampler_1(gen, n, adv)
    b2 = scene.boundary_sampler_2(gen, n, adv)
    pts = torch.cat([b1[0], b2[0]])
    order = torch.argsort(pts[:, 0])
    return pts[order].contiguous(), torch.argsort(order), b1, b2
