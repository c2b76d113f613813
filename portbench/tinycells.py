"""The benchmark's cells cut to a size the CPU tests can hold: the same
configuration, traffic, driver, reference and limits, with fewer epochs,
smaller test grids and batches, a 32^3 replay grid, and the 3D frames
thinned to a seeded subset of their Gaussians (the replay's cut to the
box around the rings). Used by the tests beside
this file only; a cut cell never measures anything.

``BACKEND`` is the field path each cell's program takes on the CPU
(``GF_FIELD_BACKEND``): the plain twins of the kernels the card runs for
it, which take the quadratic form directly as the kernels and the plain
reference do, with the card's sorts and hoisted targets. The port's
default CPU path, the dense one, expands the form into a matrix product
over polynomial features; where curl and divergence are small beside the
Jacobian's entries (the thinned 3D frames) its cancellation alone reads
gaps of 1e-4."""

from __future__ import annotations

from pathlib import Path

import torch

from portbench import harness

TINY = {
    "ring_collide.project": ({"max_epoch": 6, "patience": 6,
                              "check_iter": 3, "batch": 256,
                              "test_res": [6, 6, 6]},
                             {"warm_epochs": 3, "trace_calls": 1}),
    "ring_collide.replay512": ({}, {"grid": [32, 32, 32], "chunk": 16384,
                                    "check_nodes": 512, "check_margin": 3,
                                    "trace_calls": 2}),
}
THIN = 1500   # Gaussians kept of a 3D frame for the projection
# the replay keeps the Gaussians around the rings instead, so that the
# flow there, and the step's motion of the densities, stay as they are
CROP = ((0.3, 0.7), (0.38, 0.62), (0.38, 0.62))
BACKEND = {"ring_collide.project": "cells", "ring_collide.replay512": "auto"}


def thinned(path: Path, out: Path, keep: int = THIN) -> Path:
    data = torch.load(path, map_location="cpu", weights_only=True)
    n = data["positions"].shape[0]
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    rows = rows[:keep]
    torch.save({k: (v[rows].clone() if isinstance(v, torch.Tensor) else v)
                for k, v in data.items()}, out)
    return out


def cropped(path: Path, out: Path, box=CROP) -> Path:
    data = torch.load(path, map_location="cpu", weights_only=True)
    p = data["positions"]
    rows = torch.ones(p.shape[0], dtype=torch.bool)
    for k, (lo, hi) in enumerate(box):
        rows &= (p[:, k] >= lo) & (p[:, k] <= hi)
    torch.save({k: (v[rows].clone() if isinstance(v, torch.Tensor) else v)
                for k, v in data.items()}, out)
    return out


def tiny_cell(workload: str, tmp: Path) -> harness.Cell:
    cell = harness.find_cell(workload)
    cfg, tr = TINY[workload]
    cell.config.update(cfg)
    cell.traffic.update(tr)
    cut = cropped if cell.traffic["kind"] == "replay" else thinned
    cell.config["frames"] = {
        f: str(cut(harness.ROOT / p, tmp / f"cut_{f}.pt"))
        for f, p in cell.config["frames"].items()}
    return cell
