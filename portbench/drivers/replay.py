"""Density steps through the port's replay entry
(``gaussian_fluids_torch.solver.simulate3d.advected_density``).

Set-up does what the replay loop does for each frame, for every frame the
traffic names: the frozen checkpoint is loaded, ordered slab-major and
given its band; the densities are seeded on the grid from the
configuration's rings (the benchmark's own copy of the seeding). A timed
call advects one density one frame, from its seeded state, so every
call on a (density, frame) pair does the same work; the calls take the
densities in turn within a frame and the frames in turn, as the replay
loop does. No volume is written. After each call the benchmark keeps the
advected density at nodes drawn from the seed; the plain reference works
the same nodes out again after the window.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import compare, frozen
from portbench.harness import ROOT
from portbench.reference import plain
from portbench.reference import replay as reference


class Driver:
    unit = "density step"

    def __init__(self, cell, seed: int, device: torch.device):
        from gaussian_fluids_torch.io import checkpoint
        from gaussian_fluids_torch.solver import simulate3d
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev = device
        self.seed = int(seed)
        self.domain = tuple(float(v) for v in self.cfg["domain"])
        self.grid = tuple(int(g) for g in self.tr["grid"])
        self.dt = float(self.tr["dt"])
        self.chunk = int(self.tr["chunk"])
        self.frames = [int(f) for f in self.tr["frames"]]
        t0 = time.perf_counter()
        rings = self.cfg["rings"][:int(self.tr["densities"])]
        self.densities = [frozen.seed_ring_density(
            self.grid, self.domain, r["center"], r["normal"], r["radius"],
            r["thickness"], device=device) for r in rings]
        t1 = time.perf_counter()
        self.mixes = {}
        with torch.profiler.record_function("portbench.replay_prepare"):
            for f in self.frames:
                mix, spec = checkpoint.load_checkpoint(self.frame_path(f),
                                                       device=device)
                mix = mix.slab_sorted(spec.clamp_threshold)
                band = (simulate3d._suggest_band(mix, spec, self.dt,
                                                 chunk=self.chunk)
                        if device.type == "cuda" else None)
                self.mixes[f] = (mix, spec, band)
        self.order = [(j, f) for f in self.frames
                      for j in range(len(self.densities))]
        self.cycle = len(self.order)
        self.nodes = reference.sample_nodes(
            self.densities, int(self.tr["check_nodes"]), self.seed,
            int(self.tr["check_margin"])).to(device)
        self.samples = {k: [] for k in self.order}
        t2 = time.perf_counter()
        self.call(0)   # warm-up: builds the grid's chunks and the kernels
        self.synchronize()
        print(f"portbench: densities seeded in {t1 - t0:.2f} s, frames "
              f"prepared {t2 - t1:.2f} s, warm-up step "
              f"{time.perf_counter() - t2:.2f} s", file=sys.stderr)

    def frame_path(self, frame: int) -> str:
        return str(ROOT / self.cfg["frames"][str(frame)])

    def call(self, i: int) -> int:
        from gaussian_fluids_torch.solver import simulate3d
        j, f = self.order[i % self.cycle]
        mix, spec, band = self.mixes[f]
        with torch.profiler.record_function("portbench.advected_density"):
            out = simulate3d.advected_density(
                self.densities[j], mix, spec, self.domain, self.dt,
                self.grid, chunk=self.chunk, band=band)
        self.samples[(j, f)].append(out.reshape(-1)[self.nodes])
        return 1

    def synchronize(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def flops_per_unit(self) -> float:
        """One density step's FLOPs on need: the support density of the
        sampled nodes against the frames' fields, averaged over frames."""
        nodes = self.grid[0] * self.grid[1] * self.grid[2]
        total = 0.0
        for f in self.frames:
            mix, spec = plain.load_checkpoint(self.frame_path(f), self.dev)
            x = reference.node_points(self.nodes, self.grid, self.domain)
            n = mix.positions.shape[0]
            density = plain.support_pairs(mix, spec, x) / (x.shape[0] * n)
            total += frozen.replay_step_flops(nodes, n, density)
        return total / len(self.frames)

    def release(self):
        self.mixes = {}
        self.samples = {k: torch.stack(v).cpu() if v else None
                        for k, v in self.samples.items()}
        from gaussian_fluids_torch.solver import simulate3d
        simulate3d._grid_chunks_device.cache_clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, pair_dtype=torch.float32) -> dict:
        gap = 0.0
        self.step_gaps = []
        for (j, f), prog in self.samples.items():
            if prog is None:
                continue
            ref = reference.step_at(self.frame_path(f), self.densities[j],
                                    self.nodes, self.domain, self.dt,
                                    pair_dtype).cpu()
            for row in prog:
                g = compare.density_gap(row, ref)
                self.step_gaps.append(g)
                gap = max(gap, g)
        return {"density_gap": gap}

    def failed(self, checks: dict) -> int:
        lim = checks["density_gap"]["limit"]
        if lim is None:
            return len(self.step_gaps)
        return sum(1 for g in self.step_gaps if not g <= lim)
