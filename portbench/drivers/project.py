"""Projection epochs through the port's phase entries
(``gaussian_fluids_torch.solver.project.project_2d`` and ``project_3d``).

Set-up does what the frame loop does before a projection: each frame
named by the traffic is loaded from its frozen checkpoint and advected by
the port's own advect (the clone, which splits nothing at these frames,
is left out). A timed call is one frame's projection cut to
the configuration's ``max_epoch`` epochs, its patience unable to stop it, from that
frame's set-up state, its batches drawn from a generator seeded from
``--seed`` and the frame: every call on a frame does the same work. The
window's calls take the frames in turn; a cycle is one call on each.

The check follows the training rule on every timed call: the optimizer's
inputs of a call's first ``STEPS`` steps are recorded (each step's loss,
the first step's gradients and the parameters after the last), and once
the window has closed the plain reference works the same steps out from
the frozen checkpoint and the seed, once per frame, and each call's
record is compared with its frame's. The set-up's warm-up call
(``warm_epochs`` epochs on the frame the seed picks) is not compared.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys
import time
from types import SimpleNamespace

import torch

from portbench import compare, frozen
from portbench.harness import ROOT, RunError
from portbench.reference import plain
from portbench.reference import projection as reference

STEPS = 3


def gen_seed(seed: int, frame: int) -> int:
    """The batch generator's seed of a frame's calls."""
    return (int(seed) * 1_000_003 + int(frame)) % (1 << 62)


class Driver:
    unit = "epoch"

    def __init__(self, cell, seed: int, device: torch.device):
        from gaussian_fluids_torch.io import checkpoint
        from gaussian_fluids_torch.solver import advect_field, project
        from gaussian_fluids_torch.utils.grids import (grid_points_2d,
                                                       grid_points_3d)
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev = device
        self.seed = int(seed)
        self.d = int(self.cfg["d"])
        self.frames = [int(f) for f in self.tr["frames"]]
        self.cycle = len(self.frames)
        self.epochs = int(self.cfg["max_epoch"])
        self.weights = project.ProjectWeights(**self.cfg["weights"])
        dt = float(self.cfg["dt"])
        dom = tuple(float(v) for v in self.cfg["domain"])
        res = tuple(int(r) for r in self.cfg["test_res"])
        t0 = time.perf_counter()
        self.states = {}
        for f in self.frames:
            old, spec = checkpoint.load_checkpoint(self.frame_path(f),
                                                   device=device)
            if self.d == 3:
                mix = advect_field.advect_covector_field_3d(old, old, spec,
                                                            dt)
                test_x = grid_points_3d(*dom, *res)
            else:
                mix = advect_field.advect_covector_field_2d(old, spec, dt)
                sf = float(self.cfg["scaling_factor"])
                test_x = grid_points_2d(*(v * sf for v in dom), *res)
            start = {k: p.detach().clone() for k, p in mix.params().items()}
            self.states[f] = SimpleNamespace(mix=mix, old=old, spec=spec,
                                             test_x=test_x, start=start)
        # (frame, epochs run, the recorded steps: tensors until the
        # window has closed, then their norms)
        self.records = []
        t1 = time.perf_counter()
        warm = self.frames[self.seed % self.cycle]
        self._project(warm, int(self.tr["warm_epochs"]))
        self.synchronize()
        print(f"portbench: frames loaded and advected in {t1 - t0:.2f} s, "
              f"warm-up chunk {time.perf_counter() - t1:.2f} s",
              file=sys.stderr)

    def frame_path(self, frame: int) -> str:
        return str(ROOT / self.cfg["frames"][str(frame)])

    def _project(self, frame: int, epochs: int) -> int:
        """One projection call; returns the epochs it ran, as the phase
        reports them."""
        from gaussian_fluids_torch.scenes import get_scene_2d
        from gaussian_fluids_torch.solver import project
        st = self.states[frame]
        cfg = self.cfg
        gen = torch.Generator(device=self.dev).manual_seed(
            gen_seed(self.seed, frame))
        kw = dict(gen=gen, weights=self.weights,
                  boundary_lambda=float(cfg["boundary_lambda"]),
                  batch_size=int(cfg["batch"]), max_epoch=epochs,
                  patience=int(cfg["patience"]),
                  check_iter=int(cfg["check_iter"]), verbose=0)
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                torch.profiler.record_function(f"portbench.project_{self.d}d"):
            if self.d == 3:
                project.project_3d(st.mix, st.spec, st.old,
                                   float(cfg["dt"]),
                                   domain=tuple(cfg["domain"]),
                                   test_x=st.test_x, scene_name=cfg["scene"],
                                   **kw)
            else:
                project.project_2d(st.mix, st.spec, st.old,
                                   float(cfg["dt"]),
                                   scene=get_scene_2d(cfg["scene"]),
                                   adv_domain=tuple(cfg["domain"]),
                                   test_x=st.test_x, **kw)
        ran = re.findall(r"Total epoch:\s*(\d+)", out.getvalue())
        if not ran:
            raise RunError("the projection did not report its epochs")
        return int(ran[-1])

    def call(self, i: int) -> int:
        """One timed call, the optimizer's inputs of its first ``STEPS``
        steps recorded: each step's loss, the first step's gradients and
        the parameters after the last. The recorder steps aside after
        them, so the rest of the call runs as it would unobserved."""
        from gaussian_fluids_torch.solver import optim
        frame = self.frames[i % self.cycle]
        step = optim.step
        rec = {"losses": [], "grads": None, "after": None}

        def recorded(state, params, grads, metric):
            out = step(state, params, grads, metric)
            n = len(rec["losses"])
            rec["losses"].append(metric.detach().clone())
            if n == 0:
                rec["grads"] = {k: g.detach().clone()
                                for k, g in grads.items()}
            if n == STEPS - 1:
                rec["after"] = {k: p.detach().clone()
                                for k, p in out[0].items()}
                optim.step = step
            return out

        optim.step = recorded
        try:
            ran = self._project(frame, self.epochs)
        finally:
            optim.step = step
        self.records.append((frame, ran, rec))
        return ran

    def settle(self):
        """The recorded steps as the comparison reads them (host floats),
        their tensors dropped; a call that ran fewer than ``STEPS`` steps
        keeps None and fails the check."""
        out = []
        for frame, ran, rec in self.records:
            if isinstance(rec, dict) and "after" in rec:
                start = self.states[frame].start
                rec = None if rec["after"] is None else compare.step_norms(
                    [float(v) for v in rec["losses"]], rec["grads"],
                    {k: rec["after"][k] - start[k] for k in start})
            out.append((frame, ran, rec))
        self.records = out

    def synchronize(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def flops_per_unit(self) -> float:
        """One epoch's FLOPs on need, averaged over the traffic's frames:
        the support density of one of each frame's batches against the
        state its calls start from, as the reference advects it."""
        s = reference.Setting(self.cfg)
        total = 0.0
        for f in self.frames:
            old, spec = plain.load_checkpoint(self.frame_path(f), self.dev)
            start = reference.advected_start(old, spec, s.dt)
            gen = torch.Generator(device=self.dev).manual_seed(
                gen_seed(self.seed, f))
            x = reference.draw_epoch(s, gen)[0]
            n = start.positions.shape[0]
            density = plain.support_pairs(start, spec, x) / (x.shape[0] * n)
            total += frozen.projection_epoch_flops(self.d, s.batch, n,
                                                   density)
        return total / len(self.frames)

    def release(self):
        self.settle()
        self.states = {}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, frame: int, pair_dtype=torch.float32,
                        half_batch=False) -> dict:
        """The reference's first steps of ``frame``'s calls, as the
        comparison reads them."""
        ref = reference.first_steps(
            self.cfg, self.frame_path(frame), gen_seed(self.seed, frame),
            self.dev, STEPS, pair_dtype, half_batch)
        return compare.step_norms(ref["losses"], ref["grads"], ref["delta"])

    def check(self, pair_dtype=torch.float32, half_batch=False) -> dict:
        """The worst of every timed call's gaps to its frame's reference."""
        self.settle()
        refs = {f: self.reference_steps(f, pair_dtype, half_batch)
                for f in dict.fromkeys(fr for fr, _, _ in self.records)}
        self.call_gaps = []
        for frame, ran, rec in self.records:
            gaps = compare.training_gaps(rec, refs[frame]) \
                if rec is not None else {}
            self.call_gaps.append((ran, gaps))
        keys = {k for _, g in self.call_gaps for k in g}
        return {k: max(g.get(k, float("inf")) for _, g in self.call_gaps)
                for k in keys}

    def failed(self, checks: dict) -> int:
        """The epochs of the calls whose check failed."""
        def ok(gaps):
            return all(c["limit"] is not None
                       and gaps.get(k, float("inf")) <= c["limit"]
                       for k, c in checks.items())
        return sum(ran for ran, gaps in self.call_gaps if not ok(gaps))
