"""Karman's projection epochs through the port's ``project_2d``, each frame
on its own advance domain.

``drivers/project.Driver`` with two changes. Karman's advance domain
moves with the inflow, so the projection that makes frame f + 1 from the
checkpoint of frame f runs on ``Scene2D.advance_domain_at(f + 1, dt)``, as
the frame loop's does after ``extra_advect``: its data batch, its edges,
the target's outside mask and the test grid (``test_res`` nodes over that
domain) all take it. And the reference is ``reference/karman.py``, whose
epoch adds the cylinder's Dirichlet term and the five edges' flux term.
Set-up, the window's calls, the recorded steps and the check are the base
driver's.
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
from portbench.drivers import project
from portbench.harness import RunError
from portbench.reference import karman as reference
from portbench.reference import plain
from portbench.reference import projection as ref_projection


class Driver(project.Driver):

    def __init__(self, cell, seed: int, device: torch.device):
        from gaussian_fluids_torch.io import checkpoint
        from gaussian_fluids_torch.scenes import get_scene_2d
        from gaussian_fluids_torch.solver import advect_field
        from gaussian_fluids_torch.solver import project as port_project
        from gaussian_fluids_torch.utils.grids import grid_points_2d
        self.cfg, self.tr = cell.config, cell.traffic
        self.dev = device
        self.seed = int(seed)
        self.d = 2
        self.frames = [int(f) for f in self.tr["frames"]]
        self.cycle = len(self.frames)
        self.epochs = int(self.cfg["max_epoch"])
        self.weights = port_project.ProjectWeights(**self.cfg["weights"])
        self.scene = get_scene_2d(self.cfg["scene"])
        dt = float(self.cfg["dt"])
        sf = float(self.cfg["scaling_factor"])
        nx, ny = (int(r) for r in self.cfg["test_res"])
        t0 = time.perf_counter()
        self.states = {}
        for f in self.frames:
            old, spec = checkpoint.load_checkpoint(self.frame_path(f),
                                                   device=device)
            mix = advect_field.advect_covector_field_2d(old, spec, dt)
            dom = self.domain(f)
            test_x = grid_points_2d(dom[0] * sf, dom[1] * sf, dom[2] * sf,
                                    dom[3] * sf, nx, ny)
            start = {k: p.detach().clone() for k, p in mix.params().items()}
            self.states[f] = SimpleNamespace(mix=mix, old=old, spec=spec,
                                             test_x=test_x, start=start,
                                             domain=dom)
        self.records = []
        t1 = time.perf_counter()
        warm = self.frames[self.seed % self.cycle]
        self._project(warm, int(self.tr["warm_epochs"]))
        self.synchronize()
        print(f"portbench: frames loaded and advected in {t1 - t0:.2f} s, "
              f"warm-up chunk {time.perf_counter() - t1:.2f} s",
              file=sys.stderr)

    def domain(self, frame: int) -> tuple:
        """The advance domain of the projection that makes frame + 1."""
        return self.scene.advance_domain_at(frame + 1, float(self.cfg["dt"]))

    def _project(self, frame: int, epochs: int) -> int:
        from gaussian_fluids_torch.solver import project as port_project
        st = self.states[frame]
        cfg = self.cfg
        gen = torch.Generator(device=self.dev).manual_seed(
            project.gen_seed(self.seed, frame))
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                torch.profiler.record_function("portbench.project_2d"):
            port_project.project_2d(
                st.mix, st.spec, st.old, float(cfg["dt"]), scene=self.scene,
                adv_domain=st.domain, test_x=st.test_x, gen=gen,
                weights=self.weights,
                boundary_lambda=float(cfg["boundary_lambda"]),
                batch_size=int(cfg["batch"]),
                max_epoch=epochs, patience=int(cfg["patience"]),
                check_iter=int(cfg["check_iter"]), verbose=0)
        ran = re.findall(r"Total epoch:\s*(\d+)", out.getvalue())
        if not ran:
            raise RunError("the projection did not report its epochs")
        return int(ran[-1])

    def flops_per_unit(self) -> float:
        """One epoch's FLOPs on need, averaged over the traffic's frames:
        the data rows as ``frozen.projection_epoch_flops`` counts them
        (five target forwards, the heads' forward and dual backward), and
        the cylinder's and the edges' rows each a value-only forward and
        half a parameter backward, every part at the support density of
        one of its batches against the state the calls start from."""
        f_fwd = frozen.fwd_flops_per_pair(2, 2, 2)
        f_data = 6 * f_fwd + frozen.DUAL_FACTOR * (
            frozen.bwd_dx_flops_per_pair(2, 2)
            + frozen.bwd_dn_flops_per_pair(2, 2))
        f_bnd = (frozen.fwd_flops_per_pair(2, 2, 0)
                 + 0.5 * frozen.bwd_dn_flops_per_pair(2, 2))
        total = 0.0
        for f in self.frames:
            s = reference.setting(self.cfg, f)
            old, spec = plain.load_checkpoint(self.frame_path(f), self.dev)
            start = ref_projection.advected_start(old, spec, s.dt)
            gen = torch.Generator(device=self.dev).manual_seed(
                project.gen_seed(self.seed, f))
            x, (cx, _), (ex, _, _) = reference.draw_epoch(s, self.cfg, gen)
            total += (plain.support_pairs(start, spec, x) * f_data
                      + (plain.support_pairs(start, spec, cx)
                         + plain.support_pairs(start, spec, ex)) * f_bnd)
        return total / len(self.frames)

    def reference_steps(self, frame: int, pair_dtype=torch.float32,
                        half_batch=False) -> dict:
        ref = reference.first_steps(
            self.cfg, frame, self.frame_path(frame),
            project.gen_seed(self.seed, frame), self.dev, project.STEPS,
            pair_dtype, half_batch)
        return compare.step_norms(ref["losses"], ref["grads"], ref["delta"])
