"""Where a training epoch's time goes, at Leapfrog-2D, Leapfrog-3D and
Ring-Collide width.

    python -m gaussian_fluids_torch.epoch_profile [--epochs 20]
        [--config leapfrog_2d|leapfrog_3d|ring_collide]
        [--epoch fit|clone|project]

For one fit, clone re-fit and projection epoch each (the three epoch
kinds of the 2D and the 3D path) on a seeded Leapfrog-2D state (71x71 =
5041 Gaussians, B = 512), a seeded Leapfrog-3D state (10^3 = 1000
Gaussians, capacity 1024, B = 8192; the centered kernels at d = 3, the
hoisted sweeps on the cells kernels) and a seeded Ring-Collide state
(40^3 = 64,000 Gaussians, capacity 75,776, B = 8192; the cells kernels):
the wall time per epoch, unprofiled and under the profiler, and from
``torch.profiler`` the device time per epoch, the device's busy share
(device time over wall time; kernels run on one stream, so this is their
union), the operators the host dispatches and the device launches per
epoch, and the device time by kernel name. Clone and projection epochs
run as the solver runs them, in chunks through the runners'
``run_chunk`` (100 epochs in 2D, the solver's check_iter: one sweep of
51,200 rows; 25 in 3D, one sweep of 204,800, of which the solver's chunk
of 100 runs four), their exact targets hoisted unless
``GF_HOIST_TARGETS=0`` (the line's ``hoist``); the timed epochs are
rounded up to whole chunks.
Prints one JSON line per configuration and epoch kind, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_fluids_torch.scenes import get_scene_2d, get_scene_3d
from gaussian_fluids_torch.solver import clone, fit, optim, project
from gaussian_fluids_torch.solver.loop import hoist_default
from gaussian_fluids_torch.solver.simulate3d import FIT_LRS_3D
from gaussian_fluids_torch.utils.seeded_state import (leapfrog_state,
                                                      ring_collide_state)


def _steps(epoch_fit, fit_c, fit_input, chunk_fns, chunk):
    """{kind: (step(), epochs per call)}: a fit step runs one epoch on a
    fresh batch; clone and projection steps one chunk of ``chunk`` epochs
    through their runner's ``run_chunk`` (hoisted by the solver's gate,
    ``loop.hoist_default``), each carrying its own state."""
    def fit_step():
        fit_c[0] = epoch_fit(fit_c[0], fit_input())[0]

    def chunked(run_chunk, carry, gen, hoist):
        def step():
            carry[0] = run_chunk(carry[0], gen, chunk, hoist)
        return step

    out = {"fit": (fit_step, 1)}
    for kind, (run_chunk, carry, gen) in chunk_fns.items():
        hoist = hoist_default(carry[0][2])
        out[kind] = (chunked(run_chunk, carry, gen, hoist), chunk)
    return out


def _epochs(mix, spec, device, chunk: int = 100):
    """The Leapfrog-2D steps (``_steps``)."""
    scene = get_scene_2d("leapfrog")
    gen = torch.Generator(device=device).manual_seed(0)
    lo = torch.full((2,), -5.0, device=device)
    hi = torch.full((2,), 5.0, device=device)
    p = mix.params()

    fit_epoch = fit.make_fit_epoch(spec, scene.target_velocity,
                                   scene.target_velocity_jac)
    fit_c = [(p, optim.init(p, dict(fit.FIT_LRS_2D)), mix.alive)]

    clone_run = clone._clone_runner(spec, 512, (-5.0, -5.0),
                                    (5.0, 5.0)).run_chunk
    stop = torch.rand(mix.capacity, generator=gen, device=device) > 0.1
    clone_c = [(p, optim.init(p, clone.DEFAULT_LRS_CLONE_2D), mix.alive,
                stop, mix)]

    proj_run = project._runner_2d(
        spec, "leapfrog", project.ProjectWeights(), 1.0, 512).run_chunk
    adv = torch.tensor(scene.advance_domain, device=device)
    proj_c = [(p, optim.init(p, project.DEFAULT_LRS_2D), mix.alive,
               mix.positions, mix, adv, 0.025)]
    return _steps(fit_epoch, fit_c,
                  lambda: fit.uniform_batch(gen, 512, lo, hi),
                  {"clone": (clone_run, clone_c, gen),
                   "project": (proj_run, proj_c, gen)}, chunk)


def _epochs_3d(mix, spec, device, batch: int = 8192,
               scene_name: str = "ring_collide", chunk: int = 100):
    """The same for the 3D epochs of a scene in the unit cube (ring_collide
    or leapfrog)."""
    scene = get_scene_3d(scene_name)
    gen = torch.Generator(device=device).manual_seed(0)
    lo = torch.zeros(3, device=device)
    hi = torch.ones(3, device=device)
    p = mix.params()

    fit_epoch = fit.make_fit_epoch(spec, scene.velocity, scene.velocity_jac)
    fit_c = [(p, optim.init(p, dict(FIT_LRS_3D)), mix.alive)]

    clone_run = clone._clone_runner(spec, batch, (0.0,) * 3,
                                    (1.0,) * 3).run_chunk
    stop = torch.rand(mix.capacity, generator=gen, device=device) > 0.1
    clone_c = [(p, optim.init(p, clone.DEFAULT_LRS_CLONE_3D), mix.alive,
                stop, mix)]

    proj_run = project._runner_3d(
        spec, scene_name, project.ProjectWeights(delta_pos=0.0), 10.0,
        batch, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)).run_chunk
    proj_c = [(p, optim.init(p, project.DEFAULT_LRS_3D), mix.alive, mix,
               0.02)]
    return _steps(fit_epoch, fit_c,
                  lambda: fit.uniform_batch(gen, batch, lo, hi),
                  {"clone": (clone_run, clone_c, gen),
                   "project": (proj_run, proj_c, gen)}, chunk)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_epoch(step, epochs: int, per_call: int = 1) -> dict:
    """Per epoch: wall ms unprofiled and profiled, device ms, busy share,
    host operators and launches, over ``step`` calls covering at least
    ``epochs`` epochs (``per_call`` epochs a call), after warm-up calls
    (3, or 1 of a chunked step)."""
    calls = max(1, -(-epochs // per_call))
    for _ in range(3 if per_call == 1 else 1):   # allocator, caches
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    epochs = calls * per_call
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # operators the host dispatched itself (not nested inside another)
    host_ops = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("aten::") and e.cpu_parent is None)
    dev_us = sum(_device_us(e) for e in dev)
    launches = sum(e.count for e in dev)
    top = sorted(dev, key=_device_us, reverse=True)[:8]
    return {
        "epochs": epochs,
        "wall_ms_per_epoch": 1e3 * plain_wall / epochs,
        "ms_per_epoch": 1e3 * wall / epochs,
        "device_ms_per_epoch": dev_us / 1e3 / epochs,
        "device_busy_share": dev_us / 1e6 / wall,
        "host_ops_per_epoch": host_ops / epochs,
        "device_launches_per_epoch": launches / epochs,
        "top_kernels_ms_per_epoch": [[e.key[:80], _device_us(e) / 1e3 / epochs]
                                     for e in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--config",
                    choices=("leapfrog_2d", "leapfrog_3d", "ring_collide"))
    ap.add_argument("--epoch", choices=("fit", "clone", "project"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("epoch_profile: needs a CUDA GPU")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configs = (("leapfrog_2d", leapfrog_state, _epochs, 100),
               ("leapfrog_3d",
                functools.partial(ring_collide_state, side=10),
                functools.partial(_epochs_3d, scene_name="leapfrog"), 25),
               ("ring_collide", ring_collide_state, _epochs_3d, 25))
    for name, state, epochs, chunk in configs:
        if args.config not in (None, name):
            continue
        mix, spec, _ = state(device)
        steps = epochs(mix, spec, device, chunk=chunk)
        for kind, (step, per_call) in steps.items():
            if args.epoch not in (None, kind):
                continue
            print(json.dumps({"config": name, "epoch": kind,
                              "hoist": per_call > 1
                              and hoist_default(mix.alive),
                              "chunk": per_call,
                              **profile_epoch(step, args.epochs, per_call)}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
