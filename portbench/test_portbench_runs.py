"""Whole runs of the cells, cut to CPU size (``tinycells``): the result's
shape, the reference against the port's CPU path, the control and the
faults the check has to catch. The card is not looked for here
(``require_card=False``); the CLI itself refuses to run without one."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare, harness, tinycells
from portbench.drivers import project as project_driver
from portbench.reference import plain, projection, replay



def run_tiny(workload, tmp_path, monkeypatch, seed=3, trace=False):
    """One run of the cut cell, its program on the plain twins of its
    card path (``tinycells.BACKEND``)."""
    monkeypatch.setenv("GF_FIELD_BACKEND", tinycells.BACKEND[workload])
    cell = tinycells.tiny_cell(workload, tmp_path)
    return harness.run(cell, seed, 0.0, trace, time.perf_counter(),
                       require_card=False, device="cpu")


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "ring_collide.project", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=str(harness.ROOT), capture_output=True,
                         text=True)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("workload", ["ring_collide.project",
                                      "ring_collide.replay512"])
def test_a_sound_run_is_correct_and_its_line_has_the_contract_keys(
        workload, tmp_path, monkeypatch):
    res = run_tiny(workload, tmp_path, monkeypatch, seed=2**31 + 7)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert "setup_s" in line["metrics"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_traced_run_reports_per_layer_metrics(tmp_path, monkeypatch):
    res = run_tiny("ring_collide.project", tmp_path, monkeypatch,
                   trace=True)
    # on the CPU no device operation is traced: the device readers stay
    # silent, the host's are read
    assert "host_ops_per_epoch.project3d" in res["metrics"]
    assert "device_idle_pct.project3d" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_reference_follows_every_timed_call_of_the_ports_cpu_path(
        tmp_path, monkeypatch):
    workload = "ring_collide.project"
    monkeypatch.setenv("GF_FIELD_BACKEND", tinycells.BACKEND[workload])
    cell = tinycells.tiny_cell(workload, tmp_path)
    drv = project_driver.Driver(cell, 11, torch.device("cpu"))
    for i in range(2 * drv.cycle):
        drv.call(i)
    drv.release()
    gaps = drv.check()
    # every call on both frames compared; float32 both sides, the
    # quadratic form taken directly on both
    assert [f for f, _, _ in drv.records] == drv.frames * 2
    assert len(drv.call_gaps) == 4
    assert gaps["loss1_gap"] < 1e-5 and gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 1e-5 and gaps["step_gap"] < 1e-4


def test_replay_reference_matches_the_ports_cpu_step(tmp_path):
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.solver import simulate3d
    from portbench import frozen
    path = tinycells.thinned(harness.ROOT / "portbench/data/ring_collide_8.pt",
                             tmp_path / "f8.pt")
    cfg = harness.find_cell("ring_collide.replay512").config
    r = cfg["rings"][0]
    grid, dom = (12, 12, 12), tuple(cfg["domain"])
    dens = frozen.seed_ring_density(grid, dom, r["center"], r["normal"],
                                    r["radius"], r["thickness"])
    mix, spec = checkpoint.load_checkpoint(str(path), device="cpu")
    out = simulate3d.advected_density(dens, mix, spec, dom, 0.1, grid)
    idx = torch.arange(12 ** 3)
    ref = replay.step_at(str(path), dens, idx, dom, 0.1)
    assert compare.density_gap(out.reshape(-1), ref) < 1e-4


# ---- the control and the faults: each run has to come out not correct

def test_control_in_bfloat16_is_not_correct(tmp_path):
    cell = tinycells.tiny_cell("ring_collide.project", tmp_path)
    frame = str(next(iter(cell.config["frames"].values())))
    runs = [projection.first_steps(cell.config, frame, 5, "cpu", 3, dt)
            for dt in (torch.float32, torch.bfloat16)]
    ref, ctl = (compare.step_norms(r["losses"], r["grads"], r["delta"])
                for r in runs)
    checks = harness.judge(compare.training_gaps(ctl, ref), cell.limits)
    assert not all(c["ok"] for c in checks.values())
    # the replay's control on a whole frame, at nodes of a 128^3 grid
    # near the ring (on a coarse grid a backtrace's error stays inside a
    # cell and the control cannot show)
    from portbench import frozen
    cell = harness.find_cell("ring_collide.replay512")
    r = cell.config["rings"][0]
    grid, dom = (128, 128, 128), tuple(cell.config["domain"])
    dens = frozen.seed_ring_density(grid, dom, r["center"], r["normal"],
                                    r["radius"], r["thickness"])
    frame = str(harness.ROOT / cell.config["frames"]["8"])
    idx = replay.sample_nodes([dens], 512, 5, 4)
    ref = replay.step_at(frame, dens, idx, dom, 0.1)
    ctl = replay.step_at(frame, dens, idx, dom, 0.1, torch.bfloat16)
    checks = harness.judge({"density_gap": compare.density_gap(ctl, ref)},
                           cell.limits)
    assert not checks["density_gap"]["ok"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import optim
    monkeypatch.setattr(optim, "step",
                        lambda state, params, grads, metric: (params, state))
    res = run_tiny("ring_collide.project", tmp_path, monkeypatch)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]


def test_a_state_that_drifts_after_the_first_calls_is_not_correct(
        tmp_path, monkeypatch):
    """The window's first call on each frame is sound; each call then
    moves its start state in place, so only the later calls go wrong."""
    from gaussian_fluids_torch.solver import project
    workload = "ring_collide.project"
    monkeypatch.setenv("GF_FIELD_BACKEND", tinycells.BACKEND[workload])
    cell = tinycells.tiny_cell(workload, tmp_path)
    drv = project_driver.Driver(cell, 11, torch.device("cpu"))
    sound = project.project_3d

    def drifting(mix, *a, **k):
        out = sound(mix, *a, **k)
        mix.positions.add_(1e-3)
        return out

    monkeypatch.setattr(project, "project_3d", drifting)
    for i in range(2 * drv.cycle):
        drv.call(i)
    drv.release()
    checks = harness.judge(drv.check(), cell.limits)
    assert not all(c["ok"] for c in checks.values())
    epochs = [ran for _, ran, _ in drv.records]
    assert drv.failed(checks) == sum(epochs[drv.cycle:])


def test_half_of_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import losses

    def half(fn):
        def f(*args):
            h = args[0].shape[0] // 2
            return fn(*(a[:h] for a in args))
        return f

    for name in ("vorticity_loss_2d", "vorticity_loss_3d", "helicity_loss",
                 "divergence_loss"):
        monkeypatch.setattr(losses, name, half(getattr(losses, name)))
    assert run_tiny("ring_collide.project", tmp_path,
                    monkeypatch)["correct"] is False


def test_a_replay_step_that_returns_its_input_is_not_correct(
        tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import simulate3d
    monkeypatch.setattr(simulate3d, "advected_density",
                        lambda density, *a, **k: density.clone())
    assert run_tiny("ring_collide.replay512", tmp_path,
                    monkeypatch)["correct"] is False


def test_a_replay_answer_altered_where_it_is_made_is_not_correct(
        tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import simulate3d
    step = simulate3d.advected_density

    def altered(*a, **k):
        out = step(*a, **k)
        out.view(-1)[::7] += 0.25
        return out

    monkeypatch.setattr(simulate3d, "advected_density", altered)
    assert run_tiny("ring_collide.replay512", tmp_path,
                    monkeypatch)["correct"] is False


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "ring_collide.replay512", "--seed", "5",
                          "--seconds", "1", "--trace", "0"],
                         cwd=str(harness.ROOT), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
