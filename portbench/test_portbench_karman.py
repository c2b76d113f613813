"""The ``karman.project`` cell cut to CPU size: its frames thinned to a
seeded subset of their Gaussians (``tinycells.thinned``), fewer epochs, a
smaller batch and test grid; the program on the plain twins of the
centered kernels its card path takes. A sound run is ``correct``; the
control (the reference in bfloat16 pair arithmetic), the fault (half of
each batch left out), a program that drops half its batches and a step
that leaves the state unchanged each fail the cell's limits."""

import json
import time

import torch

from portbench import compare, harness, tinycells
from portbench.drivers import project_karman

WORKLOAD = "karman.project"
TINY = ({"max_epoch": 6, "patience": 6, "check_iter": 3, "batch": 256,
         "test_res": [12, 6]}, {"warm_epochs": 3, "trace_calls": 1})
BACKEND = "pallas"


def tiny_cell(tmp_path):
    cell = harness.find_cell(WORKLOAD)
    cell.config.update(TINY[0])
    cell.traffic.update(TINY[1])
    cell.config["frames"] = {
        f: str(tinycells.thinned(harness.ROOT / p, tmp_path / f"cut_{f}.pt"))
        for f, p in cell.config["frames"].items()}
    return cell


def run_tiny(tmp_path, monkeypatch, seed=3, trace=False):
    monkeypatch.setenv("GF_FIELD_BACKEND", BACKEND)
    return harness.run(tiny_cell(tmp_path), seed, 0.0, trace,
                       time.perf_counter(), require_card=False, device="cpu")


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    res = json.loads(json.dumps(run_tiny(tmp_path, monkeypatch,
                                         seed=2**31 + 7)))
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"project3d_ms_per_epoch", "setup_s"} == set(res["metrics"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_traced_run_reads_the_host_and_leaves_the_device_silent(
        tmp_path, monkeypatch):
    res = run_tiny(tmp_path, monkeypatch, trace=True)
    assert res["correct"] is True, res["checks"]
    # on the CPU no device operation is traced: the row-1 roofline and the
    # device's readers stay silent, the host's and the FLOPs' are read
    assert "host_ops_per_epoch.project3d" in res["metrics"]
    assert "mfu_pct.project3d" in res["metrics"]
    assert "gsr_fwd_roofline_pct.karman" not in res["metrics"]
    assert "device_idle_pct.project3d" not in res["metrics"]


def test_every_timed_call_follows_its_frames_reference(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("GF_FIELD_BACKEND", BACKEND)
    cell = tiny_cell(tmp_path)
    drv = project_karman.Driver(cell, 11, torch.device("cpu"))
    for i in range(2 * drv.cycle):
        drv.call(i)
    drv.release()
    gaps = drv.check()
    assert [f for f, _, _ in drv.records] == drv.frames * 2
    assert gaps["loss1_gap"] < 1e-5 and gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 1e-5 and gaps["step_gap"] < 1e-4
    # each frame on its own advance domain, as the frame loop's
    doms = {f: drv.domain(f) for f in drv.frames}
    assert doms[10][0] < doms[20][0] and doms[10][1:] == doms[20][1:]


def test_the_control_and_the_fault_fail_the_limits(tmp_path, monkeypatch):
    monkeypatch.setenv("GF_FIELD_BACKEND", BACKEND)
    cell = tiny_cell(tmp_path)
    drv = project_karman.Driver(cell, 5, torch.device("cpu"))
    for f in drv.frames:
        base = drv.reference_steps(f)
        for kw in ({"pair_dtype": torch.bfloat16}, {"half_batch": True}):
            checks = harness.judge(compare.training_gaps(
                drv.reference_steps(f, **kw), base), cell.limits)
            assert not all(c["ok"] for c in checks.values()), (f, kw)


def test_a_program_that_drops_half_its_batches_is_not_correct(
        tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import losses

    def half(fn):
        def f(*args):
            h = args[0].shape[0] // 2
            return fn(*(a[:h] for a in args))
        return f

    for name in ("vorticity_loss_2d", "divergence_loss",
                 "boundary_dirichlet_loss", "boundary_flux_loss"):
        monkeypatch.setattr(losses, name, half(getattr(losses, name)))
    assert run_tiny(tmp_path, monkeypatch)["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tmp_path, monkeypatch):
    from gaussian_fluids_torch.solver import optim
    monkeypatch.setattr(optim, "step",
                        lambda state, params, grads, metric: (params, state))
    res = run_tiny(tmp_path, monkeypatch)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]


def _loaded(code: str) -> set:
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=str(harness.ROOT),
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_karman_reference_loads_nothing_of_the_port():
    tops = _loaded("import portbench.reference.karman")
    assert "portbench" in tops
    assert not tops & ({"gaussian_fluids_torch"} | set(harness.FORBIDDEN))


def test_the_karman_driver_loads_no_jax():
    tops = _loaded("import portbench.drivers.project_karman\n"
                   "import portbench.calibrate_karman\n"
                   "import gaussian_fluids_torch.solver.covector")
    assert "gaussian_fluids_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
