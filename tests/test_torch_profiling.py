"""``--profile``: the port's ``utils/profiling.py`` against the JAX
package's. No directory traces nothing; a directory gets a Chrome trace
of the run's operators; ``GF_PROFILE_SECONDS`` ends the capture at the
first chunk boundary past its window while the loop goes on; all five
entry points trace under ``--profile`` (each mesh rank into its own
directory); ``StepTimer.report`` has the JAX package's format."""

import json
import os
import time

import pytest
import torch

from gaussian_fluids_torch import (advance2d, advance3d, advance_density3d,
                                   initialize2d, initialize3d)
from gaussian_fluids_torch.solver.loop import run_chunked
from gaussian_fluids_torch.utils import profiling


def _names(path):
    with open(path) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_no_directory_traces_nothing(tmp_path):
    with profiling.maybe_trace(None) as cap:
        torch.ones(4).exp()
    assert cap is None and not os.listdir(tmp_path)


def test_a_directory_gets_a_trace_of_the_operators(tmp_path):
    from gaussian_fluids_torch.ops import field
    from torch_parity import jax_mixture, to_torch
    tm, ts = to_torch(*jax_mixture(64, 0))
    with profiling.maybe_trace(str(tmp_path), "cpu"):
        field.value_and_jac_centered(tm, ts, torch.zeros(16, 2))
    names = _names(tmp_path / "trace.json")
    assert "aten::exp" in names and "aten::mm" in names


def test_the_window_ends_the_capture_while_the_loop_runs(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("GF_PROFILE_SECONDS", "0.3")
    seen = []

    def dispatch(c, n):
        time.sleep(0.1)
        torch.ones(8).exp()
        return c + n, (1.0,)

    def on_chunk(mh, n):
        seen.append(cap.open)
        return False

    with profiling.maybe_trace(str(tmp_path), "cpu") as cap:
        run_chunked(0, dispatch, 10, 1, on_chunk, "t")
        # the loop ran on after the capture ended and was written
        assert not cap.open and (tmp_path / "trace.json").exists()
    assert seen[0] and not seen[-1] and seen.count(False) >= 5


@pytest.mark.parametrize("module, fn", [
    (initialize2d, "initialize_2d"), (advance2d, "advance_2d"),
    (initialize3d, "initialize_3d"), (advance3d, "advance_3d"),
    (advance_density3d, "advance_density")])
def test_every_entry_point_traces_under_profile(module, fn, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(module, fn, lambda *a, **k: torch.ones(8).exp())
    module.main(["--device", "cpu", "--profile", str(tmp_path)])
    assert "aten::exp" in _names(tmp_path / "trace.json")


@pytest.mark.parametrize("module, fn", [
    (advance2d, "advance_2d"), (advance3d, "advance_3d"),
    (advance_density3d, "advance_density")])
def test_each_mesh_rank_traces_itself(module, fn, tmp_path, monkeypatch):
    """Under --mesh the launching process traces nothing and hands the
    directory to the ranks; rank r writes DIR/rank{r}/trace.json."""
    seen = {}
    monkeypatch.setattr(module, "launch",
                        lambda f, shape, args, **k: seen.update(args=args)
                        or [None])
    module.main(["--device", "cpu", "--mesh", "2", "--profile",
                 str(tmp_path)])
    assert seen["args"][-1] == str(tmp_path)
    assert not os.listdir(tmp_path)

    class Rank:
        rank, device = 1, torch.device("cpu")
    monkeypatch.setattr(module, fn, lambda *a, **k: torch.ones(8).exp())
    module._rank_main(Rank, *seen["args"])
    assert "aten::exp" in _names(tmp_path / "rank1" / "trace.json")


def test_step_timer_reports_as_the_jax_package():
    from gaussian_fluids_tpu.utils import profiling as jprof
    a, b = profiling.StepTimer(), jprof.StepTimer()
    for t in (a, b):
        t.totals.update({"project": 1.25, "clone": 0.5})
        t.counts.update({"project": 3, "clone": 2})
    assert a.report() == b.report()
    with a.phase("x", sync=lambda: [torch.ones(2)]):
        pass
    assert a.counts["x"] == 1 and "x: " in a.report()
