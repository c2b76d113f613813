"""``--profile``: the port's ``utils/profiling.py`` against the JAX
package's. No directory traces nothing; a directory gets a Chrome trace
of the run's operators; ``GF_PROFILE_SECONDS`` ends the capture at the
first chunk boundary past its window while the loop goes on; all five
entry points trace under ``--profile`` (each mesh rank into its own
directory). The port's spans and counters (``span``, ``counting``,
``count``): nothing kept outside a port scope; each documented ``gf.*``
span emitted and nested as documented under a capture; the live-tile
counter against the mask; no result moved by either."""

import json
import os
import time

import numpy as np
import pytest
import torch

from gaussian_fluids_torch import (advance2d, advance3d, advance_density3d,
                                   initialize2d, initialize3d)
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.solver import project, simulate3d
from gaussian_fluids_torch.solver.loop import run_chunked
from gaussian_fluids_torch.utils import profiling
from gaussian_fluids_torch.utils.grids import grid_points_3d
from gaussian_fluids_torch.utils.seeded_state import ring_collide_state


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


# ---- spans and counters ----

DOMAIN3 = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)

# each documented span and the span it opens in (None: at the top)
PROJECTION_SPANS = {
    "gf.chunk.draws": None, "gf.chunk.sort": None, "gf.chunk.targets": None,
    "gf.epoch": None, "gf.epoch.sort": "gf.epoch",
    "gf.epoch.targets": "gf.epoch", "gf.epoch.heads": "gf.epoch",
    "gf.epoch.rest": "gf.epoch", "gf.epoch.pcgrad": "gf.epoch",
    "gf.epoch.adam": "gf.epoch", "gf.test": None, "gf.test.targets": None}
WORK_LIST_PARENTS = {"gf.epoch.heads", "gf.epoch.rest", "gf.epoch.targets",
                     "gf.chunk.targets", "gf.test", "gf.test.targets"}


def _gf_spans(prof):
    """[(name, parent)] of the capture's gf.* host spans, the parent the
    innermost gf.* span that holds it on its thread (None: none)."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("gf.")
           and e.device_type() == torch.autograd.DeviceType.CPU]
    out = []
    for name, s, e, tid in evs:
        holders = [h for h in evs if h[3] == tid and h[1] <= s and e <= h[2]
                   and (h[1], -h[2]) < (s, -e)]
        parent = max(holders, key=lambda h: (h[1], -h[2]))[0] \
            if holders else None
        out.append((name, parent))
    return out


def _small_projection(monkeypatch, hoist):
    """A 3D projection of 2 epochs on the cells route (the kernels' plain
    twins, with the sorts of the card's path): 216 Gaussians, B = 256.
    Returns a function running it, which gives the parameters."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "cells")
    monkeypatch.setenv("GF_HOIST_TARGETS", "1" if hoist else "0")
    monkeypatch.setattr(field, "_use_kernel", lambda x: True)
    mix, spec, _ = ring_collide_state(torch.device("cpu"), seed=3, side=6,
                                      n_queries=8)
    test_x = grid_points_3d(*DOMAIN3, 4, 4, 4)

    def run():
        gen = torch.Generator().manual_seed(7)
        out, _, _ = project.project_3d(
            mix, spec, mix, 0.02, domain=DOMAIN3, test_x=test_x, gen=gen,
            scene_name="ring_collide", batch_size=256, max_epoch=2,
            check_iter=2, verbose=0)
        return out.params()
    return run


def test_a_span_is_a_shared_no_op_outside_the_port_scopes(monkeypatch):
    """No port capture and no counting(): ``span`` never enters
    ``record_function``, not even under another tool's capture, and a
    counter keeps nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("gf.epoch") as a, profiling.span("gf.test") as b:
        profiling.count("cells_live_tiles", torch.ones(3), 4)
    assert a is None and b is None
    assert profiling.span("gf.x") is profiling.span("gf.y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("gf.epoch"):
            torch.ones(4).exp()
    with profiling.counting() as rec:
        pass
    assert rec.totals == {} and rec.items == []


@pytest.mark.parametrize("hoist", [True, False])
def test_a_projection_emits_each_span_nested_as_documented(monkeypatch,
                                                           hoist):
    run = _small_projection(monkeypatch, hoist)
    with profiling.counting(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = _gf_spans(prof)
    names = {n for n, _ in spans}
    want = set(PROJECTION_SPANS) | {"gf.field.work_lists"}
    # the hoist sorts and sweeps a chunk's batches; the per-epoch path
    # sorts each batch and computes its targets in the epoch
    want -= {"gf.epoch.sort", "gf.epoch.targets"} if hoist \
        else {"gf.chunk.sort", "gf.chunk.targets"}
    assert names == want
    for name, parent in spans:
        if name == "gf.field.work_lists":
            assert parent in WORK_LIST_PARENTS
        else:
            assert parent == PROJECTION_SPANS[name], (name, parent)
    epochs = [n for n, _ in spans if n == "gf.epoch"]
    assert len(epochs) == 2


def test_the_live_tile_counter_is_the_mask(monkeypatch):
    """cells_live_tiles under counting() is the forward list's mask:
    its live tiles and its R x C, under the spans open at the count; the
    transposed list counts nothing."""
    r = np.random.RandomState(5)
    masks = [torch.as_tensor(r.rand(*shape) < p)
             for shape, p in (((16, 9), 0.3), ((7, 30), 0.05))]
    with profiling.counting() as rec:
        for m in masks:
            with profiling.span("gf.epoch.heads"):
                field._cells_lists(m.to(torch.int32), m.numel())
        field._cells_lists(masks[0].to(torch.int32), masks[0].numel())
    live = [int(m.bool().sum()) for m in masks]
    heads = rec.sums("cells_live_tiles", "gf.epoch.heads")
    assert heads == [sum(live), sum(m.numel() for m in masks), 2]
    assert rec.sums("cells_live_tiles") == [
        sum(live) + live[0], sum(m.numel() for m in masks)
        + masks[0].numel(), 3]
    paths = set(rec.totals["cells_live_tiles"])
    assert paths == {("gf.epoch.heads", "gf.field.work_lists"),
                     ("gf.field.work_lists",)}


def test_counting_reads_the_fallback_deltas(monkeypatch):
    from gaussian_fluids_torch.ops import gsr_banded, gsr_cells
    seen = iter([{"fwd": 1, "bwd_dn2": 2}, {"fwd": 4, "bwd_dn2": 2}])
    guards = iter([5, 5])
    monkeypatch.setattr(gsr_cells, "overflows", lambda: next(seen))
    monkeypatch.setattr(gsr_banded, "guard_failures", lambda: next(guards))
    with profiling.counting() as rec:
        pass
    assert rec.fallbacks == {"cells_overflows": 3,
                             "banded_guard_failures": 0}


def _small_replay():
    mix, spec, _ = ring_collide_state(torch.device("cpu"), seed=4, side=5,
                                      n_queries=8)
    grid = (6, 5, 4)
    density = torch.rand(grid, generator=torch.Generator().manual_seed(2))
    return lambda: simulate3d.advected_density(
        density, mix, spec, DOMAIN3, 0.05, grid, chunk=48)


def test_the_replay_emits_its_spans():
    """The chunk loop's spans on the CPU's dense stages; the banded
    window's on the banded path's entry (the card's stages)."""
    step = _small_replay()
    with profiling.counting(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
        mix, spec, x = ring_collide_state(torch.device("cpu"), seed=4,
                                          side=5, n_queries=64)
        field.value_banded_prepped(field.banded_prep(mix, spec), x, 8,
                                   presorted=True)
    spans = _gf_spans(prof)
    chunks = sum(1 for n, _ in spans if n == "gf.replay.chunk")
    assert chunks == -(-6 * 5 * 4 // 48)
    assert [p for n, p in spans if n == "gf.replay.trilinear"] == \
        ["gf.replay.chunk"] * chunks
    assert ("gf.replay.band_window", None) in spans


def test_spans_and_counters_move_no_result(monkeypatch):
    """A projection's parameters and a replay step's density are bitwise
    the same with the spans and counters on (under a capture) and off."""
    run = _small_projection(monkeypatch, hoist=True)
    step = _small_replay()
    off = run(), step()
    with profiling.counting() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = run(), step()
    for k in off[0]:
        assert torch.equal(off[0][k], on[0][k]), k
    assert torch.equal(off[1], on[1])
    assert rec.sums("cells_live_tiles", "gf.epoch.heads")[2] == 2


def test_the_port_capture_carries_the_spans(tmp_path, monkeypatch):
    """``--profile``'s Chrome trace holds the gf.* spans; they stop with
    the capture."""
    run = _small_projection(monkeypatch, hoist=True)
    with profiling.maybe_trace(str(tmp_path), "cpu"):
        run()
    names = _names(tmp_path / "trace.json")
    assert {"gf.epoch", "gf.epoch.heads", "gf.field.work_lists"} <= names
    assert profiling.span("gf.epoch") is profiling.span("gf.test")
