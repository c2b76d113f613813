"""The spans and the counter of Karman's 2D projection: the boundary terms'
``gf.boundary.dirichlet`` and ``gf.boundary.flux``, kept under
``counting()`` inside the epoch's ``gf.epoch.rest`` and the test's
``gf.test`` and absent outside it; ``covector_outside``, the 2D covector
target's backtraced points outside the advance domain, against a direct
count and silent once its scope has closed; and a projection's result
the same with both on and off."""

import pytest
import torch

from gaussian_fluids_torch.models.mixture import mixture_of
from gaussian_fluids_torch.scenes import get_scene_2d
from gaussian_fluids_torch.solver import covector, project
from gaussian_fluids_torch.utils import profiling
from gaussian_fluids_torch.utils.grids import grid_points_2d

from torch_karman_state import karman_state

BOUNDARY = {"gf.boundary.dirichlet", "gf.boundary.flux"}


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
        out.append((name, max(holders, key=lambda h: (h[1], -h[2]))[0]
                    if holders else None))
    return out


def _projection(monkeypatch, hoist=True):
    """A Karman projection of 2 epochs and one test on the centered
    kernels' plain twins: 256 Gaussians, B = 64. Returns a function running
    it, which gives the parameters."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    monkeypatch.setenv("GF_HOIST_TARGETS", "1" if hoist else "0")
    mix, spec = karman_state(256, seed=4)
    scene = get_scene_2d("karman")
    sf = scene.scaling_factor
    adv = scene.advance_domain_at(7, 0.05)
    test_x = grid_points_2d(adv[0] * sf, adv[1] * sf, adv[2] * sf,
                            adv[3] * sf, 8, 4)

    def run():
        out, _ = project.project_2d(
            mix, spec, mix, 0.05, scene=scene, adv_domain=adv, test_x=test_x,
            gen=torch.Generator().manual_seed(3), batch_size=64, max_epoch=2,
            patience=2, check_iter=2, verbose=0)
        return out.params()
    return run


@pytest.mark.parametrize("hoist", [True, False])
def test_the_boundary_spans_are_kept_under_counting_only(monkeypatch,
                                                         hoist):
    run = _projection(monkeypatch, hoist)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    assert _gf_spans(prof) == []
    with profiling.counting(), torch.profiler.profile(
            activities=acts) as prof:
        run()
    spans = _gf_spans(prof)
    for name in BOUNDARY:
        parents = [p for n, p in spans if n == name]
        # one term an epoch's rest, and one in the test after the chunk
        assert sorted(parents) == ["gf.epoch.rest"] * 2 + ["gf.test"], \
            (name, parents)


def test_covector_outside_is_the_count_of_points_outside():
    """With no velocity the backtrace stays put: the counter takes the
    batch's points outside the box, against the batch."""
    mix, spec = karman_state(64, seed=1)
    still = mixture_of({**mix.params(),
                        "values": torch.zeros_like(mix.values)}, mix.alive)
    lo, hi = torch.tensor([-10.0, -2.0]), torch.tensor([5.0, 3.0])
    g = torch.Generator().manual_seed(2)
    x = torch.rand((97, 2), generator=g) * 24.0 - 12.0
    outside = int((~((x >= lo) & (x <= hi)).all(-1)).sum())
    assert 0 < outside < 97
    with profiling.counting() as rec:
        with profiling.span("gf.epoch.targets"):
            vor = covector.advected_vorticity_2d(still, spec, x, 0.05, lo,
                                                 hi)
    assert rec.sums("covector_outside", "gf.epoch.targets") == \
        [outside, 97, 1]
    assert rec.totals["covector_outside"].keys() == {("gf.epoch.targets",)}
    assert int((vor == 0).sum()) >= outside
    # the scope closed: a call records nothing in it, nor anywhere
    covector.advected_vorticity_2d(still, spec, x, 0.05, lo, hi)
    assert rec.sums("covector_outside") == [outside, 97, 1]
    assert not profiling.counters_on()
    with profiling.counting() as later:
        pass
    assert later.sums("covector_outside") == [0, 0, 0]


def test_a_projection_counts_its_targets(monkeypatch):
    """Under counting(), every target the projection computes is counted
    where the hoist computes it: the chunk's sweep of its 2 batches and
    the test grid's."""
    run = _projection(monkeypatch, hoist=True)
    with profiling.counting() as rec:
        run()
    assert rec.sums("covector_outside", "gf.chunk.targets")[1:] == [128, 1]
    assert rec.sums("covector_outside", "gf.test.targets")[1:] == [32, 1]
    assert rec.sums("covector_outside")[0] <= 160


def test_spans_and_the_counter_move_no_result(monkeypatch):
    run = _projection(monkeypatch, hoist=True)
    off = run()
    with profiling.counting(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = run()
    for k in off:
        assert torch.equal(off[k], on[k]), k
