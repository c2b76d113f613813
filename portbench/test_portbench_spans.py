"""``portbench/spans.py``: the port's ``gf.*`` spans and counters read
from a trace. The accepted counts read the same with and without the
spans on a real (CPU) profile; idle gaps and device operations take the
innermost port span; each reading gives its number on a canned summary
and None where its span or counter is missing."""

from contextlib import nullcontext

import pytest
import torch

from gaussian_fluids_torch.utils import profiling
from portbench import spans, tracing


def canned(counts=None):
    device = [("void cub::DeviceSegmentedRadixSortKernel<>(...)", 0.10,
               0.20),
              ("void at::native::radixSortKVInPlace<>(...)", 0.20, 0.25),
              ("void cells_fwd_kernel<3, 3>(int const*)", 0.30, 0.40),
              ("void at::native::elementwise_kernel<>(...)", 0.70, 0.75)]
    host = [("portbench.project_3d", 0.0, 1.0, 0),
            ("aten::mul", 0.45, 0.50, 1),
            ("aten::sort", 0.85, 0.90, 1)]
    gf = [("gf.epoch", 0.0, 0.6), ("gf.epoch.heads", 0.04, 0.35),
          ("gf.field.work_lists", 0.06, 0.09),
          ("gf.epoch.pcgrad", 0.40, 0.48), ("gf.epoch.adam", 0.47, 0.58),
          ("gf.epoch", 0.62, 0.95), ("gf.replay.band_window", 0.62, 0.70),
          ("gf.replay.trilinear", 0.80, 0.92)]
    where = [("gf.epoch", "gf.epoch.heads", "gf.field.work_lists"),
             ("gf.epoch", "gf.epoch.sort"), ("gf.epoch", "gf.epoch.heads"),
             ()]
    return spans.SpanSummary(1.0, 2, device, 30, host, {}, gf_spans=gf,
                             device_spans=where, counts=counts)


def Counts(totals):
    c = profiling.Counts()
    c.totals = totals
    return c


def test_readings_on_a_canned_summary():
    c = Counts({"cells_live_tiles": {
        ("gf.epoch", "gf.epoch.heads", "gf.field.work_lists"): [30, 200, 2],
        ("gf.test", "gf.field.work_lists"): [500, 600, 1]}})
    s = canned(c)
    r = {k: f(s) for k, f in spans.READINGS.items()}
    # pcgrad [0.40, 0.48] and adam [0.47, 0.58] overlap: 0.18 s, 2 units
    assert r["optim_host_ms_per_epoch.project3d"] == pytest.approx(90.0)
    assert r["heads_host_ms_per_epoch.project3d"] == pytest.approx(155.0)
    # the segmented sort launched in the work lists: 0.10 s
    assert r["worklist_sort_ms_per_epoch.project3d"] == pytest.approx(50.0)
    assert r["cells_live_tile_pct.project3d"] == pytest.approx(15.0)
    assert r["band_window_host_ms_per_step.replay512"] == pytest.approx(40.0)
    assert r["trilinear_host_ms_per_step.replay512"] == pytest.approx(60.0)
    # the work lists' sort is a part of every sort kernel's time
    assert r["worklist_sort_ms_per_epoch.project3d"] <= 1e3 * \
        s.device_seconds(r"(?i)radix|sort") / s.units


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_a_reading_without_its_span_or_counter_is_none(name):
    empty = spans.SpanSummary(1.0, 2, canned().device, 30, [], {})
    assert spans.READINGS[name](empty) is None
    # the span present, the reading's own part missing
    c = Counts({"cells_live_tiles": {("gf.test",): [5, 10, 1]}})
    s = canned(c)
    s.gf_spans = [h for h in s.gf_spans if h[0] not in (
        "gf.epoch.pcgrad", "gf.epoch.adam", "gf.epoch.heads",
        "gf.replay.band_window", "gf.replay.trilinear")]
    s.device_spans = [()] * len(s.device)
    assert spans.READINGS[name](s) is None


def test_a_gap_is_named_by_its_innermost_port_span():
    s = canned()
    # the device runs [0.10, 0.25], [0.30, 0.40], [0.70, 0.75]
    gaps = dict(s.breakdown()["idle_gaps"])
    # [0.0, 0.10] and [0.25, 0.30]: their middles in the heads' span,
    # past the work lists' and outside any operator
    assert gaps["gf.epoch.heads: Python"] == pytest.approx(0.15)
    # [0.40, 0.70]: its middle 0.55 in adam (pcgrad and the mul closed)
    assert gaps["gf.epoch.adam: Python"] == pytest.approx(0.30)
    # [0.75, 1.0]: its middle in the trilinear span and the sort operator
    assert gaps["gf.replay.trilinear: aten::sort"] == pytest.approx(0.25)
    assert s.idle_by_span() == pytest.approx({
        "gf.epoch.heads": 0.15, "gf.epoch.adam": 0.30,
        "gf.replay.trilinear": 0.25})
    # idle inside some span: [0.0, 0.10] + [0.25, 0.30] + [0.40, 0.60]
    # + [0.62, 0.70] + [0.75, 0.95]
    assert s.idle_in_spans() == pytest.approx(0.63 / 0.70)


def test_a_gap_outside_every_port_span_keeps_its_name():
    s = canned()
    s.gf_spans = []
    assert s.breakdown() == tracing.Summary.breakdown(s)
    assert s.idle_in_spans() is None


def test_device_operations_take_the_spans_open_at_their_launch():
    gf = [("gf.epoch", 0.0, 1.0), ("gf.epoch.heads", 0.1, 0.4),
          ("gf.field.work_lists", 0.2, 0.3), ("gf.epoch", 1.2, 1.4)]
    e, h, w = "gf.epoch", "gf.epoch.heads", "gf.field.work_lists"
    assert spans.open_at(gf, [0.25, 0.05, 0.35, 1.1, 0.45, 1.3]) == [
        (e, h, w), (e,), (e, h), (), (e,), (e,)]
    s = canned()
    assert s.device_seconds_by_span(spans.SORTS) == pytest.approx({
        "gf.epoch/gf.epoch.heads/gf.field.work_lists": 0.10,
        "gf.epoch/gf.epoch.sort": 0.05})


def _profile(with_spans):
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.randn(32, 32)
    scope = profiling.counting() if with_spans else nullcontext()
    with scope, profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW_SPAN):
            for _ in range(3):
                with record_function("portbench.call"), \
                        profiling.span("gf.epoch"):
                    with profiling.span("gf.epoch.heads"):
                        b = a @ a          # matmul holding mm
                    with profiling.span("gf.epoch.adam"):
                        b.sum()
                    b.exp()
    return prof


def test_the_accepted_counts_read_the_same_with_the_port_spans():
    bare, kept = _profile(False), _profile(True)
    s0, s1 = spans.summarize(bare, 3, {}), spans.summarize(kept, 3, {})
    assert s0.host_ops == s1.host_ops == 9
    assert tracing.summarize(bare, 3, {}).host_ops == 9
    assert s0.launches() == s1.launches() == 0
    assert [h[0] for h in s1.host_spans] == [h[0] for h in s0.host_spans]
    assert {n for n, _, _ in s1.gf_spans} == {
        "gf.epoch", "gf.epoch.heads", "gf.epoch.adam"}
    assert s0.gf_spans == [] and s1.span_seconds("gf.epoch") > 0
    # the accepted summary takes only the benchmark's spans, so it counts
    # none of the operators inside the port's: why the port keeps its
    # spans only where the capture's reader opened counting()
    assert tracing.summarize(kept, 3, {}).host_ops == 0
