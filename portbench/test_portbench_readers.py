"""The per-layer readers' arithmetic on canned profiler tables, and the
summary of a real (CPU) profile."""

import math

import pytest
import torch

from portbench import frozen, harness, tracing


def canned(**kw):
    device = [("void cells_fwd_kernel<3, 3>(int const*)", 0.10, 0.30),
              ("void cub::DeviceSegmentedRadixSortKernel<>(...)", 0.25,
               0.35),
              ("Memcpy HtoD (Pageable -> Device)", 0.50, 0.55),
              ("void val_banded_kernel<3>(...)", 0.70, 0.80)]
    spans = [("portbench.project_3d", 0.0, 1.0, 0),
             ("aten::nonzero", 0.35, 0.5, 1),
             ("aten::copy_", 0.55, 0.70, 1)]
    s = tracing.Summary(1.0, 4, device, 40, spans,
                        {("m", "cells_fwd"): 0.002,
                         ("m", "banded"): None})
    s.unit_seconds = kw.get("unit_seconds", 0.25)
    s.flops_per_unit = kw.get("flops_per_unit", 67e9)
    return s


def read(name, s):
    return harness.reader("per_layer", name).read(s)


def test_counts_per_unit():
    s = canned()
    assert read("host_ops_per_epoch.project3d", s) == 10.0
    assert read("launches_per_epoch.project3d", s) == 1.0
    assert read("host_ops_per_step.replay512", s) == 10.0


def test_idle_share_is_the_union_of_device_intervals():
    s = canned()
    # busy: [0.10, 0.35] + [0.50, 0.55] + [0.70, 0.80] = 0.40 of 1.0 s
    assert s.busy_s == pytest.approx(0.40)
    assert read("device_idle_pct.project3d", s) == pytest.approx(60.0)


def test_device_busy_time_per_unit_is_the_union_of_device_intervals():
    s = canned()
    assert read("device_busy_ms_per_epoch.project3d", s) == \
        pytest.approx(1e3 * 0.40 / 4)
    assert read("device_busy_ms_per_step.replay512", s) == \
        pytest.approx(1e3 * 0.40 / 4)


def test_sort_time_by_name():
    assert read("sort_ms_per_epoch.project3d", canned()) == \
        pytest.approx(1e3 * 0.10 / 4)


def test_roofline_share_is_need_over_device_time():
    s = canned()
    s.needs[("gaussian_fluids_torch.ops.gsr_cells", "cells_fwd")] = 0.002
    assert read("cells_fwd_roofline_pct.project3d", s) == \
        pytest.approx(100 * 0.002 / 0.20)


def test_a_reader_with_nothing_to_read_returns_none():
    s = canned()
    # no need counted for the banded kernel
    assert read("val_banded_roofline_pct.replay512", s) is None
    empty = tracing.Summary(1.0, 4, [], 0, [], {})
    for name in ("device_idle_pct.project3d", "launches_per_step.replay512",
                 "sort_ms_per_epoch.project3d",
                 "device_busy_ms_per_epoch.project3d",
                 "cells_fwd_roofline_pct.project3d"):
        assert read(name, empty) is None, name


def test_mfu_against_the_f32_peak():
    s = canned(unit_seconds=0.5, flops_per_unit=frozen.PEAK_F32_FLOPS)
    assert read("mfu_pct.project3d", s) == pytest.approx(200.0)
    s = canned(unit_seconds=None)
    assert read("mfu_pct.replay512", s) is None


def test_breakdown_names_gaps_by_host_activity():
    b = canned().breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(0.15)
    assert gaps["aten::copy_"] == pytest.approx(0.15)
    assert sum(gaps.values()) == pytest.approx(0.60)
    assert b["device_ops"][0][0] == "void cells_fwd_kernel<3, 3>"


def test_summary_of_a_cpu_profile_counts_top_level_operators():
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW_SPAN):
            for _ in range(3):
                with record_function("portbench.call"):
                    b = a @ a          # aten::matmul holding aten::mm
                    b.sum()
    s = tracing.summarize(prof, 3, {})
    # matmul (holding mm) and sum, three times, inside the benchmark's
    # spans only
    assert s.host_ops == 6
    assert s.device == [] and s.window_s > 0
    assert any(n == "portbench.call" for n, *_ in s.host_spans)


def test_short_names_drop_the_argument_list_only():
    assert tracing.short("void (anonymous namespace)::k<int>(float*, int)") \
        == "void (anonymous namespace)::k<int>"
    assert tracing.short("void cells_fwd_kernel<3, 3>(int const*)") == \
        "void cells_fwd_kernel<3, 3>"
    assert tracing.short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"


def test_need_of_one_call_counts_the_support():
    d, vdim, clamp = 3, 3, 5e-3
    mu = torch.tensor([[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]])
    x = torch.zeros(8, 3)
    npk = 6
    ppT = torch.zeros(npk + 1, 64)
    ppT[:3] = 100.0          # isotropic precision 100
    ppT[npk, 2:] = 1e9       # rows 2.. dead
    muT = torch.zeros(3, 64)
    muT[:, :2] = mu.T
    t = tracing.call_least(x, muT, ppT, clamp, vdim, 3)
    # 8 queries each meet row 0 only: 8 pairs of 59 operations
    ops = 8 * frozen.fwd_flops_per_pair(d, vdim, 3)
    nbytes = 4 * (8 * 3 + 2 * (3 + 6 + 3) + 8 * 4 * 3)
    assert t == pytest.approx(frozen.least_seconds(ops, nbytes))
    assert math.isfinite(t)
