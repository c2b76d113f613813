"""Arithmetic shared by the per-layer readers (``portbench/per_layer``).
Each takes the traced part's ``tracing.Summary`` and returns a number,
or None where it finds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench import frozen


def host_ops_per_unit(s) -> Optional[float]:
    """Host operators the program dispatched itself, per unit of work."""
    return s.host_ops / s.units if s.units else None


def launches_per_unit(s) -> Optional[float]:
    """Device operations (kernels, copies, fills) per unit of work."""
    return s.launches() / s.units if s.units and s.device else None


def idle_pct(s) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    if not s.device or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def busy_ms_per_unit(s) -> Optional[float]:
    """Milliseconds in which any device operation ran, per unit of work."""
    return 1e3 * s.busy_s / s.units if s.device and s.units else None


def device_ms_per_unit(s, pattern: str) -> Optional[float]:
    """Device milliseconds of the operations whose name matches, per unit
    of work."""
    t = s.device_seconds(pattern)
    return 1e3 * t / s.units if t > 0 and s.units else None


def roofline_pct(s, pattern: str, probe) -> Optional[float]:
    """A kernel's least time on need over its measured device time."""
    t = s.device_seconds(pattern)
    need = s.needs.get(tuple(probe))
    if t <= 0 or not need:
        return None
    return 100.0 * need / t


def mfu_pct(s) -> Optional[float]:
    """The whole unit's FLOPs on need over the f32 peak times the
    window's seconds per unit."""
    if not s.flops_per_unit or not s.unit_seconds:
        return None
    return 100.0 * s.flops_per_unit / (frozen.PEAK_F32_FLOPS
                                       * s.unit_seconds)
