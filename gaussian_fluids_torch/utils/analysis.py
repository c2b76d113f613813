"""Flow-diagnostic probes on host arrays — the port's own copy of the JAX
package's pure-numpy ``utils/analysis.py``: the street alternation count
and shedding frequency of a Karman wake, the curl and divergence of
(B, d, d) Jacobians, boundary flux statistics, and probe layouts on a
circle and on the faces of a box.

Pure numpy; no torch, no I/O.
"""
from __future__ import annotations

import numpy as np


def street_alternations(vor: np.ndarray, xs: np.ndarray, cx: float,
                        radius: float, gate_frac: float = 0.1):
    """Count sign alternations of the vortex street along the wake.

    For each x column downstream of the cylinder (x > cx + 2*radius), take
    the strongest-|vorticity| row value; count sign changes along x of that
    profile, ignoring values below ``gate_frac`` of the wake's max |vor|
    (noise gate). A laminar, unseparated flow gives 0-1; an established
    Karman street gives several, migrating downstream over frames.

    Parameters: ``vor`` (Ny, Nx) vorticity grid, ``xs`` (Nx,) column
    coordinates. Returns ``(alternations, wake_mean_abs_vor)``.
    """
    wake = xs > cx + 2.0 * radius
    v = vor[:, wake]
    if v.size == 0:
        return 0, 0.0
    idx = np.argmax(np.abs(v), axis=0)
    prof = v[idx, np.arange(v.shape[1])]
    gate = gate_frac * np.abs(v).max()
    sgn = np.sign(prof) * (np.abs(prof) > gate)
    sgn = sgn[sgn != 0]
    alt = int(np.sum(sgn[1:] != sgn[:-1])) if sgn.size else 0
    return alt, float(np.abs(v).mean())


def shedding_stats(vy: np.ndarray, dt: float, diameter: float,
                   u_mag: float):
    """Estimate the vortex-shedding frequency and Strouhal number.

    ``vy`` is the cross-stream velocity probed at a fixed point behind the
    cylinder, one sample per frame (spacing ``dt`` seconds). Only the
    second half of the series is used (the established street; the first
    half is transient). The frequency comes from mean-crossings (two per
    period); St = f * D / U. Returns ``(crossings, duration_s, freq_hz,
    strouhal)`` with ``freq_hz``/``strouhal`` None when fewer than two
    crossings were seen (no established shedding).
    """
    vy = np.asarray(vy, dtype=np.float64)
    half = vy[len(vy) // 2:]
    sgn = np.sign(half - half.mean())
    sgn = sgn[sgn != 0]
    crossings = int(np.sum(sgn[1:] != sgn[:-1])) if sgn.size else 0
    dur = (len(half) - 1) * dt
    if crossings < 2 or dur <= 0:
        return crossings, dur, None, None
    freq = crossings / 2.0 / dur
    return crossings, dur, freq, freq * diameter / u_mag


def curl2d_np(jac: np.ndarray) -> np.ndarray:
    """Host-side twin of ``solver.losses.curl2d`` for numpy (B, 2, 2)
    Jacobians."""
    return jac[:, 1, 0] - jac[:, 0, 1]


def curl3d_np(jac: np.ndarray) -> np.ndarray:
    """Host-side twin of solver.losses.curl3d (see curl2d_np)."""
    return np.stack([
        jac[:, 2, 1] - jac[:, 1, 2],
        jac[:, 0, 2] - jac[:, 2, 0],
        jac[:, 1, 0] - jac[:, 0, 1],
    ], axis=-1)


def divergence_np(jac: np.ndarray) -> np.ndarray:
    """Host-side twin of solver.losses.divergence (see curl2d_np)."""
    return np.trace(jac, axis1=-2, axis2=-1)


def circle_points(center, radius: float, m: int):
    """(points (m,2), outward normals (m,2)) on a circle — probe layout
    for the obstacle boundary-flux residual (the constraint the type-2
    free-slip samplers enforce, reference 2D/init_cond.py:325-346)."""
    th = np.linspace(0.0, 2.0 * np.pi, m, endpoint=False)
    n = np.stack([np.cos(th), np.sin(th)], -1)
    return np.asarray(center, np.float64) + radius * n, n


def flux_stats(vel: np.ndarray, normals: np.ndarray):
    """(mean |u.n|, max |u.n|) over boundary probe points — how well the
    solved field honors an impermeable boundary (target normal flux 0)."""
    fl = np.abs(np.sum(np.asarray(vel) * normals, axis=-1))
    return float(fl.mean()), float(fl.max())


def box_points(lo, hi, m_per_face: int, seed: int = 0):
    """(points (6m,3), outward normals (6m,3)) sampled uniformly on the
    six faces of the [lo, hi] box — probe layout for the 3D domain-wall
    flux residual (the constraint sample_on_box enforces, reference
    3D/init_cond.py:227-249)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    rng = np.random.RandomState(seed)
    pts, nrm = [], []
    for axis in range(3):
        for side, coord in ((-1.0, lo[axis]), (1.0, hi[axis])):
            p = lo + rng.rand(m_per_face, 3) * (hi - lo)
            p[:, axis] = coord
            n = np.zeros((m_per_face, 3))
            n[:, axis] = side
            pts.append(p)
            nrm.append(n)
    return np.concatenate(pts), np.concatenate(nrm)
