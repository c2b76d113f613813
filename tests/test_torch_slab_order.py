"""The density replay's slab-major order (``GaussianMixture.slab_sorted``)
on the CPU: it is a permutation with the dead rows last, in (x-slab,
y-cell, z) order; the port's banded evaluation on a slab-sorted mixture
(the plain twin of its CUDA kernel) matches the JAX package's banded
kernel (Pallas in interpret mode, at the JAX tests' tiles tb = 64,
tn = 256) on its x-sorted mixture, on a seeded Ring-Collide-sized state
and on the committed Ring-Collide checkpoint; and the band the replay
suggests for the slab-major tiles keeps the device guard satisfied on
every x-plane of the 512^3 grid.

Tolerance: 1e-5 of max(1, largest entry) — the same f32 terms, summed in
another order (another row order, other tiles).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.solver import simulate3d as jsim

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_banded as tb
from gaussian_fluids_torch.solver import simulate3d as tsim
from gaussian_fluids_torch.utils.seeded_state import ring_collide_state

from torch_parity import close, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_CKPTS = os.path.join(ROOT, "runs_r2_evidence", "ckpts",
                          "output_3d_ring_collide")


def _ckpt(frame):
    return os.path.join(RING_CKPTS, f"gaussian_velocity_{frame}.pt")


def _states(which):
    """(port mixture, port spec, JAX mixture, JAX spec) on one state: the
    seeded Ring-Collide-sized one (N = 64,000, capacity 75,776) or the
    committed checkpoint of frame 1."""
    if which == "seeded":
        tm, ts, _ = ring_collide_state("cpu")
        spec = FieldSpec(**ts.__dict__)
        jm = GaussianMixture(*(jnp.asarray(getattr(tm, k).numpy()) for k in
                               ("positions", "scalings", "rotations",
                                "values", "alive")))
        return tm, ts, jm, spec
    tm, ts = tckpt.load_checkpoint(_ckpt(1), device="cpu")
    jm, spec = jckpt.load_checkpoint(_ckpt(1))
    return tm, ts, jm, spec


def _slab_keys(mix, clamp):
    """(slab, cell, z) of every row as ``slab_sorted`` defines them."""
    r = math.sqrt(-2.0 * math.log(clamp)) \
        * torch.exp(-mix.scalings.min(dim=-1).values)
    width = 2.0 * float(r[mix.alive].max())
    pos = mix.positions[mix.alive]
    lo = pos.min(dim=0).values
    cells = torch.floor((mix.positions[:, :2] - lo[:2]) / width).long()
    return cells[:, 0], cells[:, 1], mix.positions[:, 2]


@pytest.mark.parametrize("which", ["seeded", "checkpoint"])
def test_slab_sorted_is_a_permutation_with_dead_rows_last(which):
    tm, ts, _, _ = _states(which)
    tm.alive[:40] = False            # dead rows among the live ones too
    sm = tm.slab_sorted(ts.clamp_threshold)
    rows = lambda m: torch.cat([m.positions, m.scalings, m.rotations,  # noqa
                                m.values, m.alive[:, None].float()], 1)
    a, b = rows(tm).numpy(), rows(sm).numpy()
    np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
    n = int(tm.alive.sum())
    assert bool(sm.alive[:n].all()) and not bool(sm.alive[n:].any())
    slab, cell, z = (k[:n] for k in _slab_keys(sm, ts.clamp_threshold))
    key = slab * (1 << 20) + cell
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((z[1:] >= z[:-1])[same].all())
    assert int(slab.max()) >= 4 and int(cell.max()) >= 4   # many columns


def _ring_queries():
    """512 points as the replay's query tiles lie: four 128-node z-runs of
    the 512^3 grid at x = 0.5, through the rings."""
    g = np.linspace(0.0, 1.0, 512).astype(np.float32)
    ys = g[[200, 230, 260, 290]]
    zs = g[192:320]
    Y, Z = np.meshgrid(ys, zs, indexing="ij")
    return np.stack([np.full(Y.size, g[255]), Y.ravel(), Z.ravel()],
                    -1).astype(np.float32)


@pytest.mark.parametrize("which", ["seeded", "checkpoint"])
def test_slab_sorted_banded_matches_jax_x_sorted(which):
    """The port's banded evaluation (the plain twin, at the CUDA kernel's
    tiles) on the slab-sorted mixture, with the replay's band, against the
    JAX package's banded Pallas kernel (interpret mode) on its x-sorted
    mixture with its own replay's band: within 1e-5 of max(1, largest
    entry); and the port's guard holds for these queries."""
    tm, ts, jm, spec = _states(which)
    x = _ring_queries()
    jm = jm.x_sorted()
    jband = jsim._suggest_band(jm, spec, 0.02, tb=64, tn=256,
                               chunk=x.shape[0])
    want = jf.value_banded(jm, spec, jnp.asarray(x), jband, tb=64, tn=256)
    sm = tm.slab_sorted(ts.clamp_threshold)
    band = tsim._suggest_band(sm, ts, 0.02, chunk=x.shape[0])
    prep = tf.banded_prep(sm, ts)
    xs = t(x[np.argsort(x[:, 0], kind="stable")])
    ok = tf.band_window(xs, xs.shape[0], prep["nlo"], prep["nhi"], band,
                        tb.TB)[1]
    assert int(ok) == 1
    got = tf.value_banded(sm, ts, t(x), band)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    close(got, want, 1e-5)


@pytest.mark.parametrize("frame", [0, 20])
def test_slab_band_covers_every_512_plane(frame):
    """The twin of test_suggested_band_covers_every_512_plane for the
    replay's slab-major order: on the committed Ring-Collide checkpoints
    the band for the kernel's tiles passes the device guard for a query
    tile on every x-plane of the 512^3 grid, and is well short of the
    whole axis."""
    mix, spec = tckpt.load_checkpoint(_ckpt(frame), device="cpu")
    mix = mix.slab_sorted(spec.clamp_threshold)
    band = tsim._suggest_band(mix, spec, 0.02)
    nlo, nhi = tf.gaussian_tile_extents(mix, spec, tb.TN)
    assert band < nlo.shape[0] // 2
    planes = torch.as_tensor(np.linspace(0, 1, 512, dtype=np.float32))
    x_p = planes.repeat_interleave(tb.TB)[:, None].expand(-1, 3)
    jlo, ok = tf.band_window(x_p, x_p.shape[0], nlo, nhi, band, tb.TB)
    assert int(ok) == 1
    assert int(jlo.min()) >= 0 and int(jlo.max()) <= nlo.shape[0] - band
