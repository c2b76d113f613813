"""The box tests of the redesigned kernels are pure skips, checked on the
CPU in float64: every pair in a Gaussian tile whose box (``field.
gaussian_tile_boxes``: each row dilated by its own support radius and a
1e-3 margin) misses a query tile's box, and every pair with the query
outside its row's dilated box (``field.row_radius``: the cells forward's
and the banded kernel's per-pair test), has g < clamp — on the seeded
Ring-Collide-sized state and on the committed Ring-Collide checkpoint,
at the replay's query tiles (128-node z-runs of the 512^3 grid) and at
training queries (uniform in the domain, x-sorted, 8 to a tile); and on
the seeded Karman-2D state at each of the fused RK4 kernel's five stage
positions, whose query tiles it boxes anew at every stage.

The float64 g is the exact value the f32 kernels approximate: a skipped
pair must sit below the clamp by more than f32 can move it, which the
margin provides (g <= c exp(-1e-3 q0) ~ 0.99 c at the box's edge).
"""

import os

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_banded as tb
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.ops import rk4_fused as tr
from gaussian_fluids_torch.ops.rotations import precision_matrix
from gaussian_fluids_torch.utils.seeded_state import (karman_state,
                                                      ring_collide_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_CKPT = os.path.join(ROOT, "runs_r2_evidence", "ckpts",
                         "output_3d_ring_collide", "gaussian_velocity_1.pt")


def _state(which):
    if which == "seeded":
        mix, spec, _ = ring_collide_state("cpu")
    else:
        mix, spec = tckpt.load_checkpoint(RING_CKPT, device="cpu")
    return mix.slab_sorted(spec.clamp_threshold), spec


def _query_tiles(kind, tile):
    """(tiles, tile, 3) f32 query tiles: six 128-node z-runs of the 512^3
    grid through the rings, or 48 tiles of 8 uniform points, x-sorted, as
    a training batch is tiled."""
    if kind == "grid":
        g = np.linspace(0.0, 1.0, 512).astype(np.float32)
        runs = [np.stack([np.full(tile, g[ix]), np.full(tile, g[iy]),
                          g[192:192 + tile]], -1)
                for ix in (230, 256) for iy in (205, 256, 307)]
        return np.stack(runs).astype(np.float32)
    x = np.random.RandomState(5).uniform(0, 1, (8192, 3)).astype(np.float32)
    x = x[np.argsort(x[:, 0], kind="stable")].reshape(-1, tile, 3)
    return x[::21][:48]


def _g64(mix, spec, x):
    """(B, N) float64 g of every pair, 0 on dead rows."""
    P = precision_matrix(mix.scalings.double(), mix.rotations.double(), 3)
    dx = torch.as_tensor(x, dtype=torch.float64)[:, None] \
        - mix.positions.double()[None]
    g = torch.exp(-0.5 * torch.einsum("bni,nij,bnj->bn", dx, P, dx))
    return torch.where(tf.in_domain_mask(mix, spec)[None], g, 0.0)


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def test_cells_prep_radius_is_row_radius():
    """The cells path's radii come from its tile mask's own support radii
    and equal ``row_radius``, bitwise."""
    mix, spec, x = ring_collide_state("cpu", side=10)
    mix.alive[:5] = False
    rad = tf._cells_prep(mix, spec, x[:300])[4]
    torch.testing.assert_close(rad, tf.row_radius(mix, spec, tb.TN),
                               rtol=0, atol=0)


def test_centered_prep_radius_is_row_radius():
    """The same for the centered path's prep, whose radii the centered
    forward's box test reads."""
    mix, spec, x = ring_collide_state("cpu", side=10)
    mix.alive[:5] = False
    rad = tf._centered_prep(mix, spec, x[:300], 8, tb.TN, False)[7]
    torch.testing.assert_close(rad, tf.row_radius(mix, spec, tb.TN),
                               rtol=0, atol=0)


def test_row_radius_is_the_dilated_support_radius():
    mix, spec, _ = ring_collide_state("cpu", side=10)
    mix.alive[:7] = False
    mix.positions[7:9] = 5.0                     # outside the domain
    rad = tf.row_radius(mix, spec, tb.TN)
    live = tf.in_domain_mask(mix, spec)
    r = tf.support_radius(mix.scalings, spec.clamp_threshold)
    assert rad.shape == (mix.capacity,)
    assert bool((rad[~live] == -1).all()) and int((~live).sum()) >= 9
    torch.testing.assert_close(rad[live], r[live] * (1 + tf.BOX_MARGIN),
                               rtol=0, atol=0)


@pytest.mark.parametrize("which", ["seeded", "checkpoint"])
@pytest.mark.parametrize("kind", ["grid", "training"])
def test_box_misses_hold_no_support(which, kind):
    """Pairs skipped by a tile box or by a row box have float64 g < c;
    the tiles and rows kept hold every pair with g >= c, and there are
    such pairs (the test is not empty)."""
    mix, spec = _state(which)
    c = spec.clamp_threshold
    prep = tf.banded_prep(mix, spec)
    lo, hi, rad = prep["lo"], prep["hi"], prep["rad"]
    N = rad.shape[0]
    mu = tf._pad_axis(mix.positions, tb.TN)
    tile = 128 if kind == "grid" else 8
    tiles = _query_tiles(kind, tile)
    kept_support = 0
    for xt in tiles:
        q = torch.as_tensor(xt)
        qlo, qhi = q.min(0).values, q.max(0).values
        meet = ((lo <= qhi[:, None]) & (hi >= qlo[:, None])).all(0)
        rows_meet = meet.repeat_interleave(tb.TN)
        for s in range(0, tile, 16):                  # 16 queries at a time
            g = _g64(mix, spec, xt[s:s + 16])
            g = torch.cat([g, g.new_zeros(g.shape[0], N - g.shape[1])], 1)
            in_box = ((q[s:s + 16, None, :] - mu[None]).abs()
                      <= rad[None, :, None]).all(-1)
            assert _max(g[:, ~rows_meet]) < c
            assert _max(g[~in_box]) < c
            support = g >= c
            assert bool((in_box & rows_meet)[support].all())
            kept_support += int(support.sum())
    assert kept_support > 0


def test_dead_and_far_rows_fail_every_box():
    """A mixture with dead rows, rows outside the domain and a padded
    tail: their tiles' boxes are empty (+inf, -inf) where no live row is
    left, and no query passes their rows' box test."""
    spec = FieldSpec.create((0.0,) * 3, (1.0,) * 3, 100, d=3, vdim=3)
    pos = np.random.RandomState(2).uniform(0, 1, (100, 3))
    mix = GaussianMixture.create(pos, spec, device="cpu")
    mix.alive[:64] = False
    rad = tf.row_radius(mix, spec, tb.TN)
    lo, hi = tf.gaussian_tile_boxes(mix, spec, tb.TN, rad)
    assert bool(torch.isinf(lo[:, 0]).all()) and bool((lo[:, 0] > 0).all())
    assert bool(torch.isinf(hi[:, 0]).all()) and bool((hi[:, 0] < 0).all())
    assert bool(torch.isfinite(lo[:, 1]).all())
    q = torch.as_tensor(np.random.RandomState(3).uniform(0, 1, (32, 3)),
                        dtype=torch.float32)
    in_box = ((q[:, None, :] - tf._pad_axis(mix.positions, tb.TN)[None])
              .abs() <= rad[None, :, None]).all(-1)
    assert not bool(in_box[:, :64].any()) and not bool(in_box[:, 100:].any())


@pytest.mark.parametrize("which", ["seeded", "checkpoint"])
def test_backward_box_misses_hold_no_support(which):
    """The cells backward's view (row 7): each Gaussian against the query
    tiles of its run of the transposed work list, on a training batch
    laid out as ``_cells_prep`` lays it out. Every pair whose query lies
    outside the Gaussian's own box (the prep's ``rad``) has float64
    g < c, and the pairs kept hold every pair with g >= c (there are
    such pairs)."""
    mix, spec = _state(which)
    c = spec.clamp_threshold
    x = np.random.RandomState(6).uniform(0, 1, (8192, 3)).astype(np.float32)
    x = torch.as_tensor(x[np.argsort(x[:, 0], kind="stable")])
    x_p, _, tmask, (_, _, gt, qt, ok), rad = tf._cells_prep(mix, spec, x)
    assert int(ok) == 1
    mu = tf._pad_axis(mix.positions, tb.TN)
    P = precision_matrix(mix.scalings.double(), mix.rotations.double(), 3)
    live = tf.in_domain_mask(mix, spec)
    kept_support = 0
    runs = torch.unique(gt[qt >= 0])
    for j in runs[::max(len(runs) // 24, 1)].tolist():
        qtiles = qt[(gt == j) & (qt >= 0)].long()
        q = x_p.reshape(-1, 8, 3)[qtiles].reshape(-1, 3)
        n = torch.arange(j * tb.TN, min((j + 1) * tb.TN, mix.capacity))
        dx = q.double()[:, None] - mix.positions[n].double()[None]
        g = torch.exp(-0.5 * torch.einsum("bni,nij,bnj->bn", dx, P[n], dx))
        g = torch.where(live[n][None], g, 0.0)
        in_box = ((q[:, None, :] - mu[n][None]).abs()
                  <= rad[n][None, :, None]).all(-1)
        assert _max(g[~in_box]) < c
        support = g >= c
        assert bool(in_box[support].all())
        kept_support += int(support.sum())
    assert kept_support > 0


def _rk4_stage_points(x, muT, ppT, v, dt, clamp):
    """The five positions at which the fused RK4 kernel evaluates the
    field: the plain twin's recurrence (rk4_fused.rk4_plain)."""
    live = torch.ones((x.shape[0], 1), dtype=torch.int32)
    pts, vs = [x], []
    for h in (0.5 * dt, 0.5 * dt, dt):
        vs.append(tk.fwd_plain(live, pts[-1], muT, ppT, v, clamp, 0))
        pts.append(x + h * vs[-1])
    vs.append(tk.fwd_plain(live, pts[-1], muT, ppT, v, clamp, 0))
    pts.append(x + dt / 6.0 * (vs[0] + 2.0 * vs[1] + 2.0 * vs[2] + vs[3]))
    return pts


@pytest.mark.parametrize("stage", range(5))
def test_rk4_stage_box_misses_hold_no_support(stage):
    """The fused RK4 kernel's view (row 9) on the seeded Karman state and
    its 512 x-sorted queries, backtraced over the scene's dt as the
    covector target does: at the stage's positions, in query tiles of TB,
    every pair whose Gaussian tile box misses the tile's box, or whose
    query lies outside the row's dilated box, has float64 g < c; the
    pairs kept hold every pair with g >= c (there are such pairs); and
    the tile test lets through under a tenth of the tile pairs, the
    premise of the design."""
    mix, spec, x = karman_state("cpu")
    c = spec.clamp_threshold
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tr.TN)
    rad = tf.row_radius(mix, spec, tr.TN)
    lo, hi = tf.gaussian_tile_boxes(mix, spec, tr.TN, rad)
    q = _rk4_stage_points(x, mu_p.T.contiguous(), pp_p.T.contiguous(),
                          v_p, -0.01, c)[stage]
    assert bool(torch.isfinite(q).all())
    tiles = q.reshape(-1, tr.TB, 2)
    meet = ((lo[None] <= tiles.amax(1)[:, :, None])
            & (hi[None] >= tiles.amin(1)[:, :, None])).all(1)
    assert float(meet.float().mean()) < 0.1
    P = precision_matrix(mix.scalings.double(), mix.rotations.double(), 2)
    live = tf.in_domain_mask(mix, spec)
    kept_support = 0
    for s in range(0, q.shape[0], 32):                # 32 queries at a time
        dx = q[s:s + 32].double()[:, None] - mu_p.double()[None]
        g = torch.exp(-0.5 * torch.einsum("bni,nij,bnj->bn", dx, P, dx))
        g = torch.where(live[None], g, 0.0)
        in_box = ((q[s:s + 32, None, :] - mu_p[None]).abs()
                  <= rad[None, :, None]).all(-1)
        kept = in_box & meet[s // tr.TB:(s + 32) // tr.TB] \
            .repeat_interleave(tr.TB, 0).repeat_interleave(tr.TN, 1)
        assert _max(g[~kept]) < c
        kept_support += int((g >= c).sum())
    assert kept_support > 0
