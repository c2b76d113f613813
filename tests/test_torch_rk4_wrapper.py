"""The fused RK4 kernel's wrapper on the CPU (``ops/rk4_fused.py``): the
query padding to whole tiles of TB (copies of the last query, so the last
tile's box is its real queries' box) and the Gaussian tiles' boxes
(``tile_boxes``) against a numpy reckoning and against
``field.gaussian_tile_boxes``; the refusal of a bad ``rad``, bad boxes or
a bad split before any launch; any valid split, radii and boxes on a CPU
tensor taking the plain twin, which reads none of them; and
``field.rk4_valjac_fused`` handing the kernel the field's own radii and
boxes. The kernel against its plain twin is in tests/test_torch_cuda.py,
which runs on the card; the box tests' exactness at every stage in
tests/test_torch_cull.py."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import rk4_fused as tr


def _state(d, n=150, seed=3):
    """A d-dimensional mixture with seeded shapes and values, dead rows,
    rows outside the domain, a padded tail and a tile with no live row."""
    rng = np.random.RandomState(seed)
    spec = FieldSpec.create((-1.0,) * d, (1.0,) * d, n, d=d, vdim=d)
    mix = GaussianMixture.create(rng.uniform(-1, 1, (n, d)), spec,
                                 device="cpu")
    mix.scalings += torch.as_tensor(
        rng.uniform(-0.5, 0.5, mix.scalings.shape).astype(np.float32))
    mix.values = torch.as_tensor(
        rng.randn(*mix.values.shape).astype(np.float32)) * mix.alive[:, None]
    mix.alive[:tr.TN] = False                 # the first tile: none live
    mix.alive[70:80] = False
    mix.positions[90:95] = 7.0                # outside the domain
    x = torch.as_tensor(rng.uniform(-1, 1, (37, d)).astype(np.float32))
    return mix, spec, x


def _kernel_args(mix, spec):
    mu_p, pp_p, v_p = tf._padded_param_rows(mix, spec, tr.TN)
    return (mu_p.T.contiguous(), pp_p.T.contiguous(), v_p.contiguous(),
            tf.row_radius(mix, spec, tr.TN))


@pytest.mark.parametrize("b", [1, 5, 8, 9, 512, 517])
def test_pad_queries_copies_the_last_row(b):
    x = np.random.RandomState(b).randn(b, 2).astype(np.float32)
    got = tr.pad_queries(torch.as_tensor(x)).numpy()
    rows = -(-b // tr.TB) * tr.TB
    want = np.concatenate([x, np.repeat(x[-1:], rows - b, 0)])
    np.testing.assert_array_equal(got, want)
    tiles = got.reshape(-1, tr.TB, 2)
    last = x[(rows // tr.TB - 1) * tr.TB:]
    np.testing.assert_array_equal(tiles[-1].min(0), last.min(0))
    np.testing.assert_array_equal(tiles[-1].max(0), last.max(0))


def test_pad_queries_keeps_a_whole_or_empty_batch():
    for b in (0, 8, 64):
        x = torch.zeros((b, 3))
        assert tr.pad_queries(x) is x


@pytest.mark.parametrize("d", [2, 3])
def test_tile_boxes_match_numpy_and_the_field(d):
    """Per TN-row tile and axis, the min of mu - rad and the max of mu +
    rad over the rows with rad >= 0, in float32; +-inf where no row is
    live: bitwise, and bitwise ``field.gaussian_tile_boxes``."""
    mix, spec, _ = _state(d)
    muT, _, _, rad = _kernel_args(mix, spec)
    lo, hi = tr.tile_boxes(muT, rad)
    mu, r = muT.numpy(), rad.numpy()
    nnt = mu.shape[1] // tr.TN
    want_lo = np.full((d, nnt), np.inf, np.float32)
    want_hi = np.full((d, nnt), -np.inf, np.float32)
    for j in range(nnt):
        for n in range(j * tr.TN, (j + 1) * tr.TN):
            if r[n] < 0:
                continue
            want_lo[:, j] = np.minimum(want_lo[:, j], mu[:, n] - r[n])
            want_hi[:, j] = np.maximum(want_hi[:, j], mu[:, n] + r[n])
    assert np.isinf(want_lo[:, 0]).all() and np.isfinite(want_lo[:, 1]).all()
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    flo, fhi = tf.gaussian_tile_boxes(mix, spec, tr.TN, rad)
    assert torch.equal(lo, flo) and torch.equal(hi, fhi)


BAD = {
    "rad short": dict(rad=lambda r: r[:-1]),
    "rad 2-D": dict(rad=lambda r: r[:, None]),
    "rad none": dict(rad=lambda r: None),
    "lo alone": dict(lo=lambda lo: lo, hi=None),
    "hi alone": dict(lo=None, hi=lambda hi: hi),
    "boxes of other tiles": dict(lo=lambda lo: lo[:, :-1],
                                 hi=lambda hi: hi[:, :-1]),
    "boxes transposed": dict(lo=lambda lo: lo.T, hi=lambda hi: hi.T),
    "split 3": dict(split=3),
    "split (2, 1)": dict(split=(2, 1)),
    "split True": dict(split=True),
}


@pytest.mark.parametrize("case", list(BAD))
def test_fused_rk4_refuses_before_any_launch(case):
    mix, spec, x = _state(2)
    muT, ppT, v, rad = _kernel_args(mix, spec)
    lo, hi = tr.tile_boxes(muT, rad)
    bad = BAD[case]
    kw = {"split": bad.get("split")}
    r = bad["rad"](rad) if "rad" in bad else rad
    for name, box in (("lo", lo), ("hi", hi)):
        kw[name] = (bad[name](box) if bad[name] else None) if name in bad \
            else box
    tr.reset_launches()
    with pytest.raises(ValueError):
        tr.fused_rk4(x, muT, ppT, v, -0.05, spec.clamp_threshold, 2, r,
                     **kw)
    assert tr.launches["rk4_fused"] == 0


@pytest.mark.parametrize("split", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("d", [2, 3])
def test_fused_rk4_on_the_cpu_is_the_plain_twin(split, d):
    """Any valid split, the field's radii and boxes, radii that would skip
    every pair or boxes that would skip every tile: a CPU tensor takes the
    plain twin, bitwise, and launches nothing."""
    mix, spec, x = _state(d)
    muT, ppT, v, rad = _kernel_args(mix, spec)
    lo, hi = tr.tile_boxes(muT, rad)
    c = spec.clamp_threshold
    want = tr.rk4_plain(x, muT, ppT, v, -0.05, c, d)
    assert float((want[0] - x).abs().max()) > 0
    tr.reset_launches()
    none = (torch.full_like(lo, float("inf")),
            torch.full_like(hi, float("-inf")))
    for r, boxes in ((rad, (lo, hi)), (-torch.ones_like(rad), (lo, hi)),
                     (rad, none)):
        got = tr.fused_rk4(x, muT, ppT, v, -0.05, c, d, r, *boxes,
                           split=split)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tr.launches["rk4_fused"] == 0


def test_rk4_valjac_fused_hands_the_kernel_the_fields_radii_and_boxes(
        monkeypatch):
    mix, spec, x = _state(2)
    seen = {}
    fused = tr.fused_rk4

    def spy(*a):
        seen["rad"], seen["lo"], seen["hi"] = a[7:10]
        return fused(*a)
    monkeypatch.setattr(tr, "fused_rk4", spy)
    phi, val, jac = tf.rk4_valjac_fused(mix, spec, x, -0.05)
    assert phi.shape == (37, 2) and val.shape == (37, 2) \
        and jac.shape == (37, 2, 2)
    rad = tf.row_radius(mix, spec, tr.TN)
    lo, hi = tf.gaussian_tile_boxes(mix, spec, tr.TN, rad)
    assert torch.equal(seen["rad"], rad)
    assert torch.equal(seen["lo"], lo) and torch.equal(seen["hi"], hi)
