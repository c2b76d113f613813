"""The port's copy of the flow-diagnostic probes
(``gaussian_fluids_torch/utils/analysis.py``) against the JAX package's
(``gaussian_fluids_tpu/utils/analysis.py``), on the CPU: both are pure
numpy on the same inputs, so every comparison is exact. The Jacobian
twins are also held to the port's own torch curl and divergence."""

import numpy as np
import pytest
import torch

from gaussian_fluids_tpu.utils import analysis as ja

from gaussian_fluids_torch.solver import losses
from gaussian_fluids_torch.utils import analysis as ta


def _street(n_cores, seed):
    """Alternating-sign vorticity cores along a wake, with noise."""
    xs = np.linspace(0.0, 20.0, 200)
    ys = np.linspace(-4.0, 4.0, 80)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vor = 1e-3 * np.random.RandomState(seed).randn(*X.shape)
    for i in range(n_cores):
        sgn = 1.0 if i % 2 == 0 else -1.0
        vor += sgn * np.exp(-((X - 6.0 - 2.0 * i) ** 2
                              + (Y - sgn) ** 2) / 0.5)
    return vor, xs


@pytest.mark.parametrize("n_cores,seed", [(6, 0), (3, 1), (0, 2)])
def test_street_alternations_match(n_cores, seed):
    vor, xs = _street(n_cores, seed)
    for kw in ({}, {"gate_frac": 0.3}):
        assert ta.street_alternations(vor, xs, 2.0, 0.5, **kw) == \
            ja.street_alternations(vor, xs, 2.0, 0.5, **kw)
    assert ta.street_alternations(vor, xs, 30.0, 0.5) == (0, 0.0)


@pytest.mark.parametrize("periods", [0.0, 2.5, 7.0])
def test_shedding_stats_match(periods):
    t = np.arange(400) * 0.05
    vy = np.sin(2 * np.pi * periods * t / t[-1]) \
        + 1e-3 * np.random.RandomState(3).randn(t.size)
    assert ta.shedding_stats(vy, 0.05, 1.0, 2.0) == \
        ja.shedding_stats(vy, 0.05, 1.0, 2.0)


@pytest.mark.parametrize("d", [2, 3])
def test_jacobian_twins_match(d):
    jac = np.random.RandomState(d).randn(64, d, d).astype(np.float32)
    curl = ta.curl3d_np if d == 3 else ta.curl2d_np
    jcurl = ja.curl3d_np if d == 3 else ja.curl2d_np
    np.testing.assert_array_equal(curl(jac), jcurl(jac))
    np.testing.assert_array_equal(ta.divergence_np(jac),
                                  ja.divergence_np(jac))
    tcurl = losses.curl3d if d == 3 else losses.curl2d
    np.testing.assert_array_equal(curl(jac), tcurl(torch.as_tensor(jac))
                                  .numpy())
    np.testing.assert_allclose(ta.divergence_np(jac),
                               losses.divergence(torch.as_tensor(jac))
                               .numpy(), rtol=0, atol=1e-6)


def test_probe_layouts_and_flux_match():
    for got, want in ((ta.circle_points((0.3, -0.2), 0.7, 33),
                       ja.circle_points((0.3, -0.2), 0.7, 33)),
                      (ta.box_points((0, -1, 0), (1, 1, 2), 17, seed=4),
                       ja.box_points((0, -1, 0), (1, 1, 2), 17, seed=4))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    pts, nrm = ta.box_points((0, 0, 0), (1, 1, 1), 20, seed=5)
    vel = np.random.RandomState(6).randn(*pts.shape)
    assert ta.flux_stats(vel, nrm) == ja.flux_stats(vel, nrm)
    mean, mx = ta.flux_stats(vel, nrm)
    assert 0 <= mean <= mx
