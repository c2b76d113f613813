"""The secondary 2D paths against the JAX package's: the one-step
"rk1-backtrace" covector target and advection scheme, the refusal of an
unknown scheme, and the dense oracle without clamp truncation. A seeded
500-Gaussian mixture in [-5, 5]^2, 200 queries; within 2e-5 (targets),
1e-5 (positions, oracle) of the largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.solver import advect_field as taf
from gaussian_fluids_torch.solver import covector as tcov
from gaussian_fluids_tpu.ops import field as jfield
from gaussian_fluids_tpu.solver import advect_field as jaf
from gaussian_fluids_tpu.solver import covector as jcov

from torch_parity import close, jax_mixture, t, to_torch


@pytest.fixture(scope="module")
def state():
    jm, spec = jax_mixture(500, 8, lo=-5, hi=5)
    tm, ts = to_torch(jm, spec)
    x = np.random.RandomState(9).uniform(-4, 4, (200, 2)).astype(np.float32)
    return jm, spec, tm, ts, x


def test_rk1_target_matches(state):
    jm, spec, tm, ts, x = state
    lo, hi = np.float32([-3.5, -3.5]), np.float32([3.5, 3.5])
    got = tcov.advected_vorticity_2d_rk1(tm, ts, t(x), 0.05, t(lo), t(hi))
    want = jcov.advected_vorticity_2d_rk1(jm, spec, jnp.asarray(x), 0.05,
                                          jnp.asarray(lo), jnp.asarray(hi))
    assert (np.asarray(want) == 0).any()     # some backtraces left
    close(got, want, 2e-5)


@pytest.mark.parametrize("scheme", ["rk4", "rk1-backtrace"])
def test_advection_schemes_match(state, scheme):
    jm, spec, tm, ts, _ = state
    jn = jaf.advect_covector_field_2d(jm, spec, 0.3, scheme)
    tn = taf.advect_covector_field_2d(tm, ts, 0.3, scheme)
    assert tn.n_alive() == int(jn.n_alive())
    assert tn.capacity == jn.capacity
    for k in ("positions", "scalings", "rotations", "values"):
        close(getattr(tn, k), getattr(jn, k), 1e-5, err_msg=k)


def test_unknown_scheme_is_refused(state):
    _, _, tm, ts, _ = state
    with pytest.raises(NotImplementedError):
        taf.advect_covector_field_2d(tm, ts, 0.3, "euler")


def test_dense_oracle_matches(state):
    jm, spec, tm, ts, x = state
    got = tfield.value_dense_oracle(tm, ts, t(x))
    close(got, jfield.value_dense_oracle(jm, spec, jnp.asarray(x)), 1e-5)
    # it has no clamp truncation: it differs from the clamped field
    assert not np.allclose(got.numpy(),
                           tfield.value_dense(tm, ts, t(x)).numpy())
