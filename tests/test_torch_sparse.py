"""The port's cell-list oracle (``ops/sparse.py``) against the JAX
package's: values, Jacobians and two-head gradients at d = 2 and d = 3
(N <= 1,024, B <= 512) within 1e-5 of the largest entry; each guard (a
radius that does not fit its cell, a pair list over its capacity) forces
a counted fallback that still gives the dense sum; the chunked path
equals the unchunked one; two calls give bitwise equal values and
gradients."""

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.ops import sparse as tsp
from gaussian_fluids_tpu.ops import sparse as jsp

from torch_parity import (close, jax_mixture, jax_mixture_3d,
                          sorted_queries_3d, to_torch)

TOL = 1e-5   # of the largest entry


def _case(d):
    """(JAX mixture, JAX spec, queries): 2D, 1,024 Gaussians in [-5, 5]^2
    and 512 queries over [-5.5, 5.5]^2; or 3D, 1,024 narrow Gaussians in
    [0, 1]^3 and 512 queries reaching past the domain."""
    if d == 2:
        jm, js = jax_mixture(1024, 3, spread=4.5)
        p = jm.params()
        p["scalings"] = p["scalings"] + 0.6    # radii within a cell
        x = np.random.RandomState(4).uniform(-5.5, 5.5, (512, 2))
        return jm.with_params(p), js, x.astype(np.float32)
    jm, js = jax_mixture_3d(1024, 5, scale_shift=1.6)
    return jm, js, sorted_queries_3d(6, 512)


def _vor_div(jac):
    d = jac.shape[-1]
    vor = jac[:, 1, 0] - jac[:, 0, 1] if d == 2 else \
        jac[:, 2, 1] - jac[:, 1, 2]
    return vor, sum(jac[:, i, i] for i in range(d))


def _heads(val, jac):
    """A head that reads the value and the Jacobian (either package)."""
    return (_vor_div(jac)[0] ** 2).mean() + (val ** 2).mean()


def _heads_2(val, jac):
    return (_vor_div(jac)[1] ** 2).mean()


@pytest.mark.parametrize("d", [2, 3])
def test_sparse_matches_jax(d):
    import jax.numpy as jnp
    jm, js, x = _case(d)
    tm, ts = to_torch(jm, js)
    xt = torch.as_tensor(x)
    tsp.reset_fallbacks()
    jv, jj = jsp.value_and_jac_sparse(jm, js, jnp.asarray(x))
    assert bool(jsp._sparse_value_jac(
        jm.params(), jm.alive, js, jnp.asarray(x),
        jsp.pair_capacity(512, jm.capacity, js), True)[2])
    v, j = tsp.value_and_jac_sparse(tm, ts, xt)
    assert tsp.fallbacks() == 0       # the pair list served the call
    close(v, jv, TOL)
    close(j, jj, TOL)
    close(tsp.value_sparse(tm, ts, xt), jsp.value_sparse(jm, js,
                                                         jnp.asarray(x)),
          TOL)
    # and the centered masked sum (its plain twin), the path it is the
    # oracle of: the same per-pair quad form, another order of the sums
    close(v, tfield.value_and_jac_centered(tm, ts, xt)[0].numpy(), TOL)
    (jl1, jl2), (jg1, jg2) = jsp.two_head_grads_sparse(
        jm.params(), jm.alive, js, jnp.asarray(x), _heads, _heads_2)
    (l1, l2), (g1, g2) = tsp.two_head_grads_sparse(
        tm.params(), tm.alive, ts, xt, _heads, _heads_2)
    close(l1, jl1, TOL)
    close(l2, jl2, TOL)
    for k in g1:
        close(g1[k], jg1[k], TOL, err_msg=k)
        close(g2[k], jg2[k], TOL, err_msg=k)



@pytest.mark.parametrize("guard, env", [
    ("radius", {"GF_SPARSE_CELLS": "400"}),
    ("overflow", {"GF_SPARSE_CELLS": "2", "GF_SPARSE_HEADROOM": "1e-6"}),
])
def test_guards_fall_back_and_count(guard, env, monkeypatch):
    """A failed guard sends the whole call to the chunked dense sweep (on
    the CPU), which still gives the dense sum, and is counted."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm, js, x = _case(2)
    tm, ts = to_torch(jm, js)
    xt = torch.as_tensor(x)
    tsp.reset_fallbacks()
    v, j = tsp.value_and_jac_sparse(tm, ts, xt)
    assert tsp.fallbacks() == 1, guard
    dv, dj = tfield.value_and_jac_dense(tm, ts, xt)
    assert torch.equal(v, dv) and torch.equal(j, dj)
    tsp.two_head_grads_sparse(tm.params(), tm.alive, ts, xt, _heads,
                              _heads_2)
    assert tsp.fallbacks() == 2, guard


def test_overflow_builds_no_list(monkeypatch):
    """The overflow guard is read from the pair counts alone: no tensor of
    the list's length is made (the list's first, ``repeat_interleave``,
    would raise) before the call falls back."""
    monkeypatch.setenv("GF_SPARSE_CELLS", "2")
    monkeypatch.setenv("GF_SPARSE_HEADROOM", "1e-6")
    jm, js, x = _case(2)
    tm, ts = to_torch(jm, js)
    xt = torch.as_tensor(x)

    def refuse(*args, **kwargs):
        raise AssertionError("an overflowing pair list was built")

    monkeypatch.setattr(torch, "repeat_interleave", refuse)
    tsp.reset_fallbacks()
    v, j = tsp.value_and_jac_sparse(tm, ts, xt)
    assert tsp.fallbacks() == 1
    dv, dj = tfield.value_and_jac_dense(tm, ts, xt)
    assert torch.equal(v, dv) and torch.equal(j, dj)


def test_chunked_equals_unchunked(monkeypatch):
    jm, js, x = _case(3)
    tm, ts = to_torch(jm, js)
    xt = torch.as_tensor(x)
    v1, j1 = tsp.value_and_jac_sparse(tm, ts, xt)
    monkeypatch.setenv("GF_SPARSE_CHUNK", "100")   # 512 = 5 x 100 + 12
    v2, j2 = tsp.value_and_jac_sparse(tm, ts, xt)
    # each query's pair segment is summed alike in either list
    assert torch.equal(v1, v2) and torch.equal(j1, j2)


def test_two_calls_are_bitwise_equal():
    jm, js, x = _case(2)
    tm, ts = to_torch(jm, js)
    xt = torch.as_tensor(x)
    a = tsp.two_head_grads_sparse(tm.params(), tm.alive, ts, xt, _heads,
                                  _heads_2)
    b = tsp.two_head_grads_sparse(tm.params(), tm.alive, ts, xt, _heads,
                                  _heads_2)
    for la, lb in zip(a[0], b[0]):
        assert torch.equal(la, lb)
    for ga, gb in zip(a[1], b[1]):
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k
