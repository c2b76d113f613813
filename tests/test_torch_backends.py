"""``GF_FIELD_BACKEND`` in the port against the JAX package.

The dispatch of ``value``, ``value_and_jac`` and ``two_head_grads`` under
every mode, for a table of (B, N, d), on the CPU and "on the card" (the
port's ``field._on_card`` patched true; the JAX package's backend
reported as a TPU), equals the JAX package's. One known difference:
under ``auto`` (and ``cells`` for the calls it does not take) the port
takes the centered kernels on the card at every size, where the JAX
package goes dense below B = 256 or B*N = 262,144 on its TPU; the table
holds those rows to that rule.

Then a clone chunk of three epochs (576 Gaussians, B = 512, the JAX
package's draws) under ``dense``, ``pallas``, ``cells`` and ``sparse``
in both packages (JAX's Pallas kernels in interpret mode): the
parameters agree within 1e-5 of each group's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.ops import sparse as tsparse
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_tpu import GaussianMixture
from gaussian_fluids_tpu.ops import field as jfield
from gaussian_fluids_tpu.ops import sparse as jsparse
from gaussian_fluids_tpu.solver import clone as jclone

from torch_parity import (jax_mixture, jopt_warm, params_close, t,
                          to_torch, topt_warm)

MODES = ["auto", "dense", "pallas", "cells", "sparse"]
TABLE = [(128, 512, 2), (512, 6144, 2), (8192, 75776, 3), (8192, 1024, 3),
         (512, 1024, 3), (40000, 6144, 2), (200, 75776, 3)]
CALLS = ["value", "value_nodx", "value_and_jac", "value_and_jac_nodx",
         "two_head_grads"]


class _Took(Exception):
    pass


def _taker(name):
    def f(*a, **k):
        raise _Took(name)
    return f


def _route(fn):
    try:
        fn()
    except _Took as e:
        return e.args[0]
    raise AssertionError("no backend taken")


def _port_routes(mp, b, n, d, card):
    for f in ("value_sparse", "value_and_jac_sparse",
              "two_head_grads_sparse"):
        mp.setattr(tsparse, f, _taker("sparse"))
    mp.setattr(tfield, "_cells_value_jac", _taker("cells"))
    mp.setattr(tfield, "two_head_grads_cells", _taker("cells"))
    for f in ("value_centered", "value_and_jac_centered",
              "two_head_grads_centered"):
        mp.setattr(tfield, f, _taker("centered"))
    for f in ("value_dense", "value_and_jac_dense"):
        mp.setattr(tfield, f, _taker("dense"))
    mp.setattr(tfield, "_on_card", lambda x: card)
    mix = _tmix(n, d)
    x = torch.zeros(b, d)
    p = mix.params()
    return {
        "value": _route(lambda: tfield.value(mix, None, x)),
        "value_nodx": _route(lambda: tfield.value(mix, None, x,
                                                  need_dx=False)),
        "value_and_jac": _route(lambda: tfield.value_and_jac(mix, None, x)),
        "value_and_jac_nodx": _route(lambda: tfield.value_and_jac(
            mix, None, x, need_dx=False)),
        "two_head_grads": _route(lambda: tfield.two_head_grads(
            p, mix.alive, _Spec(d), x, None, None)),
    }


def _jax_routes(mp, b, n, d, tpu):
    for f in ("value_sparse", "value_and_jac_sparse",
              "two_head_grads_sparse"):
        mp.setattr(jsparse, f, _taker("sparse"))
    mp.setattr(jfield, "_cells_value_jac", _taker("cells"))
    mp.setattr(jfield, "two_head_grads_cells", _taker("cells"))
    for f in ("value_centered", "value_and_jac_centered",
              "two_head_grads_centered"):
        mp.setattr(jfield, f, _taker("centered"))
    for f in ("value_dense", "value_and_jac_dense"):
        mp.setattr(jfield, f, _taker("dense"))
    mix = _jmix(n, d)
    x = jnp.zeros((b, d))
    p = mix.params()
    mp.setattr(jax, "default_backend", lambda: "tpu" if tpu else "cpu")
    return {
        "value": _route(lambda: jfield.value(mix, None, x)),
        "value_nodx": _route(lambda: jfield.value(mix, None, x,
                                                  need_dx=False)),
        "value_and_jac": _route(lambda: jfield.value_and_jac(mix, None, x)),
        "value_and_jac_nodx": _route(lambda: jfield.value_and_jac(
            mix, None, x, need_dx=False)),
        "two_head_grads": _route(lambda: jfield.two_head_grads(
            p, mix.alive, _Spec(d), x, lambda v, j: v.sum(),
            lambda v, j: v.sum())),
    }


class _Spec:
    def __init__(self, d):
        self.d = d


def _tmix(n, d):
    """A port mixture of n zero rows: the dispatch reads shapes only."""
    from gaussian_fluids_torch.models.mixture import GaussianMixture as TM
    rot = torch.zeros((n,)) if d == 2 else torch.zeros((n, 4))
    return TM(torch.zeros((n, d)), torch.zeros((n, d)), rot,
              torch.zeros((n, d)), torch.ones(n, dtype=torch.bool))


def _jmix(n, d):
    rot = jnp.zeros((n,)) if d == 2 else jnp.zeros((n, 4))
    return GaussianMixture(jnp.zeros((n, d)), jnp.zeros((n, d)), rot,
                           jnp.zeros((n, d)), jnp.ones(n, bool))


def _known_difference(mode, b, n, card):
    """The port's card rule: the centered kernels at every size where
    the JAX package's TPU rule would go dense."""
    return card and mode not in ("dense", "sparse", "pallas") and not (
        b >= 256 and b * n >= 262_144)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("mode", MODES)
def test_dispatch_matches_the_jax_package(mode, card, monkeypatch):
    monkeypatch.setenv("GF_FIELD_BACKEND", mode)
    for b, n, d in TABLE:
        with monkeypatch.context() as mp:
            got = _port_routes(mp, b, n, d, card)
        with monkeypatch.context() as mp:
            want = _jax_routes(mp, b, n, d, card)
        if _known_difference(mode, b, n, card):
            want = {k: "centered" if v == "dense" else v
                    for k, v in want.items()}
        assert got == want, (mode, card, b, n, d)


def test_the_gates_follow_the_mode(monkeypatch):
    """The hoist, the batches' sort and the fused RK4 gate read the same
    decision: under ``dense`` on the card the hoist is off, under
    ``sparse`` it is on, as in the JAX package's clone and projection."""
    from gaussian_fluids_torch.solver.loop import hoist_default
    monkeypatch.setattr(tfield, "_on_card", lambda x: True)
    x = torch.zeros(4, 2)
    expect = {"auto": True, "dense": False, "pallas": True, "cells": True,
              "sparse": True}
    for mode, on in expect.items():
        monkeypatch.setenv("GF_FIELD_BACKEND", mode)
        assert hoist_default(x) is on, mode
        assert tfield._use_kernel(x) is (mode in ("auto", "pallas",
                                                  "cells")), mode


@pytest.mark.parametrize("mode", ["dense", "pallas", "cells", "sparse"])
def test_clone_chunk_matches_under_each_mode(mode, monkeypatch):
    monkeypatch.setenv("GF_FIELD_BACKEND", mode)
    monkeypatch.setenv("GF_SPARSE_CELLS", "6")   # radii within a cell
    jclone._clone_runner.cache_clear()
    jm, spec = jax_mixture(576, 14, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    tm, ts = to_torch(jm, spec)
    old_j, _ = jax_mixture(576, 15, lo=0.0, hi=10.0, spread=4.8, center=5.0)
    old_t, _ = to_torch(old_j, spec)
    stop = np.random.RandomState(16).rand(jm.capacity) > 0.5
    lrs = dict(jclone.DEFAULT_LRS_CLONE_2D)
    lo, hi = jnp.zeros(2), jnp.full((2,), 10.0)
    run_chunk = jclone._clone_runner(spec, 512, None)[0]
    jc = (jm.params(), jopt_warm(jm.params(), lrs), jm.alive,
          jnp.asarray(stop), old_j.params(), old_j.alive, lo, hi)
    epoch = tclone._clone_runner(ts).epoch
    tc = (tm.params(), topt_warm(tm.params(), lrs), tm.alive, t(stop),
          old_t)
    key = jax.random.PRNGKey(17)
    n = 3
    jc, _ = run_chunk(jc, key, n)
    tsparse.reset_fallbacks()
    for k in jax.random.split(key, n):
        x = jax.random.uniform(k, (512, 2), jnp.float32) * 10.0
        tc, _ = epoch(tc, t(x))
    assert tsparse.fallbacks() == 0
    params_close(tc[0], jc[0], f"clone under {mode}")
    jclone._clone_runner.cache_clear()
