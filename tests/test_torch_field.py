"""The port's ops/field.py against the JAX package's on the CPU: the dense
backend, the kernel prep (packed rows, tile mask), the centered path
through the kernels' plain versions against the Pallas path in interpret
mode (GF_FIELD_BACKEND=pallas), the two-head PCGrad gradients, and the
small diagnostics. Tolerance 1e-5 of the largest reference entry unless
stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.models.mixture import mixture_of
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.solver import losses as tl
from gaussian_fluids_tpu.models.mixture import mixture_of as jmixture_of
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.solver import losses as jl

from torch_parity import close, jax_mixture, t, to_torch


def _setup(n=600, b=300, seed=0, lo=-5, hi=5):
    jm, spec = jax_mixture(n, seed)
    tm, ts = to_torch(jm, spec)
    x = np.random.RandomState(seed + 100).uniform(lo, hi, (b, 2)) \
        .astype(np.float32)
    return jm, spec, tm, ts, x


def test_value_and_jac_dense_matches():
    jm, spec, tm, ts, x = _setup()
    vj, jj = jf.value_and_jac_dense(jm, spec, jnp.asarray(x))
    vt, jt = tf.value_and_jac(tm, ts, t(x))        # CPU -> dense
    close(vt, vj, 2e-5)
    close(jt, jj, 2e-5)
    close(tf.value(tm, ts, t(x)), jf.value_dense(jm, spec, jnp.asarray(x)),
          2e-5)


def test_in_domain_support_and_diagnostics_match():
    jm, spec, tm, ts, x = _setup(seed=1)
    pos = np.asarray(jm.positions).copy()
    pos[:20] = 7.0                                   # outside the domain
    jm = type(jm)(jnp.asarray(pos), jm.scalings, jm.rotations, jm.values,
                  jm.alive)
    tm, ts = to_torch(jm, spec)
    np.testing.assert_array_equal(tf.in_domain_mask(tm, ts).numpy(),
                                  np.asarray(jf.in_domain_mask(jm, spec)))
    close(tf.support_radius(tm.scalings, ts.clamp_threshold),
          jf.support_radius(jm.scalings, spec.clamp_threshold), 1e-6)
    close(tf.coverage(tm, ts, t(x)), jf.coverage(jm, spec, jnp.asarray(x)),
          2e-5)
    q = x[:30]
    np.testing.assert_array_equal(
        tf.neighbor_mark(tm, ts, t(q), 0.3).numpy(),
        np.asarray(jf.neighbor_mark(jm, spec, jnp.asarray(q),
                                    jnp.float32(0.3))))


@pytest.mark.parametrize("tb,tn", [(8, 64), (64, 256)])
def test_prep_rows_and_tile_mask_match(tb, tn):
    jm, spec, tm, ts, x = _setup(n=700, b=250, seed=2)
    jx, _, jinv, jmu, jpp, jv, jmask = jf._centered_prep(
        jm, spec, jnp.asarray(x), tb, tn, presorted=False)
    tx, _, tinv, tmu, tpp, tv, tmask, _ = tf._centered_prep(
        tm, ts, t(x), tb, tn, presorted=False)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    close(tpp, jpp, 1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert 0 < tmask.numpy().mean() < 1       # the mask culls here


def test_centered_path_matches_pallas_path(monkeypatch):
    jm, spec, tm, ts, x = _setup(n=700, b=300, seed=3)
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    vj, jj = jf.value_and_jac(jm, spec, jnp.asarray(x))
    vvj = jf.value(jm, spec, jnp.asarray(x))
    vt, jt = tf.value_and_jac_centered(tm, ts, t(x))
    close(vt, vj)
    close(jt, jj)
    close(tf.value_centered(tm, ts, t(x)), vvj)


def _heads(ref_vor_j, ref_vor_t):
    """(jax heads, torch heads): the projection's vorticity and divergence
    losses plus a value-reading head."""
    jh = (lambda v, j: jl.vorticity_loss_2d(j, ref_vor_j),
          lambda v, j: jl.divergence_loss(j),
          lambda v, j: jnp.abs(v).mean())
    th = (lambda v, j: tl.vorticity_loss_2d(j, ref_vor_t),
          lambda v, j: tl.divergence_loss(j),
          lambda v, j: v.abs().mean())
    return jh, th


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("use_val", [False, True])
def test_two_head_grads_match(monkeypatch, backend, use_val):
    jm, spec, tm, ts, x = _setup(n=700, b=256, seed=4)
    x = x[np.argsort(x[:, 0])]
    rv = np.random.RandomState(5).randn(x.shape[0]).astype(np.float32)
    jh, th = _heads(jnp.asarray(rv), t(rv))
    h2 = 2 if use_val else 1
    monkeypatch.setenv("GF_FIELD_BACKEND", backend)
    (jl1, jl2), (jg1, jg2) = jf.two_head_grads(
        jm.params(), jm.alive, spec, jnp.asarray(x), jh[0], jh[h2],
        heads_use_val=use_val)
    seen = []
    if backend == "pallas":
        fn = tf.two_head_grads_centered
        bwd2 = tf.gsr_centered.gsr_bwd_dn2

        def spy(*a, use_val):
            seen.append(use_val)
            return bwd2(*a, use_val=use_val)
        monkeypatch.setattr(tf.gsr_centered, "gsr_bwd_dn2", spy)
    else:
        fn = tf.two_head_grads
    (tl1, tl2), (tg1, tg2) = fn(tm.params(), tm.alive, ts, t(x), th[0],
                                th[h2])
    # the centered path finds by itself whether a head reads the value
    assert seen == ([use_val] if backend == "pallas" else [])
    close(tl1, jl1)
    close(tl2, jl2)
    for k in jg1:
        # parameter gradients are sums over the batch: 1e-4 of the largest
        close(tg1[k], jg1[k], 1e-4, err_msg=k)
        close(tg2[k], jg2[k], 1e-4, err_msg=k)


def test_eval_on_grid_matches():
    jm, spec, tm, ts, x = _setup(n=300, b=1000, seed=6)
    vj, jj = jf.eval_on_grid(jm, spec, x, chunk=256)
    vt, jt = tf.eval_on_grid(tm, ts, x, chunk=256)
    close(vt, vj, 2e-5)
    close(jt, jj, 2e-5)


def test_query_shape_is_checked():
    _, _, tm, ts, _ = _setup(n=50, b=4, seed=7)
    for fn in (tf.value_and_jac, tf.value_and_jac_centered):
        with pytest.raises(ValueError):
            fn(tm, ts, torch.zeros(5, 3))


def test_gradients_through_centered_path_match_jax(monkeypatch):
    """Parameter gradients of a (val, jac) loss through the autograd
    function (kernels 1 and 2) vs jax.grad through the Pallas VJP."""
    jm, spec, tm, ts, x = _setup(n=500, b=200, seed=8)
    x = x[np.argsort(x[:, 0])]
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")

    def jloss(p):
        v, j = jf.value_and_jac(jmixture_of(p, jm.alive), spec,
                                jnp.asarray(x), presorted=True,
                                need_dx=False)
        return jnp.abs(v).mean() + jnp.abs(j).mean()

    jg = jax.grad(jloss)(jm.params())
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in tm.params().items()}
    v, j = tf.value_and_jac_centered(mixture_of(leaves, tm.alive), ts, t(x),
                                     presorted=True)
    tg = torch.autograd.grad(v.abs().mean() + j.abs().mean(),
                             list(leaves.values()))
    for k, g in zip(leaves, tg):
        close(g, jg[k], 1e-4, err_msg=k)
