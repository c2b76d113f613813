"""The port's work-list ("cells") path on the CPU against the JAX
package's: the flat work lists bit for bit (empty rows, overflow), the
cells value and Jacobian, their parameter gradients and the two-head
gradients against the JAX cells path (its Pallas kernels in interpret
mode, run as tests/test_cells.py runs them), and the exact overflow
branch. The port side runs the CUDA kernels' plain twins, routed through
the field's dispatch. The CUDA kernels against those twins are in
tests/test_torch_cuda.py, which runs on the card.

Tolerances: the two packages sum the same pairs in another order and
over other tiles (the JAX side at 8 x 128, the port at 8 x 64); values
within 1e-5 of the largest entry, Jacobians and gradients within 2e-5
(sums of hundreds of pairs of this wide-overlap mixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_cells as tc
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.ops import spatial as ts
from gaussian_fluids_torch.solver import losses as tl
from gaussian_fluids_tpu import GaussianMixture
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.ops import spatial as js
from gaussian_fluids_tpu.solver import losses as jl

from torch_parity import (close, jax_mixture_3d, sorted_queries_3d, t,
                          to_torch)


@pytest.fixture()
def cells_env(monkeypatch):
    """The JAX package on its cells path (as tests/test_cells.py runs it);
    the port's dispatch routed to its cells path on the CPU."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "cells")
    monkeypatch.setenv("GF_CELLS_TB", "8")
    monkeypatch.setenv("GF_CELLS_TN", "128")
    monkeypatch.setenv("GF_CELLS_CAP", "0.5")
    monkeypatch.setattr(tf, "_use_cells", lambda x, n, d: d == 3)


def _state(seed, n=500):
    jm, spec = jax_mixture_3d(n, seed)
    return jm, spec, *to_torch(jm, spec)


# ---- flat work lists ----

def _mask(case):
    r = np.random.RandomState(case)
    m = r.rand(13, 17) < 0.3
    m[[2, 7]] = False                       # empty rows
    if case == 3:
        m[:] = False                        # nothing live at all
    if case == 4:
        m[:] = True                         # everything live
    return m


@pytest.mark.parametrize("case,cap", [(0, 100), (1, 80), (2, 40), (3, 13),
                                      (4, 221), (4, 100), (5, 58)])
def test_flat_work_list_bit_identical(case, cap):
    m = _mask(case)
    got = ts.flat_work_list(torch.as_tensor(m), cap)
    want = js.flat_work_list(jnp.asarray(m), cap)
    for g, w, k in zip(got, want, ("rows", "cols", "ok")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    need = int(np.maximum(m.sum(1), 1).sum())
    assert bool(got[2]) == (need <= cap)


def test_work_list_describes_the_mask():
    m = _mask(1)
    rows, cols, ok = ts.flat_work_list(torch.as_tensor(m), 100)
    assert bool(ok)
    got = tc.list_mask(rows, cols, m.shape).numpy().astype(bool)
    np.testing.assert_array_equal(got, m)


def test_sort_key_is_coordinate_zero():
    x = sorted_queries_3d(1, 64)[::-1].copy()
    np.testing.assert_array_equal(ts.sort_key(t(x)).numpy(),
                                  np.asarray(js.sort_key(jnp.asarray(x),
                                                         (0, 0, 0),
                                                         (1, 1, 1))))
    np.testing.assert_array_equal(ts.sort_key_np(x), js.sort_key_np(x))
    xs, inv = ts.sort_queries(t(x))
    jxs, jinv = js.sort_queries(jnp.asarray(x), (0, 0, 0), (1, 1, 1))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


# ---- the cells field against the JAX cells path ----

@pytest.mark.parametrize("presorted", [True, False])
def test_cells_value_jac_matches_jax(cells_env, presorted):
    jm, spec, tm, tspec = _state(3)
    x = sorted_queries_3d(4, 256)
    if not presorted:
        x = x[np.random.RandomState(5).permutation(256)]
    jv, jj = jf.value_and_jac(jm, spec, jnp.asarray(x), presorted=presorted,
                              need_dx=False)
    tc.reset_launches()
    with torch.no_grad():
        tv, tj = tf.value_and_jac(tm, tspec, t(x), presorted=presorted,
                                  need_dx=False)
        tv0 = tf.value(tm, tspec, t(x), presorted=presorted, need_dx=False)
    close(tv, jv, 1e-5)
    close(tj, jj, 2e-5)
    close(tv0, jv, 1e-5)
    assert tc.launches == {k: 0 for k in tc.NAMES}   # CPU: plain twins


def test_cells_gradients_match_jax(cells_env):
    jm, spec, tm, tspec = _state(9, n=300)
    r = np.random.RandomState(10)
    x = sorted_queries_3d(11, 64, 0.0, 1.0)
    ref_v = r.randn(64, 3).astype(np.float32)
    ref_j = r.randn(64, 3, 3).astype(np.float32)

    def jloss(p):
        m = GaussianMixture(p["positions"], p["scalings"], p["rotations"],
                            p["values"], jm.alive)
        v, j = jf.value_and_jac(m, spec, jnp.asarray(x), presorted=True,
                                need_dx=False)
        return jnp.mean(jnp.abs(v - ref_v)) + jnp.mean(jnp.abs(j - ref_j))

    want = jax.grad(jloss)(jm.params())
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in tm.params().items()}
    v, j = tf.value_and_jac(tf.mixture_of(leaves, tm.alive), tspec, t(x),
                            presorted=True, need_dx=False)
    loss = (v - t(ref_v)).abs().mean() + (j - t(ref_j)).abs().mean()
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k in want:
        close(got[k], want[k], 2e-5, err_msg=k)


def test_cells_two_head_grads_match_jax(cells_env):
    jm, spec, tm, tspec = _state(11, n=300)
    x = sorted_queries_3d(12, 64, 0.0, 1.0)
    ref = np.random.RandomState(13).randn(64, 3).astype(np.float32)

    def heads(L, r):
        def h1(val, jac):
            return L.vorticity_loss_3d(jac, r) + (val ** 2).mean()

        def h2(val, jac):
            return L.divergence_loss(jac)
        return h1, h2

    (jl1, jl2), (jg1, jg2) = jf.two_head_grads(
        jm.params(), jm.alive, spec, jnp.asarray(x), *heads(jl, ref))
    (tl1, tl2), (tg1, tg2) = tf.two_head_grads(
        tm.params(), tm.alive, tspec, t(x), *heads(tl, t(ref)))
    close(tl1, jl1, 1e-5)
    close(tl2, jl2, 1e-5)
    for tg, jg in ((tg1, jg1), (tg2, jg2)):
        for k in jg:
            close(tg[k], jg[k], 2e-5, err_msg=k)


def test_cells_cap_overflow_falls_back_exactly(cells_env, monkeypatch):
    """A tiny capacity must sweep the whole fine mask, not drop pairs: the
    port's overflow branch against the JAX package's and the dense
    path."""
    monkeypatch.setenv("GF_CELLS_CAP", "0.0001")
    jm, spec, tm, tspec = _state(7)
    x = sorted_queries_3d(8, 128)
    x_p, _, tmask, lists, _ = tf._cells_prep(tm, tspec, t(x))
    assert int(lists[4]) == 0                       # overflowed
    jv, jj = jf.value_and_jac(jm, spec, jnp.asarray(x), presorted=True,
                              need_dx=False)
    with torch.no_grad():
        tv, tj = tf.value_and_jac(tm, tspec, t(x), presorted=True,
                                  need_dx=False)
        dv, dj = tf.value_and_jac_dense(tm, tspec, t(x))
    close(tv, jv, 1e-5)
    close(tj, jj, 2e-5)
    close(tv, dv, 1e-4)
    close(tj, dj, 1e-4)


def test_overflowed_list_takes_the_mask_branch():
    """With ok = 0 the plain twins ignore the (truncated) list and sweep
    the mask: the result equals the centered sweep exactly."""
    jm, spec, tm, tspec = _state(14)
    x = t(sorted_queries_3d(15, 64))
    x_p, _, tmask, (rows, cols, gt, qt, ok), rad = tf._cells_prep(tm, tspec,
                                                                  x)
    mu_p, pp_p, v_p = tf._padded_param_rows(tm, tspec, tc.TN)
    args = (x_p, mu_p.T.contiguous(), pp_p.T.contiguous(), v_p)
    c = tspec.clamp_threshold
    trunc = (rows[:3].contiguous(), cols[:3].contiguous())
    bad = torch.zeros_like(ok)
    want = tk.fwd_plain(tmask, *args, c, 3)
    torch.testing.assert_close(tc.cells_fwd(*trunc, bad, tmask, *args, c, 3,
                                            rad), want, rtol=0, atol=0)
    torch.testing.assert_close(tc.cells_fwd(rows, cols, ok, tmask, *args, c,
                                            3, rad), want, rtol=0, atol=0)
    dout = torch.as_tensor(np.random.RandomState(16).randn(
        x_p.shape[0], 12).astype(np.float32))
    got = tc.cells_bwd_dn(gt[:3].contiguous(), qt[:3].contiguous(), bad,
                          tmask, *args, dout, c, 3, rad)
    for g, w in zip(got, tk.bwd_dn_plain(tmask, *args, dout, c, 3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cells_path_gives_no_gradient_for_queries():
    jm, spec, tm, tspec = _state(17, n=200)
    x = t(sorted_queries_3d(18, 32)).requires_grad_(True)
    with pytest.raises(NotImplementedError):
        tf._cells_value_jac(tm, tspec, x, 3)


def test_cells_wrappers_validate_lists():
    jm, spec, tm, tspec = _state(19, n=200)
    x = t(sorted_queries_3d(20, 32))
    x_p, _, tmask, (rows, cols, gt, qt, ok), rad = tf._cells_prep(tm, tspec,
                                                                  x)
    mu_p, pp_p, v_p = tf._padded_param_rows(tm, tspec, tc.TN)
    args = (tmask, x_p, mu_p.T.contiguous(), pp_p.T.contiguous(), v_p)
    c = tspec.clamp_threshold
    with pytest.raises(ValueError):                  # lists of two lengths
        tc.cells_fwd(rows, cols[:-1], ok, *args, c, 3, rad)
    with pytest.raises(ValueError):                  # njac neither 0 nor d
        tc.cells_fwd(rows, cols, ok, *args, c, 2, rad)
    with pytest.raises(ValueError):                  # radii of other rows
        tc.cells_fwd(rows, cols, ok, *args, c, 3, rad[:-64])
    with pytest.raises(ValueError):                  # cotangent rows
        tc.cells_bwd_dn(gt, qt, ok, *args, torch.zeros(3, 12), c, 3, rad)
    with pytest.raises(ValueError):
        tc.cells_bwd_dn2(gt, qt, ok, *args, torch.zeros(x_p.shape[0], 3),
                         torch.zeros(x_p.shape[0], 3), c, 0, rad,
                         use_val=False)


def test_cells_dispatch_rules():
    """The JAX package's cells rule with the device in place of its TPU
    test: d = 3, B >= 256, B*N >= 2^26, and only on the card."""
    x = torch.zeros((8192, 3))
    assert not tf._use_cells(x, 75776, 3)            # a CPU tensor
    assert tf._cells_cap(1024, 1184) == int(0.3 * 1024 * 1184) + 1184
