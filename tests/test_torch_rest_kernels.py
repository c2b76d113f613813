"""The port's last three kernels on the CPU, through their plain twins,
against the JAX package (its Pallas kernels in interpret mode, as
tests/test_pallas.py runs them): dL/dx of the centered field
(``gsr_bwd_dx``), the triple-cotangent backward (``gsr_bwd_dn3``) with
``field.epoch_heads_grads``, and the fused RK4 backtrace (``fused_rk4``)
with ``field.rk4_valjac_fused`` and the covector target's
``GF_FUSED_RK4`` branch. The same seeded numpy inputs go to both
packages. The CUDA kernels against these twins are in
tests/test_torch_cuda.py, which runs on the card.

Tolerances, stated at each comparison: a kernel twin against the Pallas
kernel on the same inputs 1e-5 of the largest reference entry (f32, the
same terms in another order); through the field functions the JAX tests'
own (query gradients rtol 5e-3 / atol 1e-4; RK4 positions rtol 1e-4 /
atol 1e-5, values and Jacobians rtol 1e-3 / atol 1e-5); the epoch heads
1e-4 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_torch.ops import rk4_fused as trk
from gaussian_fluids_torch.solver import covector as tcov
from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.ops import field as jfield
from gaussian_fluids_tpu.ops.pallas import gsr_centered as jk
from gaussian_fluids_tpu.ops.pallas import rk4_fused as jrk
from gaussian_fluids_tpu.solver import covector as jcov

from torch_parity import close, t, to_torch

TB, TN = 64, 256


def _mix(n, d, seed, dead=False):
    """A d-dimensional JAX mixture in [-5, 5]^d with seeded shapes and
    values (tests/test_pallas.py's ``_mix``); ``dead`` kills some rows and
    moves others out of the padded domain."""
    rng = np.random.RandomState(seed)
    spec = FieldSpec.create((-5,) * d, (5,) * d, n, d=d, vdim=d)
    mix = GaussianMixture.create(rng.uniform(-4, 4, (n, d)), spec)
    sca = mix.scalings + jnp.asarray(
        rng.uniform(-0.3, 0.3, mix.scalings.shape), jnp.float32)
    rot = mix.rotations + jnp.asarray(
        rng.uniform(-1, 1, mix.rotations.shape), jnp.float32)
    val = jnp.asarray(rng.randn(*mix.values.shape)
                      * np.asarray(mix.alive)[:, None], jnp.float32)
    pos, alive = mix.positions, mix.alive
    if dead:
        alive = alive.at[5:15].set(False)
        pos = pos.at[20:25].set(40.0)
    return GaussianMixture(pos, sca, rot, val, alive), spec


def _queries(seed, b, d, lo=-4.0, hi=4.0):
    x = np.random.RandomState(seed).uniform(lo, hi, (b, d)).astype(
        np.float32)
    return x[np.argsort(x[:, 0], kind="stable")]


def _kernel_inputs(d, seed, b=256):
    """The kernels' layout from the JAX prep at tb=64, tn=256, with dead
    rows, and the port's row radii of the same rows (``rad``) and their
    Gaussian tiles' boxes (``boxes``), which the fused RK4 kernel's box
    tests read; plus seeded cotangents of every
    shape the backwards take."""
    mix, spec = _mix(300, d, seed, dead=True)
    x = _queries(seed + 1, b, d, -5.0, 5.0)
    x_p, _, _, mu_p, pp_p, v_p, tmask = jfield._centered_prep(
        mix, spec, jnp.asarray(x), TB, TN, presorted=True)
    rng = np.random.RandomState(seed + 2)
    cols = (1 + d) * d
    douts = [rng.randn(x_p.shape[0], cols).astype(np.float32)
             for _ in range(2)] + [rng.randn(x_p.shape[0], d)
                                   .astype(np.float32)]
    j = dict(tmask=jnp.asarray(tmask), x=x_p, muT=mu_p.T, ppT=pp_p.T,
             v=v_p)
    tt = {k: t(v) for k, v in j.items()}
    tm, ts = to_torch(mix, spec)
    tt["rad"] = tfield.row_radius(tm, ts, TN)
    tt["boxes"] = trk.tile_boxes(tt["muT"], tt["rad"])
    return j, tt, douts, float(spec.clamp_threshold)


# ---- kernel 4: dL/dx ----

@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("njac", [0, "d"])
def test_bwd_dx_plain_matches_pallas(d, njac):
    njac = d if njac == "d" else 0
    j, tt, douts, clamp = _kernel_inputs(d, 100 + d)
    dout = douts[0][:, :(1 + njac) * d].copy()
    want = jk._bwd(j["tmask"], j["x"], j["muT"], j["ppT"], j["v"], dout, d,
                   d, clamp, TB, TN, njac, need_dx=True)[0]
    got = tk.gsr_bwd_dx(tt["tmask"], tt["x"], tt["muT"], tt["ppT"], tt["v"],
                        t(dout), clamp, njac)
    assert tuple(got.shape) == want.shape
    assert float(jnp.abs(want).max()) > 0
    close(got, want, 1e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("head", ["val", "val_jac"])
def test_query_gradient_matches_jax_grad(d, head):
    """dL/dx through the port's centered field (the autograd function's
    backward, i.e. the dx twin) and through its dense field against
    ``jax.grad`` through the JAX package's centered field in interpret
    mode (tests/test_pallas.py's RK4 differentiability check)."""
    jm, spec = _mix(80, d, seed=d + 30)
    tm, ts = to_torch(jm, spec)
    x = np.random.RandomState(19).uniform(-4, 4, (64, d)).astype(np.float32)
    w = np.random.RandomState(20).randn(64, d, d).astype(np.float32)

    def jloss(q):
        if head == "val":
            return jfield.value_centered(jm, spec, q, tb=TB, tn=TN).sum()
        v, jac = jfield.value_and_jac_centered(jm, spec, q, tb=TB, tn=TN)
        return v.sum() + (jac * w).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    for fn in (tfield.value_and_jac_centered, tfield.value_and_jac_dense):
        xt = t(x).requires_grad_(True)
        v, jac = fn(tm, ts, xt)
        loss = v.sum() if head == "val" else v.sum() + (jac * t(w)).sum()
        (gx,) = torch.autograd.grad(loss, [xt])
        np.testing.assert_allclose(gx.numpy(), want, rtol=5e-3, atol=1e-4,
                                   err_msg=fn.__name__)


# ---- kernel 10: the triple-cotangent backward ----

@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("data_rows", [0, 128, 256])
@pytest.mark.parametrize("use_val12", [True, False])
def test_bwd_dn3_plain_matches_pallas(d, data_rows, use_val12):
    j, tt, douts, clamp = _kernel_inputs(d, 200 + d)
    want = jk.fused_gsr_centered_bwd3(
        j["tmask"], j["x"], j["muT"], j["ppT"], j["v"], *douts, d, d, clamp,
        TB, TN, data_rows, use_val12=use_val12)
    got = tk.gsr_bwd_dn3(tt["tmask"], tt["x"], tt["muT"], tt["ppT"],
                         tt["v"], *(t(o) for o in douts), clamp, d,
                         data_rows, use_val12=use_val12)
    for b, (gb, wb) in enumerate(zip(got, want)):
        for g, w, k in zip(gb, wb, ("dmuT", "dppT", "dv")):
            assert tuple(g.shape) == w.shape
            close(g, w, 1e-5, err_msg=f"block {b + 1} {k}")


def test_bwd_dn3_refuses_data_rows_off_the_tile():
    _, tt, douts, clamp = _kernel_inputs(2, 300)
    args = (tt["tmask"], tt["x"], tt["muT"], tt["ppT"], tt["v"],
            *(t(o) for o in douts), clamp, 2)
    for rows in (4, 12, 300, -8):
        with pytest.raises(ValueError):
            tk.gsr_bwd_dn3(*args, rows)


@pytest.mark.parametrize("d", [2, 3])
def test_epoch_heads_grads_match_jax(d):
    """Losses and the three gradients of ``field.epoch_heads_grads`` (the
    dense path on the CPU) and of ``epoch_heads_grads_centered`` (the
    kernels' twins) against the JAX package's centered version in
    interpret mode (tests/test_pallas.py's heads), within 1e-4 of each
    reference's largest entry."""
    jm, spec = _mix(80, d, seed=d + 60)
    tm, ts = to_torch(jm, spec)
    rng = np.random.RandomState(9)
    x = _queries(10, 48, d)
    xb = _queries(11, 32, d, -4.5, 4.5)
    bn = rng.randn(32, d).astype(np.float32)
    use_val = d == 3

    def heads(np_):
        bnx = jnp.asarray(bn) if np_ is jnp else t(bn)

        def head1(val, jac):
            core = np_.abs(jac).mean()
            return core + (val * val).mean() if use_val else core

        def head2(val, jac):
            tr = jac[:, 0, 0] + jac[:, 1, 1] + (jac[:, 2, 2] if d == 3
                                                 else 0.0)
            return (tr ** 2).mean()

        def head_bnd(vb):
            return np_.abs((vb * bnx).sum(-1)).mean()
        return head1, head2, head_bnd

    (jl, jg) = jfield.epoch_heads_grads_centered(
        jm.params(), jm.alive, spec, jnp.asarray(x), jnp.asarray(xb),
        *heads(jnp), heads_use_val=use_val, tb=16, tn=256)
    for fn in (tfield.epoch_heads_grads, tfield.epoch_heads_grads_centered):
        tl, tg = fn(tm.params(), tm.alive, ts, t(x), t(xb), *heads(torch))
        for a, b in zip(tl, jl):
            close(a, np.asarray(b), 1e-4, err_msg=fn.__name__)
        for i, (ga, gb) in enumerate(zip(tg, jg)):
            for k in gb:
                close(ga[k], gb[k], 1e-4, err_msg=f"{fn.__name__} g{i} {k}")


# ---- kernel 9: the fused RK4 backtrace ----

@pytest.mark.parametrize("d", [2, 3])
def test_rk4_plain_matches_pallas(d):
    """The twin on the kernels' layout, with dead rows and the padded
    Gaussian tail, against ``fused_rk4`` in interpret mode: 1e-5 of the
    largest entry."""
    j, tt, _, clamp = _kernel_inputs(d, 400 + d, b=128)
    for dt in (-0.05, 0.08):
        wphi, wvj = jrk.fused_rk4(j["x"], j["muT"], j["ppT"], j["v"], dt, d,
                                  clamp, 16, TN, d)
        phi, vj = trk.fused_rk4(tt["x"], tt["muT"], tt["ppT"], tt["v"], dt,
                                clamp, d, tt["rad"], *tt["boxes"])
        close(phi, wphi, 1e-5, err_msg=f"phi dt={dt}")
        close(vj, wvj, 1e-5, err_msg=f"valjac dt={dt}")


@pytest.mark.parametrize("dt", [-0.05, 0.08])
def test_rk4_valjac_fused_matches_jax(dt):
    jm, spec = _mix(90, 2, seed=31)
    tm, ts = to_torch(jm, spec)
    x = np.random.RandomState(32).uniform(-4, 4, (70, 2)).astype(np.float32)
    want = jfield.rk4_valjac_fused(jm, spec, jnp.asarray(x), dt, tb=16,
                                   tn=256)
    got = tfield.rk4_valjac_fused(tm, ts, t(x), dt)
    for g, w, (rtol, what) in zip(got, want, ((1e-4, "phi"), (1e-3, "val"),
                                              (1e-3, "jac"))):
        assert tuple(g.shape) == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-5, err_msg=what)


def test_rk4_refuses_what_it_does_not_take():
    jm, spec = _mix(40, 2, seed=33)
    tm, ts = to_torch(jm, spec)
    _, tt, _, clamp = _kernel_inputs(2, 34, b=64)
    with pytest.raises(ValueError):          # not a velocity field
        trk.fused_rk4(tt["x"], tt["muT"], tt["ppT"], tt["v"][:, :1], 0.1,
                      clamp, 2, tt["rad"], *tt["boxes"])
    with pytest.raises(ValueError):          # Jacobian groups of 1
        trk.fused_rk4(tt["x"], tt["muT"], tt["ppT"], tt["v"], 0.1, clamp, 1,
                      tt["rad"], *tt["boxes"])
    with pytest.raises(ValueError):          # queries of another dimension
        tfield.rk4_valjac_fused(tm, ts, torch.zeros(8, 3), 0.1)


def test_covector_fused_branch_matches_jax(monkeypatch):
    """``advected_vorticity_2d`` under ``GF_FUSED_RK4=1`` on the kernels'
    path (forced here; the plain twin stands in for the kernel) against the
    JAX package's under ``GF_FUSED_RK4=1`` and its Pallas backend:
    2e-5 of the largest entry, as the staged target's parity test."""
    jm, spec = _mix(90, 2, seed=3)
    p = jm.params()
    p["values"] = jnp.asarray(0.3 * np.random.RandomState(2).randn(
        *p["values"].shape).astype(np.float32))
    jm = jm.with_params(p)
    tm, ts = to_torch(jm, spec)
    x = _queries(4, 64, 2)
    lo, hi = np.float32([-4.5, -4.5]), np.float32([4.5, 4.5])
    monkeypatch.setenv("GF_FUSED_RK4", "1")
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    want = jcov.advected_vorticity_2d(jm, spec, jnp.asarray(x), 0.05,
                                      jnp.asarray(lo), jnp.asarray(hi),
                                      presorted=True)
    calls = []
    fused = tfield.rk4_valjac_fused
    monkeypatch.setattr(tfield, "_use_kernel", lambda q: True)
    monkeypatch.setattr(tfield, "rk4_valjac_fused",
                        lambda *a: calls.append(1) or fused(*a))
    got = tcov.advected_vorticity_2d(tm, ts, t(x), 0.05, t(lo), t(hi),
                                     presorted=True)
    assert calls == [1]
    close(got, want, 2e-5)
    monkeypatch.setenv("GF_FUSED_RK4", "0")
    monkeypatch.setattr(tfield, "_use_kernel", lambda q: False)
    staged = tcov.advected_vorticity_2d(tm, ts, t(x), 0.05, t(lo), t(hi))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), staged.numpy(), rtol=1e-3,
                               atol=1e-5)
