"""The port's centered kernels: each plain PyTorch version against the JAX
Pallas kernel in interpret mode on the CPU (the same tile mask, dead rows
and fully masked tiles), the autograd function against dense autograd, the
wrappers' validation. The CUDA kernels against their plain versions are
in tests/test_torch_cuda.py, which runs on the card.

Tolerance: 1e-5 of the largest reference entry (f32; the two sides sum
the same terms in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.ops import gsr_centered as tk
from gaussian_fluids_tpu.ops import field as jfield
from gaussian_fluids_tpu.ops.pallas import gsr_centered as jk

from torch_parity import close, jax_mixture, t, to_torch

TB, TN = 128, 256


def _inputs(b=512, n=700, seed=11, zero_tile=True):
    """Kernel-layout inputs from the JAX prep, with dead rows (alive False
    and out of the padded domain) and one interacting tile forced off."""
    mix, spec = jax_mixture(n, seed)
    alive = np.asarray(mix.alive).copy()
    alive[5:40] = False
    pos = np.asarray(mix.positions).copy()
    pos[60:70] = 40.0
    mix = type(mix)(jnp.asarray(pos), mix.scalings, mix.rotations,
                    mix.values, jnp.asarray(alive))
    x = np.random.RandomState(seed + 1).uniform(-5, 5, (b, 2))
    x_p, _, _, mu_p, pp_p, v_p, tmask = jfield._centered_prep(
        mix, spec, jnp.asarray(x, jnp.float32), TB, TN, presorted=False)
    rad = tfield.row_radius(*to_torch(mix, spec), TN)
    tmask = np.asarray(tmask).copy()
    if zero_tile:
        i, j = np.argwhere(tmask)[len(np.argwhere(tmask)) // 2]
        tmask[i, j] = 0
    rng = np.random.RandomState(seed + 2)
    douts = [rng.randn(x_p.shape[0], 6).astype(np.float32) for _ in range(2)]
    return dict(tmask=tmask, x=np.asarray(x_p), muT=np.asarray(mu_p.T),
                ppT=np.asarray(pp_p.T), v=np.asarray(v_p), douts=douts,
                clamp=float(spec.clamp_threshold), rad=rad)


def _torch(a):
    return {k: (t(v) if isinstance(v, np.ndarray) else v)
            for k, v in a.items() if k != "douts"}


@pytest.mark.parametrize("njac", [0, 2])
def test_fwd_plain_matches_pallas(njac):
    a = _inputs()
    want = jk._fwd(jnp.asarray(a["tmask"]), a["x"], a["muT"], a["ppT"],
                   a["v"], 2, 2, a["clamp"], TB, TN, njac)
    b = _torch(a)
    got = tk.gsr_fwd(b["tmask"], b["x"], b["muT"], b["ppT"], b["v"],
                     a["clamp"], njac, b["rad"])
    assert got.shape == want.shape == (512, (1 + njac) * 2)
    close(got, want, 1e-5)


@pytest.mark.parametrize("njac", [0, 2])
def test_bwd_dn_plain_matches_pallas(njac):
    a = _inputs(seed=21)
    cols = (1 + njac) * 2
    dout = a["douts"][0][:, :cols].copy()
    _, dmuT, dppT, dv = jk._bwd(jnp.asarray(a["tmask"]), a["x"], a["muT"],
                                a["ppT"], a["v"], dout, 2, 2, a["clamp"],
                                TB, TN, njac, need_dx=False)
    b = _torch(a)
    got = tk.gsr_bwd_dn(b["tmask"], b["x"], b["muT"], b["ppT"], b["v"],
                        t(dout), a["clamp"], njac)
    for g, w, k in zip(got, (dmuT, dppT, dv), ("dmuT", "dppT", "dv")):
        assert tuple(g.shape) == w.shape
        close(g, w, 1e-5, err_msg=k)


@pytest.mark.parametrize("use_val", [True, False])
def test_bwd_dn2_plain_matches_pallas(use_val):
    a = _inputs(seed=31)
    d1, d2 = a["douts"]
    want = jk.fused_gsr_centered_bwd2(
        jnp.asarray(a["tmask"]), a["x"], a["muT"], a["ppT"], a["v"], d1, d2,
        2, 2, a["clamp"], TB, TN, use_val=use_val)
    b = _torch(a)
    got = tk.gsr_bwd_dn2(b["tmask"], b["x"], b["muT"], b["ppT"], b["v"],
                         t(d1), t(d2), a["clamp"], 2, use_val=use_val)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            close(g, w, 1e-5)


def test_masked_tiles_contribute_nothing():
    a = _inputs(seed=41, zero_tile=False)
    b = _torch(a)
    none = torch.zeros_like(b["tmask"])
    out = tk.gsr_fwd(none, b["x"], b["muT"], b["ppT"], b["v"], a["clamp"], 2,
                     b["rad"])
    assert torch.count_nonzero(out) == 0
    dmuT, dppT, dv = tk.gsr_bwd_dn(none, b["x"], b["muT"], b["ppT"], b["v"],
                                   t(a["douts"][0]), a["clamp"], 2)
    assert all(torch.count_nonzero(g) == 0 for g in (dmuT, dppT, dv))


def test_autograd_function_matches_dense_autograd():
    jm, spec = jax_mixture(300, seed=51)
    mix, tspec = to_torch(jm, spec)
    x = t(np.random.RandomState(52).uniform(-4, 4, (100, 2))
          .astype(np.float32))

    def grads(fn):
        leaves = {k: p.clone().requires_grad_(True)
                  for k, p in mix.params().items()}
        m = tfield.mixture_of(leaves, mix.alive)
        v, j = fn(m, tspec, x)
        loss = v.abs().mean() + j.abs().mean() + (v * v).mean()
        return dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))

    gd = grads(tfield.value_and_jac_dense)
    gc = grads(tfield.value_and_jac_centered)
    for k in gd:
        close(gc[k], gd[k], 1e-4, err_msg=k)


def test_no_gradient_for_query_points(monkeypatch):
    """Query points that do not ask for a gradient get none, and the dL/dx
    backward is not run for them; points that ask get one (its value is
    held against the JAX package in tests/test_torch_rest_kernels.py)."""
    jm, spec = jax_mixture(100, seed=53)
    mix, tspec = to_torch(jm, spec)
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in mix.params().items()}
    m = tfield.mixture_of(leaves, mix.alive)
    calls = []
    dx = tk.gsr_bwd_dx
    monkeypatch.setattr(tk, "gsr_bwd_dx",
                        lambda *a: calls.append(1) or dx(*a))
    x = torch.zeros((8, 2))
    tfield.value_centered(m, tspec, x, presorted=True).sum().backward()
    assert x.grad is None and calls == []
    assert all(p.grad is not None for p in leaves.values())
    xg = torch.zeros((8, 2), requires_grad=True)
    tfield.value_centered(mix, tspec, xg, presorted=True).sum().backward()
    assert xg.grad is not None and calls == [1]


def test_wrappers_validate_shapes():
    b = _torch(_inputs(seed=61))
    args = (b["tmask"], b["x"], b["muT"], b["ppT"], b["v"])
    with pytest.raises(ValueError):
        tk.gsr_fwd(*args[:1], b["x"][:, :1], *args[2:], b["clamp"], 2,
                   b["rad"])
    with pytest.raises(ValueError):
        tk.gsr_fwd(b["tmask"][:3], *args[1:], b["clamp"], 2, b["rad"])
    with pytest.raises(ValueError):
        tk.gsr_fwd(*args, b["clamp"], 1, b["rad"])
    with pytest.raises(ValueError):
        tk.gsr_bwd_dn(*args, torch.zeros(3, 6), b["clamp"], 2)
    with pytest.raises(ValueError):
        tk.gsr_bwd_dn2(*args, torch.zeros(512, 2), torch.zeros(512, 2),
                       b["clamp"], 0, use_val=False)


def test_plain_path_counts_no_launches():
    tk.reset_launches()
    b = _torch(_inputs(seed=71))
    tk.gsr_fwd(b["tmask"], b["x"], b["muT"], b["ppT"], b["v"], b["clamp"], 2,
               b["rad"])
    assert tk.launches == {k: 0 for k in ("gsr_fwd", "gsr_bwd_dn",
                                          "gsr_bwd_dn2", "gsr_bwd_dx",
                                          "gsr_bwd_dn3")}
