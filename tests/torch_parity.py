"""Shared helpers for the PyTorch-port parity tests: the same seeded numpy
inputs go through the JAX package (on the CPU) and through the port."""

import functools

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.config import FieldSpec as TSpec
from gaussian_fluids_torch.models.mixture import from_numpy_params


def jax_mixture(n, seed, lo=-5.0, hi=5.0, spread=4.0, center=0.0):
    """A JAX-package mixture with seeded random shapes and values, and its
    spec (the pattern of tests/test_pallas.py)."""
    import jax.numpy as jnp
    from gaussian_fluids_tpu import FieldSpec, GaussianMixture
    rng = np.random.RandomState(seed)
    spec = FieldSpec.create((lo, lo), (hi, hi), n, d=2, vdim=2)
    mix = GaussianMixture.create(
        rng.uniform(center - spread, center + spread, (n, 2)), spec)
    sca = mix.scalings + rng.uniform(-0.3, 0.3,
                                     mix.scalings.shape).astype(np.float32)
    rot = mix.rotations + rng.uniform(-1, 1,
                                      mix.rotations.shape).astype(np.float32)
    val = (rng.randn(*mix.values.shape)
           * np.asarray(mix.alive)[:, None]).astype(np.float32)
    return GaussianMixture(mix.positions, jnp.asarray(sca), jnp.asarray(rot),
                           jnp.asarray(val), mix.alive), spec


def jax_mixture_3d(n, seed, scale_shift=0.5):
    """A 3D JAX-package mixture in [0, 1]^3 with seeded random shapes,
    quaternions and values, x-sorted (the pattern of tests/test_cells.py),
    and its spec."""
    import jax.numpy as jnp
    from gaussian_fluids_tpu import FieldSpec, GaussianMixture
    r = np.random.RandomState(seed)
    spec = FieldSpec.create((0, 0, 0), (1, 1, 1), n, d=3, vdim=3)
    mix = GaussianMixture.create(r.uniform(0.02, 0.98, (n, 3)), spec)
    p = mix.params()
    p["scalings"] = p["scalings"] + scale_shift \
        + 0.2 * jnp.asarray(r.randn(*p["scalings"].shape), jnp.float32)
    p["rotations"] = jnp.asarray(r.randn(*p["rotations"].shape),
                                 jnp.float32)
    p["values"] = jnp.asarray(r.randn(*p["values"].shape)
                              * np.asarray(mix.alive)[:, None], jnp.float32)
    return mix.with_params(p).spatially_sorted(), spec


def sorted_queries_3d(seed, b, lo=-0.02, hi=1.02):
    """(b, 3) f32 points sorted along coordinate 0."""
    x = np.random.RandomState(seed).uniform(lo, hi, (b, 3)).astype(
        np.float32)
    return x[np.argsort(x[:, 0], kind="stable")]


def to_torch(mix, spec):
    """(port mixture on the CPU, port spec) for a JAX mixture and spec."""
    params = {k: np.asarray(v) for k, v in mix.params().items()}
    return (from_numpy_params(params, np.asarray(mix.alive), "cpu"),
            TSpec(**spec.__dict__))


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol_scale=1e-5, err_msg=""):
    """f32 agreement: |got - want| <= rtol_scale * max(1, max|want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_scale * scale,
                               err_msg=err_msg)


def _warm(state, ones):
    """Optimizer state with a nonzero second moment, as after earlier
    epochs: the Adam step is then linear in the gradient, where a fresh
    state's first step is lr * sign(g) and turns f32 noise in gradients
    near zero into differences of a whole lr."""
    return state._replace(groups={
        k: g._replace(v=1e-2 * ones(g.v)) for k, g in state.groups.items()})


def jopt_warm(params, lrs):
    """A warm JAX-package optimizer state (see ``_warm``)."""
    import jax.numpy as jnp
    from gaussian_fluids_tpu.solver import optim as jopt
    return _warm(jopt.init(params, lrs, patience=50), jnp.ones_like)


def topt_warm(params, lrs):
    """A warm port optimizer state (see ``_warm``)."""
    from gaussian_fluids_torch.solver import optim as topt
    return _warm(topt.init(params, lrs, patience=50), torch.ones_like)


def params_close(tp, jp, msg, tol=1e-5):
    for k in jp:
        close(tp[k], jp[k], tol, err_msg=f"{msg} {k}")


EPOCH_KINDS = ["fit", "clone", "project", "project_ref"]


def _to64(o):
    """Floating tensors of a carry or batch (tuples, dicts, mixtures) in
    float64."""
    from gaussian_fluids_torch.models.mixture import (GaussianMixture,
                                                      mixture_of)
    if isinstance(o, torch.Tensor):
        return o.double() if o.is_floating_point() else o
    if isinstance(o, GaussianMixture):
        return mixture_of(_to64(o.params()), o.alive)
    if isinstance(o, dict):
        return {k: _to64(v) for k, v in o.items()}
    if isinstance(o, tuple):
        vals = [_to64(v) for v in o]
        return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
    return o


def _sort_rows(*arrays):
    o = torch.argsort(arrays[0][:, 0])
    return tuple(a[o] for a in arrays)


def one_epoch_runs(kind, device, monkeypatch, runs):
    """One training epoch of ``kind`` at Leapfrog-2D width, from one seeded
    state and one seeded sample batch, once per (route, presort) of
    ``runs``. Route "centered" is the block-sparse path (the kernels on the
    card, their plain twins on the CPU), which sorts the batch, the
    covector target and the boundary batch along x; route "dense64" is the
    dense path in float64, which never sorts and is free of the f32
    cancellation of the dense form's expanded quadratic. ``presort`` hands the batch in already sorted, so that the
    epoch's own sorts are identities. ``project_ref`` gives the projection
    a precomputed covector target. Returns one (aux, gradients, kernel
    launches) per run; the gradients are read back from Adam's first
    moment, which starts at zero (the parameter update itself rounds to the
    parameters' f32 spacing)."""
    from gaussian_fluids_torch.ops import field, gsr_centered
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.solver import (clone, covector, fit, optim,
                                              project)
    from gaussian_fluids_torch.utils.seeded_state import leapfrog_state

    mix, spec, _ = leapfrog_state(device, seed=91)
    old, _, _ = leapfrog_state(device, seed=92)
    scene = get_scene_2d("leapfrog")
    gen = torch.Generator(device=device).manual_seed(93)
    lo = torch.full((2,), -5.0, device=device)
    hi = torch.full((2,), 5.0, device=device)
    adv = torch.tensor(scene.advance_domain, device=device)
    p = mix.params()

    if kind == "fit":
        epoch = fit.make_fit_epoch(spec, scene.target_velocity,
                                   scene.target_velocity_jac)
        carry = (p, optim.init(p, fit.FIT_LRS_2D), mix.alive)
        xs = fit.uniform_batch(gen, 512, lo, hi)
        presorted = _sort_rows(xs)[0]
    elif kind == "clone":
        epoch = clone._clone_runner(spec).epoch
        stop = torch.rand(mix.capacity, generator=gen, device=device) > 0.5
        carry = (p, optim.init(p, clone.DEFAULT_LRS_CLONE_2D), mix.alive, stop, old)
        xs = fit.uniform_batch(gen, 512, lo, hi)
        presorted = _sort_rows(xs)[0]
    else:
        runner = project._runner_2d(
            spec, "leapfrog", project.ProjectWeights(), 1.0, 512)
        epoch, sample = runner.epoch, runner.sample
        dt = 0.025
        carry = (p, optim.init(p, project.DEFAULT_LRS_2D), mix.alive,
                 mix.positions + 0.01, old, adv, dt)
        data, _, b1, b2 = sample(gen, adv)
        assert b1 is None and b2 is not None   # leapfrog: walls, flux
        ref = None
        if kind == "project_ref":
            with monkeypatch.context() as mp:
                mp.setattr(field, "_use_kernel", lambda x: False)
                ref = covector.advected_vorticity_2d(
                    old, spec, data, dt, *project._scaled_box(
                        adv, scene.scaling_factor))
        xs = (data, ref, b1, b2)
        data_s, *ref_s = _sort_rows(data, *([] if ref is None else [ref]))
        presorted = (data_s, ref_s[0] if ref_s else None, None,
                     _sort_rows(*b2))

    out = []
    for route, presort in runs:
        gsr_centered.reset_launches()
        args = (carry, presorted if presort else xs)
        if route == "dense64":
            args = _to64(args)
        with monkeypatch.context() as mp:
            mp.setattr(field, "_use_kernel",
                       lambda x, c=route == "centered": c)
            new, aux = epoch(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        grads = {k: g.m / (1.0 - optim.BETA1)
                 for k, g in new[1].groups.items()}
        out.append((aux, grads, dict(gsr_centered.launches)))
    return out


EPOCH_KINDS_3D = ["fit", "clone", "project", "project_ref"]


def one_epoch_runs_3d(kind, device, monkeypatch, runs):
    """The 3D twin of :func:`one_epoch_runs`, on a seeded Leapfrog-3D-sized
    state (1000 Gaussians, capacity 1024, B = 512) with the ring_collide
    scene's targets and boundary. Routes: "cells" (the work-list kernels,
    forced at this size, which the field would give the centered ones),
    "centered", and "dense64". Returns one (aux, gradients, kernel
    launches of both kernel modules) per run."""
    from gaussian_fluids_torch.ops import field, gsr_cells, gsr_centered
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.solver import (clone, covector, fit, optim,
                                              project)
    from gaussian_fluids_torch.solver.simulate3d import FIT_LRS_3D
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state

    mix, spec, _ = ring_collide_state(device, seed=94, side=10)
    old, _, _ = ring_collide_state(device, seed=95, side=10)
    scene = get_scene_3d("ring_collide")
    gen = torch.Generator(device=device).manual_seed(96)
    lo, hi = torch.zeros(3, device=device), torch.ones(3, device=device)
    p = mix.params()

    if kind == "fit":
        epoch = fit.make_fit_epoch(spec, scene.velocity, scene.velocity_jac)
        carry = (p, optim.init(p, FIT_LRS_3D), mix.alive)
        xs = fit.uniform_batch(gen, 512, lo, hi)
        presorted = _sort_rows(xs)[0]
    elif kind == "clone":
        epoch = clone._clone_runner(spec).epoch
        stop = torch.rand(mix.capacity, generator=gen, device=device) > 0.5
        carry = (p, optim.init(p, clone.DEFAULT_LRS_CLONE_3D), mix.alive,
                 stop, old)
        xs = fit.uniform_batch(gen, 512, lo, hi)
        presorted = _sort_rows(xs)[0]
    else:
        runner = project._runner_3d(
            spec, "ring_collide", project.ProjectWeights(delta_pos=0.0),
            10.0, 512, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
        epoch, sample = runner.epoch, runner.sample
        dt = 0.02
        carry = (p, optim.init(p, project.DEFAULT_LRS_3D), mix.alive, old,
                 dt)
        data, _, _, bnd = sample(gen)
        rv = rh = None
        if kind == "project_ref":
            with monkeypatch.context() as mp:
                mp.setattr(field, "_use_kernel", lambda x: False)
                rv, rh = covector.advected_vorticity_3d(old, spec, data, dt)
        xs = (data, rv, rh, bnd)
        srt = _sort_rows(data, *([] if rv is None else [rv, rh]))
        presorted = (srt[0], *(srt[1:] if rv is not None else (None, None)),
                     _sort_rows(*bnd))

    out = []
    for route, presort in runs:
        gsr_centered.reset_launches()
        gsr_cells.reset_launches()
        args = (carry, presorted if presort else xs)
        if route == "dense64":
            args = _to64(args)
        with monkeypatch.context() as mp:
            mp.setattr(field, "_use_kernel",
                       lambda x, c=route != "dense64": c)
            mp.setattr(field, "_use_cells",
                       lambda x, n, d, c=route == "cells": c and d == 3)
            new, aux = epoch(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        grads = {k: g.m / (1.0 - optim.BETA1)
                 for k, g in new[1].groups.items()}
        out.append((aux, grads, {**gsr_centered.launches,
                                 **gsr_cells.launches}))
    return out


def assert_epochs_agree(a, b, tol):
    """aux and each group's gradient agree within ``tol`` of the largest
    reference entry (the reference is ``b``)."""
    for got, want, what in [(a[0], b[0], "aux")] + [
            (a[1][k], b[1][k], k) for k in b[1]]:
        scale = float(want.abs().max())
        err = float((got.double() - want.double()).abs().max())
        assert torch.isfinite(got).all(), what
        assert err <= tol * scale, (what, err, scale)


@functools.lru_cache(maxsize=2)
def karman_heads_geometry(device="cpu"):
    """The triple backward's geometry at the smoke's Karman-2D shapes: the
    seeded Karman state, its 512 data rows padded to the query tile, then
    the scene's 3072 boundary rows as one projection epoch draws them
    (generator seed 6); (mix, spec, fused rows x_c, data_rows, and the
    centered prep's muT, ppT, v, tile mask and dilated radii). Cached:
    callers must not change it."""
    from gaussian_fluids_torch.ops import field
    from gaussian_fluids_torch.scenes import get_scene_2d
    from gaussian_fluids_torch.utils.seeded_state import (
        karman_boundary_rows, karman_state)
    mix, spec, x = karman_state(device)
    gen = torch.Generator(device=device).manual_seed(6)
    xb = karman_boundary_rows(get_scene_2d("karman"), gen, 512, device)[0]
    x_dp = field._pad_axis(x, 8)
    x_c, _, _, mu_p, pp_p, v_p, tmask, rad = field._centered_prep(
        mix, spec, torch.cat([x_dp, xb]), 8, 64, presorted=True)
    return (mix, spec, x_c, x_dp.shape[0], mu_p.T.contiguous(),
            pp_p.T.contiguous(), v_p.contiguous(), tmask, rad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


# The tier-1 run spreads test files over several worker processes on a few
# cores; torch's default of one thread per core in every worker
# oversubscribes them.
torch.set_num_threads(min(2, torch.get_num_threads()))
