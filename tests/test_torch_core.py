"""PyTorch port vs the JAX package: FieldSpec, the capacity ladder, the
mixture state, rotations and packed precisions, checkpoints."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.config import FieldSpec as TSpec
from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.models import mixture as tmixture
from gaussian_fluids_torch.ops import rotations as trot
from gaussian_fluids_tpu.config import FieldSpec
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.models import mixture as jmixture
from gaussian_fluids_tpu.ops import rotations as jrot

from torch_parity import close, jax_mixture, t, to_torch


@pytest.mark.parametrize("n,lo,hi", [(5041, -5.0, 5.0), (576, 0.0, 6.3),
                                     (100, -1.0, 2.0)])
def test_field_spec_matches(n, lo, hi):
    js = FieldSpec.create((lo, lo), (hi, hi), n, d=2, vdim=2)
    ts = TSpec.create((lo, lo), (hi, hi), n, d=2, vdim=2)
    assert ts == TSpec(**js.__dict__)
    assert ts.grid_size == js.grid_size
    assert ts.initial_scaling == js.initial_scaling
    assert ts.max_reach(1.7) == js.max_reach(1.7)


@pytest.mark.parametrize("n", [1, 511, 512, 513, 576, 2000, 5041, 9000])
def test_bucket_ladder_matches(n):
    assert tmixture._bucket(n) == jmixture._bucket(n)


def test_mixture_create_and_sort_match():
    rng = np.random.RandomState(3)
    pos = rng.uniform(-4, 4, (700, 2)).astype(np.float32)
    spec = FieldSpec.create((-5, -5), (5, 5), 700, d=2, vdim=2)
    jm = jmixture.GaussianMixture.create(pos, spec).spatially_sorted()
    tm = tmixture.GaussianMixture.create(
        pos, TSpec(**spec.__dict__), device="cpu").spatially_sorted()
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert tm.capacity == jm.capacity and tm.n_alive() == int(jm.n_alive())
    assert float(tm.min_scaling()) == float(jm.min_scaling())


def test_from_arrays_keeps_capacity_and_compacts():
    rng = np.random.RandomState(4)
    n = 300
    arrs = (rng.randn(n, 2), rng.randn(n, 2), rng.randn(n), rng.randn(n, 2))
    spec = FieldSpec.create((-5, -5), (5, 5), n, d=2, vdim=2)
    jm = jmixture.GaussianMixture.from_arrays(*arrs, spec, min_capacity=1024)
    tm = tmixture.GaussianMixture.from_arrays(
        *arrs, TSpec(**spec.__dict__), min_capacity=1024, device="cpu")
    assert tm.capacity == jm.capacity == 1024
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    tp, jp = tm.to_param_dict(), jm.to_param_dict()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_from_numpy_params_roundtrip():
    jm, spec = jax_mixture(200, seed=5)
    tm, _ = to_torch(jm, spec)
    for k, v in jm.params().items():
        np.testing.assert_array_equal(tm.params()[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.alive))


def test_rotations_and_precisions_match():
    rng = np.random.RandomState(6)
    sca = rng.uniform(-1, 2, (257, 2)).astype(np.float32)
    rot = rng.uniform(-4, 4, 257).astype(np.float32)
    close(trot.rotation_matrix_2d(t(rot)), jrot.rotation_matrix_2d(rot),
          1e-6)
    P = jrot.precision_matrix(jnp.asarray(sca), jnp.asarray(rot), 2)
    close(trot.precision_matrix(t(sca), t(rot), 2), P, 1e-5)
    pk = jrot.packed_precision_entries(jnp.asarray(sca), jnp.asarray(rot), 2)
    close(trot.packed_precision_entries(t(sca), t(rot), 2), pk, 1e-6)
    # the packing is [P00, P11, P01] of the full matrix
    close(trot.packed_precision_entries(t(sca), t(rot), 2),
          np.stack([P[:, 0, 0], P[:, 1, 1], P[:, 0, 1]], -1), 1e-5)


def test_rotations_refuse_3d():
    """3D is no longer refused: at d = 3 the packed entries are the upper
    triangle of the quaternion precision matrix, diagonal first, then
    (0,1), (0,2), (1,2). Bad inputs still fail loudly."""
    rng = np.random.RandomState(5)
    s = torch.as_tensor(rng.randn(6, 3).astype(np.float32))
    q = torch.as_tensor(rng.randn(6, 4).astype(np.float32))
    P = trot.precision_matrix(s, q, 3)
    close(trot.packed_precision_entries(s, q, 3),
          torch.stack([P[:, 0, 0], P[:, 1, 1], P[:, 2, 2], P[:, 0, 1],
                       P[:, 0, 2], P[:, 1, 2]], -1), 1e-5)
    with pytest.raises((IndexError, RuntimeError)):
        trot.packed_precision_entries(torch.zeros(4, 3), torch.ones(4, 3), 3)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_load_across(tmp_path, direction):
    jm, spec = jax_mixture(300, seed=7)
    tm, tspec = to_torch(jm, spec)
    path = os.path.join(tmp_path, "gaussian_velocity_3.pt")
    if direction == "jax_to_torch":
        jckpt.save_checkpoint(path, jm, spec)
        got, got_spec = tckpt.load_checkpoint(path, device="cpu")
        want, want_spec = jckpt.load_checkpoint(path)
    else:
        tckpt.save_checkpoint(path, tm, tspec)
        want, want_spec = tckpt.load_checkpoint(path, device="cpu")
        got, got_spec = jckpt.load_checkpoint(path)
    assert got_spec.__dict__ == want_spec.__dict__
    assert sorted(torch.load(path, weights_only=False)) == sorted(
        ["positions", "scalings", "rotations", "values", "clamp_threshold",
         "min_grid_scale", "domain_range"])
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.parametrize("d", [2, 3])
def test_checkpoint_sidecar_loads_as_in_jax(tmp_path, d):
    """A checkpoint the JAX package saved where torch was absent: numpy's
    ``gaussian_velocity_{n}.pt.npz`` with the same keys, and no ``.pt``
    (its io/checkpoint.py:60-71). The port loads it as the JAX package
    does."""
    from torch_parity import jax_mixture_3d
    jm, spec = jax_mixture(300, seed=9) if d == 2 else jax_mixture_3d(300, 9)
    path = os.path.join(tmp_path, "gaussian_velocity_4.pt")
    with open(path + ".npz", "wb") as fd:
        np.savez(fd, **jm.to_param_dict(),
                 clamp_threshold=spec.clamp_threshold,
                 min_grid_scale=spec.min_grid_scale,
                 domain_range=np.asarray(jckpt._domain_range(spec)))
    assert not os.path.exists(path)
    got, got_spec = tckpt.load_checkpoint(path, device="cpu")
    want, want_spec = jckpt.load_checkpoint(path)
    assert got_spec.__dict__ == want_spec.__dict__
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
