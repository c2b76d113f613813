"""The last opt-in switches of the JAX package on the port:
``GF_SPATIAL_KEY=morton`` (``ops/spatial.py``'s Morton key and the sorts
that use it), ``GF_PAD_GROWTH`` (the capacity ladder), ``GF_CELLS=0``
(no cells path under ``auto``) and ``GF_SPARSE=0`` (no query sort and no
tile culling in the centered preparation), each against the JAX
package on the same seeded inputs."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.models import mixture as tmixture
from gaussian_fluids_torch.ops import field, spatial
from torch_parity import close, jax_mixture, jax_mixture_3d, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _points(d, n=777, seed=0):
    # a few points outside the box: they clamp to the boundary cells
    return np.random.RandomState(seed).uniform(-0.1, 1.1, (n, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_morton_key_is_bitwise_the_jax_key(d):
    import jax.numpy as jnp
    from gaussian_fluids_tpu.ops import spatial as jspatial
    x = _points(d)
    for lo, hi in (((0.0,) * d, (1.0,) * d),
                   (tuple(x.min(0)), tuple(x.max(0))),
                   ((0.2,) * d, (0.2,) * d)):
        want = np.asarray(jspatial.morton_key(jnp.asarray(x), lo, hi))
        got = spatial.morton_key(torch.from_numpy(x), lo, hi).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_morton_key_refuses_other_dimensions():
    with pytest.raises(ValueError):
        spatial.morton_key(torch.zeros((4, 4)), (0,) * 4, (1,) * 4)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("key", [None, "morton"])
def test_sort_keys_order_as_the_jax_keys(d, key, monkeypatch):
    import jax.numpy as jnp
    from gaussian_fluids_tpu.ops import spatial as jspatial
    if key:
        monkeypatch.setenv("GF_SPATIAL_KEY", key)
    else:
        monkeypatch.delenv("GF_SPATIAL_KEY", raising=False)
    x = _points(d, seed=d)
    lo, hi = (0.0,) * d, (1.0,) * d
    want = np.asarray(jspatial.sort_key(jnp.asarray(x), lo, hi))
    got = spatial.sort_key(torch.from_numpy(x), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(spatial.sort_key_np(x),
                                  jspatial.sort_key_np(x))
    xs, inv = spatial.sort_queries(torch.from_numpy(x), lo, hi)
    np.testing.assert_array_equal(xs[inv].numpy(), x)
    k = spatial.sort_key(xs, lo, hi).numpy()
    assert (np.diff(k.astype(np.float64)) >= 0).all()
    # Morton in 3D only, as the JAX key
    assert (key == "morton" and d == 3) == (got.dtype == np.int32)


def test_sort_key_without_bounds_takes_the_points_extent(monkeypatch):
    monkeypatch.setenv("GF_SPATIAL_KEY", "morton")
    x = torch.from_numpy(_points(3, seed=4))
    np.testing.assert_array_equal(
        spatial.sort_key(x).numpy(),
        spatial.morton_key(x, x.amin(0), x.amax(0)).numpy())
    # batches: one extent over every batch, as the callers' lattice
    xb = x[:770].reshape(10, 77, 3)
    np.testing.assert_array_equal(
        spatial.sort_key(xb).numpy(),
        spatial.morton_key(xb, xb.reshape(-1, 3).amin(0),
                           xb.reshape(-1, 3).amax(0)).numpy())


@pytest.mark.parametrize("key", [None, "morton"])
def test_spatially_sorted_orders_as_the_jax_mixture(key, monkeypatch):
    if key:
        monkeypatch.setenv("GF_SPATIAL_KEY", key)
    else:
        monkeypatch.delenv("GF_SPATIAL_KEY", raising=False)
    mix, spec = jax_mixture_3d(700, seed=11)   # capacity 1024: dead rows
    tmix, _ = to_torch(mix, spec)
    want = mix.spatially_sorted()
    got = tmix.spatially_sorted()
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    # the replay's orders keep x, whatever the key
    np.testing.assert_array_equal(tmix.x_sorted().positions.numpy(),
                                  np.asarray(mix.x_sorted().positions))
    if key:
        assert not torch.equal(got.positions, tmix.x_sorted().positions)


def test_morton_sorted_2d_mixture_stays_x_sorted(monkeypatch):
    monkeypatch.setenv("GF_SPATIAL_KEY", "morton")
    mix, spec = jax_mixture(300, seed=12)
    tmix, _ = to_torch(mix, spec)
    assert torch.equal(tmix.spatially_sorted().positions,
                       tmix.x_sorted().positions)


@pytest.mark.parametrize("growth", [1.25, 1.0, 1.5])
def test_bucket_ladder_as_the_jax_ladder(growth, monkeypatch):
    from gaussian_fluids_tpu.models import mixture as jmixture
    monkeypatch.setattr(jmixture, "_PAD_GROWTH", growth)
    monkeypatch.setattr(tmixture, "_PAD_GROWTH", growth)
    for n in list(range(1, 4000, 37)) + [5041, 24000, 64000, 65941]:
        assert tmixture._bucket(n) == jmixture._bucket(n), n


def test_pad_growth_is_read_at_import():
    code = ("from gaussian_fluids_torch.models.mixture import _bucket, "
            "_PAD_GROWTH; print(_PAD_GROWTH, _bucket(5041))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, GF_PAD_GROWTH="1"))
    assert out.stdout.split() == ["1.0", "5120"]


def test_gf_cells_0_turns_off_the_cells_path(monkeypatch):
    """The dispatch (the card stands in through ``_on_card``) and the
    outputs: with ``GF_CELLS=0`` a call the cells path would take goes
    centered, as the JAX package's ``_use_cells`` decides; the values are
    the JAX package's either way."""
    import jax
    import jax.numpy as jnp
    from gaussian_fluids_tpu.ops import field as jfield
    monkeypatch.delenv("GF_FIELD_BACKEND", raising=False)
    monkeypatch.setattr(jfield.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(field, "_on_card", lambda x: True)
    x_shape = torch.empty((256, 3))
    for env, want in ((None, True), ("1", True), ("0", False)):
        if env is None:
            monkeypatch.delenv("GF_CELLS", raising=False)
        else:
            monkeypatch.setenv("GF_CELLS", env)
        assert field._use_cells(x_shape, 1 << 18, 3) is want
        assert jfield._use_cells(256, 1 << 18, 3) is want
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")

    mix, spec = jax_mixture_3d(300, seed=13)
    tmix, tspec = to_torch(mix, spec)
    x = _points(3, n=300, seed=14)
    # the centered math (the JAX kernel in interpret mode), as the cells
    # and centered plain twins compute it
    want_v, want_j = jfield.value_and_jac_centered(mix, spec, jnp.asarray(x))
    monkeypatch.setattr(field, "_CELLS_MIN_BN", 1)
    calls = []
    orig = field._cells_value_jac
    monkeypatch.setattr(field, "_cells_value_jac",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for env, n_calls in (("1", 1), ("0", 1)):
        monkeypatch.setenv("GF_CELLS", env)
        v, j = field.value_and_jac(tmix, tspec, torch.from_numpy(x),
                                   need_dx=False)
        assert len(calls) == n_calls
        close(v, want_v)
        close(j, want_j)


@pytest.mark.parametrize("dim", [2, 3])
def test_gf_sparse_0_keeps_the_callers_order(dim, monkeypatch):
    import jax.numpy as jnp
    from gaussian_fluids_tpu.ops import field as jfield
    if dim == 2:
        mix, spec = jax_mixture(300, seed=15)
        x = np.random.RandomState(16).uniform(-5, 5, (200, 2))
    else:
        mix, spec = jax_mixture_3d(300, seed=17)
        x = _points(3, n=200, seed=18)
    x = x.astype(np.float32)
    tmix, tspec = to_torch(mix, spec)
    xt = torch.from_numpy(x)
    default = field.value_and_jac_centered(tmix, tspec, xt)
    monkeypatch.setenv("GF_SPARSE", "0")
    x_p, b, inv, *_, tmask, rad = field._centered_prep(
        tmix, tspec, xt, 8, 64, presorted=False)
    jx_p, jb, jinv, *_, jmask = jfield._centered_prep(
        mix, spec, jnp.asarray(x), 256, 512, False)
    assert inv is None and jinv is None and b == jb == 200
    np.testing.assert_array_equal(x_p[:b].numpy(), x)
    np.testing.assert_array_equal(np.asarray(jx_p)[:b], x)
    assert bool((tmask == 1).all()) and bool((np.asarray(jmask) == 1).all())
    got = field.value_and_jac_centered(tmix, tspec, xt)
    want = jfield.value_and_jac_centered(mix, spec, jnp.asarray(x))
    for g, dflt, w in zip(got, default, want):
        close(g, w)
        close(g, dflt.numpy())


def test_cells_sort_under_morton_gives_the_default_values(monkeypatch):
    """The cells path sorts its queries by the key (over the spec's
    bounds) and undoes the sort: the same values in either order."""
    mix, spec = jax_mixture_3d(600, seed=19)
    tmix, tspec = to_torch(mix, spec)
    x = torch.from_numpy(_points(3, n=400, seed=20))
    monkeypatch.delenv("GF_SPATIAL_KEY", raising=False)
    want = field._cells_value_jac(tmix, tspec, x, 3, presorted=False)
    monkeypatch.setenv("GF_SPATIAL_KEY", "morton")
    xs, _ = spatial.sort_queries(x, tspec.lo, tspec.hi)
    assert not torch.equal(xs, x[torch.argsort(x[:, 0])])
    got = field._cells_value_jac(tmix, tspec, x, 3, presorted=False)
    for g, w in zip(got, want):
        close(g, w.numpy())


@pytest.mark.parametrize("kind", ["clone", "project"])
def test_morton_sorted_3d_epochs_keep_batches_aligned(kind, monkeypatch):
    """Under GF_SPATIAL_KEY=morton the 3D epochs sort their batches (and
    the projection its boundary rows, targets alongside) by the Morton
    key: one epoch through the cells and centered routes against the
    float64 dense path, which never sorts."""
    from torch_parity import assert_epochs_agree, one_epoch_runs_3d
    monkeypatch.setenv("GF_SPATIAL_KEY", "morton")
    cells, centered, dense = one_epoch_runs_3d(
        kind, torch.device("cpu"), monkeypatch,
        [("cells", False), ("centered", False), ("dense64", False)])
    assert_epochs_agree(cells, dense, 1e-5)
    assert_epochs_agree(centered, dense, 1e-5)
