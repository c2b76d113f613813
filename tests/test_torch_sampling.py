"""The port's Gaussian-importance samplers against the JAX package's,
fed the JAX package's own draws (``pick``, ``z``): the same points within
1e-5 of the largest coordinate, at d = 2 and 3, with a restriction mask,
and one sample per Gaussian with dead rows as uniform domain points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.solver import sampling as tsam
from gaussian_fluids_tpu.config import FieldSpec
from gaussian_fluids_tpu.models.mixture import GaussianMixture
from gaussian_fluids_tpu.solver import sampling as jsam

from torch_parity import close, to_torch

DOMS = {2: (-1.0, 1.0, -1.0, 1.0), 3: (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)}


def _mix(d, n=40, seed=0):
    r = np.random.RandomState(seed)
    spec = FieldSpec.create((-1.0,) * d, (1.0,) * d, n, d=d, vdim=d)
    mix = GaussianMixture.create(r.uniform(-0.9, 0.9, (n, d)), spec)
    p = mix.params()
    p["scalings"] = p["scalings"] + jnp.asarray(
        r.uniform(-0.5, 0.5, p["scalings"].shape), jnp.float32)
    p["rotations"] = jnp.asarray(r.randn(*p["rotations"].shape),
                                 jnp.float32)
    return mix.with_params(p), spec


def _jax_draws(key, ok, n, d):
    """The (pick, z) that ``generate_gaussians`` draws from ``key``."""
    kp, kz, _ = jax.random.split(key, 3)
    pick = jax.random.categorical(kp, jnp.where(ok, 0.0, -jnp.inf),
                                  shape=(n,))
    return np.asarray(pick), np.asarray(jax.random.normal(kz, (n, d),
                                                          jnp.float32))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("restricted", [False, True])
def test_generate_gaussians_matches(d, restricted):
    jm, spec = _mix(d)
    tm, ts = to_torch(jm, spec)
    restrict = np.arange(jm.capacity) % 3 == 0 if restricted else None
    key = jax.random.PRNGKey(7)
    want = jsam.generate_gaussians(
        key, jm, spec, DOMS[d], 300,
        None if restrict is None else jnp.asarray(restrict))
    ok = np.asarray(jm.alive) & (True if restrict is None else restrict)
    pick, z = _jax_draws(key, ok, 300, d)
    got = tsam.generate_gaussians(
        None, tm, ts, DOMS[d], 300,
        None if restrict is None else torch.as_tensor(restrict),
        pick=torch.as_tensor(pick.copy()), z=torch.as_tensor(z.copy()))
    close(got, want, 1e-5)
    assert (np.abs(np.asarray(want)) == 1.0).any()   # some were clamped
    # its own draws stay within the domain and near allowed Gaussians
    own = tsam.generate_gaussians(torch.Generator().manual_seed(0), tm, ts,
                                  DOMS[d], 300)
    assert own.shape == (300, d) and bool((own.abs() <= 1.0).all())


@pytest.mark.parametrize("d", [2, 3])
def test_generate_all_gaussians_matches(d):
    jm, spec = _mix(d)
    tm, ts = to_torch(jm, spec)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsam.generate_all_gaussians(key, jm, spec, DOMS[d]))
    kz, _ = jax.random.split(key)
    z = np.asarray(jax.random.normal(kz, (jm.capacity, d), jnp.float32))
    got = tsam.generate_all_gaussians(torch.Generator().manual_seed(1), tm,
                                      ts, DOMS[d], z=torch.as_tensor(z.copy()))
    alive = np.array(jm.alive)
    assert got.shape == want.shape and not alive.all()
    close(got[alive], want[alive], 1e-5)
    # dead rows: uniform points of the domain, in both packages
    assert bool((got[~alive].abs() <= 1.0).all())
    assert (np.abs(want[~alive]) <= 1.0).all()


def test_no_allowed_gaussian_gives_uniform_points():
    jm, spec = _mix(2)
    tm, ts = to_torch(jm, spec)
    x = tsam.generate_gaussians(torch.Generator().manual_seed(2), tm, ts,
                                DOMS[2], 64,
                                restrict=torch.zeros(tm.capacity,
                                                     dtype=torch.bool))
    assert x.shape == (64, 2) and bool((x.abs() <= 1.0).all())
    assert float(x.std()) > 0.3      # spread over the domain
