"""The port's centered and cells paths against the JAX package's on
committed production checkpoints, not seeded states: Ring-Collide frame
20 (64,000 Gaussians, capacity 75,776) and the Taylor-vortex run's last
frame (71 x 71 Gaussians), each on 256 queries drawn over its domain and
sorted along x. The oracle is the JAX package's own path of the same
name, its Pallas kernels in interpret mode (a few seconds each at these
shapes, so its dense path is not needed). Values and Jacobians within
1e-5 of the largest entry."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.ops import field as jfield

from torch_parity import close

CKPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runs_r2_evidence", "ckpts")
STATES = {"ring_collide_20": "output_3d_ring_collide/gaussian_velocity_20.pt",
          "taylor_vortex_400": "output_tv/gaussian_velocity_400.pt"}
TOL = 1e-5


@pytest.fixture(scope="module", params=sorted(STATES))
def state(request):
    path = os.path.join(CKPTS, STATES[request.param])
    jm, js = jckpt.load_checkpoint(path)
    tm, ts = tckpt.load_checkpoint(path, device="cpu")
    r = np.random.RandomState(len(request.param))
    x = r.uniform(js.lo, js.hi, (256, js.d)).astype(np.float32)
    return jm, js, tm, ts, x[np.argsort(x[:, 0], kind="stable")]


def test_the_checkpoint_is_the_latest(state):
    """The Taylor-vortex fixture is its run's last frame."""
    frames = [int(f.split("_")[-1][:-3]) for f in
              os.listdir(os.path.join(CKPTS, "output_tv"))
              if f.startswith("gaussian_velocity_") and f.endswith(".pt")]
    assert STATES["taylor_vortex_400"].endswith(f"_{max(frames)}.pt")
    assert state[0].capacity == state[2].capacity


@pytest.mark.parametrize("path", ["centered", "cells"])
def test_paths_match_on_the_checkpoint(state, path):
    jm, js, tm, ts, x = state
    if path == "centered":
        jv, jj = jfield.value_and_jac_centered(jm, js, jnp.asarray(x),
                                               presorted=True)
        v, j = tfield.value_and_jac_centered(tm, ts, torch.as_tensor(x),
                                             presorted=True)
    else:
        jv, jj = jfield._cells_value_jac(jm, js, jnp.asarray(x), js.d,
                                         presorted=True)
        v, j = tfield._cells_value_jac(tm, ts, torch.as_tensor(x), ts.d,
                                       presorted=True)
    assert float(np.abs(np.asarray(jv)).max()) > 0
    close(v, jv, TOL, err_msg=f"{path} value")
    close(j, jj, TOL, err_msg=f"{path} jacobian")
