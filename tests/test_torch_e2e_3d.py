"""The 3D slice as a whole, on the CPU: Leapfrog-3D (1000 Gaussians,
capacity 1024) fitted with 40 epochs at B = 256 and advanced one frame
(clone -> advect -> project, 30 epochs each, a 16^3 test grid), once by
the JAX package and once by the port. The two runs draw different random
batches (jax.random vs torch), so they agree statistically, not bit for
bit: the bounds below come from three seeds of both packages (fit error
within 4% of each other, the frame's divergence residual within 1.25x).
Checkpoints then cross between the packages, and the 3D entry points'
flags are checked."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_torch import advance3d, initialize3d
from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.scenes import get_scene_3d as tscene
from gaussian_fluids_torch.solver import simulate3d as ts3
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.solver.simulate3d import advance_3d, initialize_3d

FIT_EPOCHS, FRAME_EPOCHS, BATCH, TEST_RES = 40, 30, 256, (16, 16, 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_lf3"))
    tdir = str(tmp_path_factory.mktemp("torch_lf3"))
    initialize_3d("leapfrog", jdir, max_epoch=FIT_EPOCHS, batch_size=BATCH,
                  viz=False, verbose=0)
    advance_3d("leapfrog", jdir, dt=.02, last_time=.02,
               max_epoch=FRAME_EPOCHS, batch_size=BATCH, viz=False,
               test_res=TEST_RES, verbose=0)
    ts3.initialize_3d("leapfrog", tdir, max_epoch=FIT_EPOCHS,
                      batch_size=BATCH, viz=False, verbose=0, device="cpu")
    out = ts3.advance_3d("leapfrog", tdir, dt=.02, last_time=.02,
                         max_epoch=FRAME_EPOCHS, batch_size=BATCH, viz=False,
                         test_res=TEST_RES, verbose=0, device="cpu")
    return jdir, tdir, out


def _grid():
    g = np.linspace(0.3, 0.9, 12, dtype=np.float32)
    h = np.linspace(0.2, 0.8, 12, dtype=np.float32)
    return np.stack(np.meshgrid(g, h, h, indexing="ij"), -1).reshape(-1, 3)


def _metrics(path):
    """(mean |u - u_ring|, mean (div u)^2) of a checkpoint on the grid
    around the rings, through the port's dense evaluation (either
    package's file loads here)."""
    mix, spec = tckpt.load_checkpoint(path, device="cpu")
    x = torch.as_tensor(_grid())
    with torch.no_grad():
        v, j = tf.value_and_jac(mix, spec, x)
        want = tscene("leapfrog").velocity(x)
    div = j.diagonal(dim1=-2, dim2=-1).sum(-1)
    return float((v - want).abs().mean()), float((div ** 2).mean())


def test_port_writes_the_reference_files(runs):
    jdir, tdir, (mix, spec, frames) = runs
    assert sorted(os.listdir(tdir)) == sorted(
        f for f in os.listdir(jdir) if f.endswith(".pt"))
    assert [f["frame"] for f in frames] == [1]
    assert all(np.isfinite(v) for v in frames[0]["project"].values())
    assert mix.n_alive() == 1000 and mix.capacity == 1024
    assert mix.rotations.shape == (1024, 4)


def test_fit_and_frame_match_the_reference(runs):
    jdir, tdir, _ = runs
    (fit_j, _), (_, div_j) = (_metrics(os.path.join(jdir, f"gaussian_velocity_"
                                                    f"{i}.pt")) for i in (0, 1))
    (fit_t, div0_t), (_, div_t) = (_metrics(os.path.join(
        tdir, f"gaussian_velocity_{i}.pt")) for i in (0, 1))
    assert fit_t <= 1.15 * fit_j, (fit_t, fit_j)
    assert div_t <= 1.5 * div_j, (div_t, div_j)
    assert div_t < div0_t          # the projection lowered the divergence


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_same_3d_checkpoint_same_field_in_both_packages(runs, package):
    """Each package loads the frame-1 checkpoint and evaluates it through
    its centered path (the Pallas kernel in interpret mode; the port's
    kernel twins): the same field within f32 rounding."""
    jdir, tdir, _ = runs
    path = os.path.join(jdir if package == "jax" else tdir,
                        "gaussian_velocity_1.pt")
    x = _grid()
    jm, jspec = jckpt.load_checkpoint(path)
    vj, jj = jf.value_and_jac_centered(jm, jspec, jnp.asarray(x))
    mix, spec = tckpt.load_checkpoint(path, device="cpu")
    with torch.no_grad():
        vt, jt = tf.value_and_jac_centered(mix, spec, torch.as_tensor(x))
    scale = max(1.0, float(np.abs(jj).max()))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), rtol=0,
                               atol=1e-5 * scale)


def test_3d_entry_point_flags(capsys, monkeypatch):
    """--profile is accepted; --mesh parses as the JAX CLI's and is refused
    with --target_grid and beyond the visible cards; --target_grid
    reaches advance_3d, and initialize3d accepts it without using it, as
    the JAX CLI does."""
    from gaussian_fluids_torch import cli as tcli
    from gaussian_fluids_tpu import cli as jcli
    with pytest.raises(SystemExit):
        initialize3d.main(["--help"])
    out = capsys.readouterr().out
    assert "--boundary" in out and "--no_viz" in out
    assert tcli.parse_args_3d(["--profile", "/tmp/p"]).profile == "/tmp/p"
    assert tcli.parse_args_3d(["--mesh", "8"]).mesh == \
        jcli.parse_mesh("8") == (8, 1)
    with pytest.raises(ValueError, match="target_grid"):
        advance3d.main(["--device", "cpu", "--mesh", "2x2",
                        "--target_grid", "64"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="GPUs"):
        advance3d.main(["--mesh", "2"])
    seen = {}
    monkeypatch.setattr(advance3d, "advance_3d",
                        lambda *a, **k: seen.update(advance=k))
    monkeypatch.setattr(initialize3d, "initialize_3d",
                        lambda *a, **k: seen.update(initialize=k))
    flags = ["--device", "cpu", "--target_grid", "64"]
    advance3d.main(flags)
    initialize3d.main(flags)
    assert seen["advance"]["target_grid_res"] == 64
    assert "target_grid_res" not in seen["initialize"]
