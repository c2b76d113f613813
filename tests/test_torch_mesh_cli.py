"""``--mesh BxG`` through the port's entry points on the CPU (gloo ranks):
the flag's parsing and refusals as in the JAX package
(``tests/test_mesh_cli.py``), ``advance2d --mesh 2x1`` for two frames
with a forced split against a single-device run from the same
checkpoint, ``advance_density3d --mesh 2x1``'s launch and its ranks'
replay step at a 32^3 grid against the single-device step, and
``advance_3d`` on a mesh for one Leapfrog-3D frame with its volumes.

The frame loops draw their batches per batch row of the mesh, so a mesh
run and a single-device run agree statistically: the fields within 5% of
the field's scale, the JAX package's bound for its own mesh frame loop
(``parallel/sharding.py dryrun``); the splitting decisions, and so the
Gaussian counts, exactly. The density step draws nothing: rtol 1e-5,
atol 1e-6, as ``tests/test_parallel.py``'s density step."""

import os
import shutil

import numpy as np
import pytest
import torch

from gaussian_fluids_torch import (advance2d, advance3d, advance_density3d,
                                   cli)
from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.io import checkpoint, vti
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.parallel.mesh import launch, mesh_from_shape
from gaussian_fluids_torch.solver import simulate2d, simulate3d
from gaussian_fluids_tpu import cli as jcli

import torch_mesh_ranks as ranks


@pytest.fixture(autouse=True)
def two_threads():
    """The entry points give each CPU rank its share of this process's
    threads: two here, so the ranks of a 2x1 mesh run one each, as the
    other mesh tests' ranks do, whatever else the host runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("text", [None, "", "4x2", "8", "1x1", "2X3",
                                  "4x2x1", "ax2", "0x2", "-1", "2x0"])
def test_parse_mesh_gives_the_jax_answers(text):
    try:
        want = jcli.parse_mesh(text)
    except SystemExit:
        with pytest.raises(SystemExit):
            cli.parse_mesh(text)
        return
    assert cli.parse_mesh(text) == want


def test_mesh_flag_parses_through_cli():
    assert cli.parse_args_2d(["--mesh", "4x2"]).mesh == (4, 2)
    assert cli.parse_args_3d(["--mesh", "8"]).mesh == (8, 1)
    assert cli.parse_args_2d([]).mesh is None


@pytest.mark.parametrize("entry", [advance2d, advance3d])
def test_mesh_with_target_grid_is_refused(entry):
    with pytest.raises(ValueError, match="target_grid"):
        entry.main(["--device", "cpu", "--mesh", "2x1", "--target_grid",
                    "64"])
    with pytest.raises(ValueError, match="target_grid"):
        mesh_from_shape((2, 1), target_grid_res=64, device="cpu")
    assert mesh_from_shape(None, target_grid_res=64) is None


@pytest.mark.parametrize("entry", [advance2d, advance3d, advance_density3d])
def test_gpu_mesh_larger_than_the_visible_cards_is_refused(entry,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_from_shape((2, 1)) == (2, 1)
    assert mesh_from_shape((1, 1), device="cuda:1") == (1, 1)
    for flags in (["--mesh", "3"], ["--mesh", "2x2"],
                  ["--mesh", "2", "--device", "1"]):
        with pytest.raises(ValueError, match="GPUs"):
            entry.main(flags)


def _forced_split_start(d):
    """A tiny taylor_green fit whose first eight rows are stretched past
    the 2D split ratio, so frame 1's clone must grow N under the mesh."""
    simulate2d.initialize_2d("taylor_green", d, max_epoch=60,
                             particle_count=(8, 8), viz=False, verbose=0,
                             device="cpu")
    path = os.path.join(d, "gaussian_velocity_0.pt")
    mix, spec = checkpoint.load_checkpoint(path, device="cpu")
    mix.scalings[:8, 0] += np.log(2.0)
    checkpoint.save_checkpoint(path, mix, spec)
    return mix.n_alive()


def _field_agrees(a, b, x):
    ma, spec = checkpoint.load_checkpoint(a, device="cpu")
    mb, _ = checkpoint.load_checkpoint(b, device="cpu")
    assert ma.n_alive() == mb.n_alive()
    with torch.no_grad():
        va = field.value(ma, spec, torch.as_tensor(x))
        vb = field.value(mb, spec, torch.as_tensor(x))
    scale = float(va.abs().mean())
    err = float((va - vb).abs().mean())
    assert err < 0.05 * scale, (err, scale)
    return ma


def test_advance2d_mesh_matches_single_device(tmp_path):
    """Two frames of ``advance2d --device cpu --mesh 2x1`` from a start
    that must split: one checkpoint a frame, the single-device run's
    Gaussian counts, finite test metrics, and the field within 5% of its
    scale of the single-device run's."""
    single, mesh = str(tmp_path / "single"), str(tmp_path / "mesh")
    n0 = _forced_split_start(single)
    shutil.copytree(single, mesh)
    flags = ["--device", "cpu", "--init_cond", "taylor_green", "--dt",
             ".001", "--last_time", ".002", "--max_epoch", "50", "--no_viz"]
    advance2d.main(flags + ["--dir", single])
    _, _, frames = advance2d.main(flags + ["--dir", mesh, "--mesh", "2x1"])
    assert sorted(os.listdir(mesh)) == [f"gaussian_velocity_{i}.pt"
                                        for i in range(3)]
    assert [f["frame"] for f in frames] == [1, 2]
    for f in frames:
        for phase in ("clone", "project"):
            assert all(np.isfinite(v) for v in f[phase].values()), f
    x = np.random.RandomState(3).uniform(0.5, 5.5, (256, 2)).astype(
        np.float32)
    for n in (1, 2):
        m = _field_agrees(os.path.join(single, f"gaussian_velocity_{n}.pt"),
                          os.path.join(mesh, f"gaussian_velocity_{n}.pt"),
                          x)
    assert m.n_alive() > n0


def _tiny_3d_run(out):
    """27 Gaussians in [0, 1]^3 moving along x (tests/test_torch_density.py's
    replay state), saved as frame 0."""
    spec = FieldSpec.create((0, 0, 0), (1, 1, 1), 27, d=3, vdim=3)
    pos = np.stack(np.meshgrid(*([np.linspace(0.2, 0.8, 3)] * 3),
                               indexing="ij"), -1).reshape(-1, 3)
    mix = GaussianMixture.create(pos, spec, device="cpu")
    mix.values[:, 0] = 0.05 * mix.alive
    mix.values[:, 1] = 0.02 * mix.alive
    checkpoint.save_checkpoint(os.path.join(out, "gaussian_velocity_0.pt"),
                               mix, spec)


def test_advance_density3d_mesh_launches_its_ranks(tmp_path, monkeypatch):
    """``advance_density3d --device cpu --mesh 2x1`` hands the replay's
    arguments to ``launch`` with the entry point's rank function on a 2x1
    gloo mesh; that rank function on such a mesh, one step of both
    densities at a 32^3 grid (the entry point's own grid is 128^3 at the
    least), matches the single-device replay of the same checkpoint, and
    rank 0 alone wrote the volumes."""
    seen = {}
    monkeypatch.setattr(advance_density3d, "launch",
                        lambda *a, **k: seen.update(a=a, k=k) or ["rank 0"])
    assert advance_density3d.main(
        ["--device", "cpu", "--init_cond", "ring_collide", "--dir", "D",
         "--dt", ".02", "--density_res_multiplier", "1", "--mesh",
         "2x1"]) == "rank 0"
    assert seen["a"] == (advance_density3d._rank_main, (2, 1),
                         (("ring_collide", "D", 0.02),
                          {"res_multiplier": 1, "start_frame": 0}, None))
    assert seen["k"] == {"device": "cpu"}
    monkeypatch.undo()

    single, mesh = str(tmp_path / "single"), str(tmp_path / "mesh")
    for d in (single, mesh):
        os.makedirs(d)
        _tiny_3d_run(d)
    kw = {"res_multiplier": 1, "start_frame": 0, "grid_res": (32, 32, 32)}
    simulate3d.advance_density("ring_collide", single, .02, **kw,
                               device="cpu")
    recs = launch(advance_density3d._rank_main, (2, 1),
                  (("ring_collide", mesh, .02), kw), device="cpu",
                  timeout=600)[0]
    assert [r["frame"] for r in recs] == [1]
    assert sorted(os.listdir(mesh)) == sorted(os.listdir(single))
    for tag in ("a", "b"):
        got = vti.read_vti_array(os.path.join(mesh, f"density_{tag}_1.vti"))
        want = vti.read_vti_array(os.path.join(single,
                                               f"density_{tag}_1.vti"))
        assert got.shape == (32, 32, 32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_advance_3d_on_a_mesh_matches_single_device(tmp_path):
    """One Leapfrog-3D frame (1000 Gaussians, 30 epochs a phase, B = 256,
    a 16^3 test grid, 8^3 volumes) on a 1 x 2 mesh: every rank ends with
    the same mixture, rank 0 wrote the checkpoint and the frame's
    volumes, and the field is within 5% of its scale of the single-device
    frame's."""
    single, mesh = str(tmp_path / "single"), str(tmp_path / "mesh")
    simulate3d.initialize_3d("leapfrog", single, max_epoch=40,
                             batch_size=256, viz=False, verbose=0,
                             device="cpu")
    shutil.copytree(single, mesh)
    kw = dict(dt=.02, last_time=.02, max_epoch=30, batch_size=256,
              viz_res=(8, 8, 8), test_res=(16, 16, 16), verbose=0)
    simulate3d.advance_3d("leapfrog", single, device="cpu", **kw)
    out = launch(ranks.advance_3d_rank, (1, 2), (mesh, kw), device="cpu",
                 timeout=600)
    for k, v in out[0]["mix"].items():
        np.testing.assert_array_equal(out[1]["mix"][k], v)
    # the single-device run alone draws the loss curves, as in the JAX
    # package (a mesh run collects none)
    assert sorted(os.listdir(mesh)) == sorted(
        f for f in os.listdir(single) if f != "loss_1.png")
    assert "loss_1.png" in os.listdir(single)
    assert "vorticity_1.vti" in os.listdir(mesh)
    g = np.linspace(0.3, 0.9, 12, dtype=np.float32)
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    _field_agrees(os.path.join(single, "gaussian_velocity_1.pt"),
                  os.path.join(mesh, "gaussian_velocity_1.pt"), x)
