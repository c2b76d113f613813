"""The 3D entry points' volumes against the JAX package's, on the CPU:
``write_vti_field`` on a 9x7x5 grid; ``initialize_3d(viz=True)`` on
ring_with_obstacle and leapfrog at 5^3 Gaussians and an 8^3 volume grid,
where both packages write the same files; the four reference volumes of
the analytic field; the frame volumes of one checkpoint (the JAX
package's, loaded by the port); and ``advance_3d(viz=True)``'s start-frame
and frame volumes. The JAX package's advance also draws ``loss_1.png``,
which the port does not.

Tolerances: the reference volumes are the same closed form in f32 in two
libraries, 1e-5 of the largest entry; the frame volumes are curl and
divergence of a Jacobian that each package sums in its own order over the
same checkpoint, 1e-4 of the largest entry (as the chip smoke holds the
kernels)."""

import os

import numpy as np
import pytest
import torch

from gaussian_fluids_tpu.io import vti as jvti
from gaussian_fluids_tpu.solver import simulate3d as jsim

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.io import vti as tvti
from gaussian_fluids_torch.scenes import get_scene_3d as tscene
from gaussian_fluids_torch.solver import simulate3d as tsim

from torch_parity import close

SCENES = ("ring_with_obstacle", "leapfrog")
KW = dict(max_epoch=4, batch_size=128, particle_count=(5, 5, 5),
          viz_res=(8, 8, 8), verbose=0)
REF = ("velocity_ref", "vorticity_ref", "divergence_ref", "helicity_ref")


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    """Per scene: the JAX package's and the port's initialize_3d output
    directories."""
    out = {}
    for scene in SCENES:
        jdir = str(tmp_path_factory.mktemp(f"jax_{scene}"))
        tdir = str(tmp_path_factory.mktemp(f"torch_{scene}"))
        jsim.initialize_3d(scene, jdir, viz=True, **KW)
        tsim.initialize_3d(scene, tdir, viz=True, device="cpu", **KW)
        out[scene] = jdir, tdir
    return out


@pytest.mark.parametrize("field", ["coordinate", "smooth"])
def test_write_vti_field_matches(tmp_path, field):
    """A field of the coordinates (the same f32 numbers in both packages:
    the files match byte for byte) and a smooth one (within 1e-6)."""
    dom = (0.0, 1.0, -0.5, 0.5, 0.25, 2.0)
    if field == "coordinate":
        jf, tf = (lambda x: x[:, 1]), (lambda x: x[:, 1])
    else:
        jf = lambda x: np.sin(3 * x[:, 0]) * x[:, 2] + x[:, 1] ** 2  # noqa
        tf = lambda x: torch.sin(3 * x[:, 0]) * x[:, 2] + x[:, 1] ** 2  # noqa
    tp, jp = str(tmp_path / "t.vti"), str(tmp_path / "j.vti")
    tvti.write_vti_field(tf, dom, tp, x_n=9, y_n=7, z_n=5, chunk=64)
    jvti.write_vti_field(jf, dom, jp, x_n=9, y_n=7, z_n=5, chunk=64)
    got, want = tvti.read_vti_array(tp), jvti.read_vti_array(jp)
    assert got.shape == (9, 7, 5)
    if field == "coordinate":
        assert open(tp, "rb").read() == open(jp, "rb").read()
    close(got, want, 1e-6)
    head = open(tp, "rb").read(1000)
    assert b'Spacing="0.111111111 0.142857143 0.35"' in head
    assert b'<AppendedData encoding="raw">' in head


@pytest.mark.parametrize("scene", SCENES)
def test_initialize_writes_the_jax_file_set(inits, scene):
    jdir, tdir = inits[scene]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    want = {f"{n}.vti" for n in REF} | {"vorticity_0.vti",
                                         "divergence_0.vti",
                                         "gaussian_velocity_0.pt"}
    if scene == "ring_with_obstacle":
        want.add("obstacle.obj")
        assert open(os.path.join(tdir, "obstacle.obj"), "rb").read() == \
            open(os.path.join(jdir, "obstacle.obj"), "rb").read()
    assert set(os.listdir(tdir)) == want


@pytest.mark.parametrize("name", REF)
@pytest.mark.parametrize("scene", SCENES)
def test_reference_volumes_match(inits, scene, name):
    jdir, tdir = inits[scene]
    got = tvti.read_vti_array(os.path.join(tdir, f"{name}.vti"))
    want = jvti.read_vti_array(os.path.join(jdir, f"{name}.vti"))
    assert got.shape == (8, 8, 8) and np.isfinite(got).all()
    close(got, want, 1e-5)


@pytest.mark.parametrize("scene", SCENES)
def test_frame_volumes_of_the_same_checkpoint(inits, scene, tmp_path):
    """The JAX package's frame-0 checkpoint through the port's
    _write_frame_vti: its vorticity_0 and divergence_0."""
    jdir, _ = inits[scene]
    mix, spec = tckpt.load_checkpoint(
        os.path.join(jdir, "gaussian_velocity_0.pt"), device="cpu")
    tsim._write_frame_vti(str(tmp_path), "0", mix, spec, tscene(scene),
                          (8, 8, 8))
    for name in ("vorticity_0", "divergence_0"):
        got = tvti.read_vti_array(str(tmp_path / f"{name}.vti"))
        want = jvti.read_vti_array(os.path.join(jdir, f"{name}.vti"))
        assert np.abs(want).max() > 0
        close(got, want, 1e-4, err_msg=name)


@pytest.fixture(scope="module")
def advances(inits, tmp_path_factory):
    """One frame of advance_3d(viz=True) on ring_with_obstacle in both
    packages, each from a copy of its own initial directory."""
    import shutil
    jdir0, tdir0 = inits["ring_with_obstacle"]
    jdir = str(tmp_path_factory.mktemp("jax_adv"))
    tdir = str(tmp_path_factory.mktemp("torch_adv"))
    shutil.copytree(jdir0, jdir, dirs_exist_ok=True)
    shutil.copytree(tdir0, tdir, dirs_exist_ok=True)
    adv = dict(dt=.02, last_time=.02, max_epoch=4, batch_size=128,
               viz_res=(8, 8, 8), test_res=(6, 6, 6), verbose=0)
    jsim.advance_3d("ring_with_obstacle", jdir, **adv)
    out = tsim.advance_3d("ring_with_obstacle", tdir, device="cpu", **adv)
    return jdir, tdir, out


def test_advance_writes_the_frame_volumes(advances):
    jdir, tdir, (mix, spec, frames) = advances
    new = {"vorticity_1.vti", "divergence_1.vti", "gaussian_velocity_1.pt"}
    assert new <= set(os.listdir(tdir))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "loss_1.png" in os.listdir(tdir)
    f = frames[0]
    assert f["frame"] == 1 and f["viz_seconds"] >= 0
    assert all(np.isfinite(v) for v in f["project"].values())
    for name in ("vorticity_1", "divergence_1"):
        v = tvti.read_vti_array(os.path.join(tdir, f"{name}.vti"))
        assert v.shape == (8, 8, 8) and np.isfinite(v).all()


def test_advance_rewrites_the_start_frame_volumes(advances, tmp_path):
    """The start frame's volumes are written again from its checkpoint,
    as the JAX package does: the port's equal the port's own frame-0
    files."""
    _, tdir, _ = advances
    mix, spec = tckpt.load_checkpoint(
        os.path.join(tdir, "gaussian_velocity_0.pt"), device="cpu")
    tsim._write_frame_vti(str(tmp_path), "0", mix, spec,
                          tscene("ring_with_obstacle"), (8, 8, 8))
    for name in ("vorticity_0", "divergence_0"):
        assert (tmp_path / f"{name}.vti").read_bytes() == \
            open(os.path.join(tdir, f"{name}.vti"), "rb").read()


def test_no_viz_writes_only_checkpoints(tmp_path):
    tsim.initialize_3d("ring_with_obstacle", str(tmp_path), viz=False,
                       device="cpu", **KW)
    assert sorted(os.listdir(tmp_path)) == ["gaussian_velocity_0.pt",
                                            "obstacle.obj"]


def test_entry_points_switch_the_volumes(monkeypatch, capsys):
    """--no_viz reaches initialize_3d and advance_3d as viz=False, and
    its absence as viz=True; the 3D help lists the obstacle scene."""
    from gaussian_fluids_torch import advance3d, initialize3d
    seen = []
    monkeypatch.setattr(initialize3d, "initialize_3d",
                        lambda *a, **k: seen.append(("init", k["viz"])))
    monkeypatch.setattr(advance3d, "advance_3d",
                        lambda *a, **k: seen.append(("adv", k["viz"])))
    for flags in ([], ["--no_viz"]):
        initialize3d.main(["--device", "cpu"] + flags)
        advance3d.main(["--device", "cpu"] + flags)
    assert seen == [("init", True), ("adv", True), ("init", False),
                    ("adv", False)]
    with pytest.raises(SystemExit):
        advance3d.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "ring_with_obstacle" in out and "--no_viz" in out
