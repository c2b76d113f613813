"""The port's obstacle meshes and the ring_with_obstacle scene against the
JAX package, on the CPU: the trefoil substitute, the OBJ writers, area
sampling on the JAX package's own draws, the obstacle's loading (and its
in-memory fallback), the combined box + mesh boundary sampler, and the
scene's data and field.

Tolerances: the trefoil, the files and the parsed arrays are exact (the
same numpy code); sampling runs the same f32 arithmetic in two libraries,
which may contract or order it differently: 1e-6 in the unit domain."""

import os

import jax
import numpy as np
import pytest
import torch

from gaussian_fluids_tpu.config import FieldSpec as JSpec
from gaussian_fluids_tpu.models.mixture import GaussianMixture as JMix
from gaussian_fluids_tpu.scenes import boundaries3d as jb3
from gaussian_fluids_tpu.scenes import fields3d as jf3
from gaussian_fluids_tpu.scenes import get_scene_3d as jscene
from gaussian_fluids_tpu.scenes import mesh as jmesh

from gaussian_fluids_torch.scenes import boundaries3d as tb3
from gaussian_fluids_torch.scenes import fields3d as tf3
from gaussian_fluids_torch.scenes import get_scene_3d as tscene
from gaussian_fluids_torch.scenes import mesh as tmesh

from torch_parity import close, t, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "assets", "bunny_substitute.obj")
INFO = jf3.OTHER_INFO["ring_with_obstacle"]
EYE = np.eye(3, dtype=np.float32)


def _samplers():
    args = (INFO["scale"], EYE, INFO["translate"])
    return tmesh.MeshSampler(BUNNY, *args), jmesh.MeshSampler(BUNNY, *args)


@pytest.mark.parametrize("kw", [{}, {"extent": 0.4, "n_u": 60, "n_v": 7}])
def test_trefoil_matches_exactly(kw):
    for g, w in zip(tmesh.generate_trefoil_tube(**kw),
                    jmesh.generate_trefoil_tube(**kw)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_obj_writers_match_bytes(tmp_path):
    v, n, f = jmesh.generate_trefoil_tube(n_u=30, n_v=6)
    tmesh.write_obj(str(tmp_path / "t.obj"), v, n, f)
    jmesh.write_obj(str(tmp_path / "j.obj"), v, n, f)
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    ts, js = _samplers()
    ts.save_obj(str(tmp_path / "ts.obj"))
    js.save_obj(str(tmp_path / "js.obj"))
    assert (tmp_path / "ts.obj").read_bytes() == \
        (tmp_path / "js.obj").read_bytes()


def test_committed_substitute_is_the_trefoil():
    """The mesh generated in memory (the fallback when assets/ lacks the
    file) is the committed substitute's, as parsed from the file."""
    got = tmesh.MeshSampler.from_arrays(
        *(lambda v, n, f: (v, n, f, f))(*tmesh.generate_trefoil_tube()),
        INFO["scale"], EYE, INFO["translate"])
    want, _ = _samplers()
    for k in ("vertices", "normals", "faces", "facenormals", "area_presum"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


@pytest.mark.parametrize("seed,n", [(0, 512), (7, 97)])
def test_mesh_sample_on_jax_draws(seed, n):
    ts, js = _samplers()
    key = jax.random.PRNGKey(seed)
    want = js.sample(key, n)
    ks = jax.random.split(key, 3)
    got = ts.sample_with(*(t(jax.random.uniform(k, (n,))) for k in ks))
    for g, w in zip(got, want):
        assert g.shape == (n, 3)
        close(g, w, 1e-6)


def test_mesh_sample_without_normals(tmp_path):
    """A mesh with no vn lines takes its faces' own normals."""
    path = tmp_path / "tet.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                    "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    ts = tmesh.MeshSampler(str(path), 0.5, EYE, (0.1, 0.2, 0.3))
    js = jmesh.MeshSampler(str(path), 0.5, EYE, (0.1, 0.2, 0.3))
    assert ts.normals.shape == (0, 3)
    key = jax.random.PRNGKey(5)
    want = js.sample(key, 64)
    ks = jax.random.split(key, 3)
    got = ts.sample_with(*(t(jax.random.uniform(k, (64,))) for k in ks))
    for g, w in zip(got, want):
        close(g, w, 1e-6)


def test_load_obstacle_mesh_matches_jax():
    got, want = tb3.load_obstacle_mesh(INFO), jb3.load_obstacle_mesh(INFO)
    for k in ("vertices", "normals", "faces", "facenormals", "area_presum"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_missing_asset_is_generated_in_memory(tmp_path, monkeypatch):
    """Without assets/, the obstacle is the trefoil generated in memory;
    nothing is written."""
    empty = tmp_path / "assets"
    empty.mkdir()
    monkeypatch.setattr(tb3, "ASSET_DIR", str(empty))
    got = tb3.load_obstacle_mesh(INFO)
    want = jb3.load_obstacle_mesh(INFO)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert os.listdir(empty) == []


@pytest.mark.parametrize("seed,n", [(2, 64), (11, 300)])
def test_combined_sampler_on_jax_draws(seed, n):
    """ring_with_obstacle's boundary batch: n box points, then n mesh
    points, each on the JAX package's draws of its key split."""
    key = jax.random.PRNGKey(seed)
    want = jscene("ring_with_obstacle").boundary_sampler(key, n)
    k1, k2 = jax.random.split(key)
    box_u = torch.stack([t(jax.random.uniform(k, (n,)))
                         for k in jax.random.split(k1, 3)])
    mesh_u = torch.stack([t(jax.random.uniform(k, (n,)))
                          for k in jax.random.split(k2, 3)])
    scene = tscene("ring_with_obstacle")
    got = tb3.sample_box_and_mesh(box_u, mesh_u, scene.domain,
                                  scene.mesh_sampler)
    for g, w in zip(got, want):
        assert g.shape == (2 * n, 3)
        close(g, w, 1e-6)


def test_obstacle_samples_inside_the_domain():
    """The port's own draws (mirrors tests/test_scenes.py): 2n points, the
    mesh half strictly inside the unit box, unit normals."""
    scene = tscene("ring_with_obstacle")
    gen = torch.Generator().manual_seed(2)
    d, n = scene.boundary_sampler(gen, 64)
    assert d.shape == n.shape == (128, 3)
    mesh_pts = d[64:]
    assert (mesh_pts > 0).all() and (mesh_pts < 1).all()
    close(torch.linalg.vector_norm(n, dim=-1), np.ones(128), 1e-4)


def test_obstacle_scene_data_match():
    for table in ("DOMAIN", "PARTICLE_COUNT", "VISUALIZE_RES"):
        assert getattr(tf3, table)["ring_with_obstacle"] == \
            getattr(jf3, table)["ring_with_obstacle"]
    got, want = tf3.OTHER_INFO["ring_with_obstacle"], INFO
    assert got.keys() == want.keys()
    for k in ("obj_file", "scale", "translate"):
        assert got[k] == want[k]
    for k in ("ring1", "ring2"):
        assert got[k].__dict__ == want[k].__dict__
        r = want[k]
        for g, w in zip(tf3.ring_particles(r.center, r.normal, r.radius, 50),
                        jf3.ring_particles(r.center, r.normal, r.radius, 50)):
            np.testing.assert_array_equal(g, w)
    scene = tscene("ring_with_obstacle")
    assert scene.mesh_sampler is not None
    assert tscene("ring_collide").mesh_sampler is None


def test_obstacle_field_matches():
    x = np.random.RandomState(3).uniform(0.05, 0.95, (200, 3)) \
        .astype(np.float32)
    want = jscene("ring_with_obstacle")
    got = tscene("ring_with_obstacle")
    close(got.velocity(t(x)), np.asarray(want.velocity(x)), 1e-5)
    close(got.velocity_jac(t(x)), np.asarray(want.velocity_jac(x)), 1e-5)


@pytest.mark.parametrize("d", [2, 3])
def test_write_centers_obj_matches(tmp_path, d):
    pts = np.random.RandomState(d).rand(7, d).astype(np.float32)
    spec = JSpec.create((0,) * d, (1,) * d, 7, d=d, vdim=d)
    jm = JMix.create(pts, spec)
    tm, _ = to_torch(jm, spec)
    tmesh.write_centers_obj(tm, str(tmp_path / "t.obj"))
    jmesh.write_centers_obj(jm, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    assert len((tmp_path / "t.obj").read_text().splitlines()) == 7
