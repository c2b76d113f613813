"""The port's Python counterparts of the JAX package's C++ helpers
(``native/gf_native.cpp`` through ``gaussian_fluids_tpu/utils/native.py``),
on the CPU: the appended-raw .vti writer (``io/vti.py``) and the OBJ
parser (``scenes/mesh.read_obj``). The port builds no native library; its
files and arrays are those of the JAX package's native code, and every
comparison is exact."""

import os

import numpy as np
import pytest
import torch

from gaussian_fluids_tpu.io import vti as jvti
from gaussian_fluids_tpu.scenes import mesh as jmesh
from gaussian_fluids_tpu.utils import native as jnative

from gaussian_fluids_torch.io import vti as tvti
from gaussian_fluids_torch.scenes import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "assets", "bunny_substitute.obj")

# the four edge cases of tests/test_native.py: a quad (fan-triangulated),
# 'v/vt' faces (the normal falls back to the vertex index), negative
# relative indices, and an empty normal slot
OBJS = {
    "quad": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
             "f 1//1 2//1 3//1 4//1\n"),
    "texcoord": ("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
                 "vt 0.9 0.9\nvt 0.8 0.8\nvt 0.7 0.7\nf 1/3 2/2 3/1\n"),
    "negative": ("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nf -3//-3 -2//-2 -1//-1\n"),
    "empty_slot": ("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\nf 1// 2// 3//\n"),
}


def _obj_path(name, tmp_path):
    if name == "bunny":
        return BUNNY
    path = tmp_path / f"{name}.obj"
    path.write_text(OBJS[name])
    return str(path)


def _volume(shape):
    return np.random.RandomState(sum(shape)).randn(*shape) \
        .astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
@pytest.mark.parametrize("shape,name", [((6, 5, 4), "scalars"),
                                        ((9, 7, 5), "vorticity"),
                                        ((1, 1, 1), "d")])
def test_vti_matches_the_native_writer_bytes(tmp_path, shape, name,
                                             as_tensor):
    """The same array gives the file of the JAX package's native writer,
    byte for byte, from a numpy array or a tensor, and both readers read
    it back exactly."""
    v = _volume(shape)
    origin, spacing = (0.0, -1.0, 2.5), (1 / 9, 0.2, 0.3)
    tp, jp = str(tmp_path / "t.vti"), str(tmp_path / "j.vti")
    tvti.write_vti_array(torch.from_numpy(v) if as_tensor else v, origin,
                         spacing, tp, name)
    assert jnative.vti_write_f32(jp, v, origin, spacing, name)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(tvti.read_vti_array(tp), v)
    np.testing.assert_array_equal(jvti.read_vti_array(tp), v)


@pytest.mark.parametrize("origin,spacing", [
    ((-np.pi, 1e-12, 3e8), (1e-7, 2.5, 7.0)),
    ((0.1, 0.2, 0.3), (1 / 3, 1 / 7, 1 / 128)),
    ((-0.0, 5.0, -2.5), (1.0, 1.0, 1.0))])
def test_vti_header_numbers_match_the_native_writer(tmp_path, origin,
                                                    spacing):
    """The header's origin and spacing carry the native writer's ``%.9g``
    digits for numbers that ``str`` would print otherwise."""
    v = _volume((3, 2, 2))
    tp, jp = str(tmp_path / "t.vti"), str(tmp_path / "j.vti")
    tvti.write_vti_array(v, origin, spacing, tp)
    assert jnative.vti_write_f32(jp, v, origin, spacing, "scalars")
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_x_fastest_is_the_files_order():
    """The transposed copy a card volume takes before its host copy is
    the numpy order of the file's payload, and its write equals the
    array's."""
    v = _volume((5, 4, 3))
    got = tvti.x_fastest(torch.from_numpy(v))
    assert isinstance(got, torch.Tensor) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().ravel(), v.ravel(order="F"))
    np.testing.assert_array_equal(tvti.x_fastest(v), got.numpy())


@pytest.mark.parametrize("name", ["bunny"] + list(OBJS))
def test_parse_obj_matches_jax_native(tmp_path, name):
    """The port's parser gives the JAX package's native parser's arrays,
    dtypes included."""
    path = _obj_path(name, tmp_path)
    got, want = tmesh.read_obj(path), jnative.parse_obj(path)
    assert want is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native_on", [True, False],
                         ids=["jax_native", "jax_python"])
@pytest.mark.parametrize("name", ["bunny"] + list(OBJS))
def test_mesh_sampler_arrays_match_jax(tmp_path, monkeypatch, name,
                                       native_on):
    """MeshSampler in both packages, the JAX package's through its native
    parser or (switched off) its Python fallback: the same vertices,
    normals, faces, face normals and area prefix sums."""
    if not native_on:
        monkeypatch.setattr(jnative, "parse_obj", lambda path: None)
    path = _obj_path(name, tmp_path)
    rot = np.eye(3, dtype=np.float32)
    args = (1.0 / 4.8, rot, np.asarray((0.8, 0.3, 0.2), np.float32))
    got, want = tmesh.MeshSampler(path, *args), jmesh.MeshSampler(path, *args)
    for k in ("vertices", "normals", "faces", "facenormals", "area_presum"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
