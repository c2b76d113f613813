"""OBJ obstacle meshes and area-weighted surface sampling — the port of the
JAX package's ``scenes/mesh.py`` (reference 3D/mesh_sampler.py:7-94).

``MeshSampler`` parses v/vn/f (``//`` and ``/`` indices, negative indices,
fan-triangulated polygons) into the arrays of the JAX package's native
parser (``native/gf_native.cpp``), applies scale, rotation and
translation, and samples points uniformly by area with the square-root
barycentric rule and interpolated normals. The sampling arithmetic takes
its three uniforms as tensors (``sample_with``), so tests can feed the JAX
package's draws; ``sample`` draws them from the caller's
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _obj_index(i: int, defined: int) -> int:
    """A 1-based OBJ index, or a negative one counting back from the
    ``defined`` elements so far, as a 0-based index."""
    return i - 1 if i > 0 else defined + i


def read_obj(path: str):
    """(vertices (V, 3) f32, normals (Nn, 3) f32, faces (F, 3) i32,
    facenormals (F, 3) i32) of an OBJ file, its indices resolved as the
    JAX package's native parser resolves them."""
    vertices, normals, faces, facenormals = [], [], [], []
    with open(path) as fd:
        for line in fd:
            if line.startswith("v "):
                vertices.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                vs, ns = [], []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vs.append(_obj_index(int(parts[0]), len(vertices)))
                    # the normal index is the third field ('v//vn',
                    # 'v/vt/vn'); 'v/vt', 'v//' and a bare 'v' take the
                    # vertex index, as the native parser does
                    if len(parts) >= 3 and parts[2]:
                        ns.append(_obj_index(int(parts[2]), len(normals)))
                    else:
                        ns.append(vs[-1])
                for k in range(2, len(vs)):     # fan: (0, k-1, k)
                    faces.append([vs[0], vs[k - 1], vs[k]])
                    facenormals.append([ns[0], ns[k - 1], ns[k]])
    return (np.asarray(vertices, np.float32),
            np.asarray(normals, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32), np.asarray(facenormals, np.int32))


class MeshSampler:
    """An obstacle mesh, transformed: ``vertices`` (V, 3), unit
    ``normals`` (Nn, 3) (empty when the file has none: face normals are
    then the triangles' own), ``faces`` and ``facenormals`` (F, 3) and the
    faces' area prefix sum ``area_presum`` (F,), all numpy f32/i32."""

    def __init__(self, obj_file: str, scale, rotate, translate):
        self._setup(*read_obj(obj_file), scale, rotate, translate)

    @classmethod
    def from_arrays(cls, vertices, normals, faces, facenormals, scale,
                    rotate, translate) -> "MeshSampler":
        """The sampler of a mesh held in memory, as if read from a file."""
        self = cls.__new__(cls)
        self._setup(np.asarray(vertices, np.float32),
                    np.asarray(normals, np.float32).reshape(-1, 3),
                    np.asarray(faces, np.int32),
                    np.asarray(facenormals, np.int32), scale, rotate,
                    translate)
        return self

    def _setup(self, v, normals, faces, facenormals, scale, rotate,
               translate):
        rotate = np.asarray(rotate, np.float32)
        translate = np.asarray(translate, np.float32)
        self.faces, self.facenormals = faces, facenormals
        self.vertices = (scale * v) @ rotate.T + translate
        if len(normals):
            n = normals @ rotate.T
            self.normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
        else:
            self.normals = np.zeros((0, 3), np.float32)
        a = self.vertices[faces[:, 0]]
        b = self.vertices[faces[:, 1]]
        c = self.vertices[faces[:, 2]]
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        self.area_presum = np.cumsum(area).astype(np.float32)
        self._on: Dict[torch.device, tuple] = {}

        lo, hi = self.vertices.min(0), self.vertices.max(0)
        print(f"Bounding box: [{lo[0]}, {hi[0]}] x [{lo[1]}, {hi[1]}] x "
              f"[{lo[2]}, {hi[2]}]")
        print(f"Center: ({(lo[0]+hi[0])*.5}, {(lo[1]+hi[1])*.5}, "
              f"{(lo[2]+hi[2])*.5})")

    def _tensors(self, device: torch.device):
        """(vertices, normals | None, faces, facenormals, presum) on
        ``device``, copied there once."""
        if device not in self._on:
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            self._on[device] = (
                t(self.vertices),
                t(self.normals) if len(self.normals) else None,
                t(self.faces).long(), t(self.facenormals).long(),
                t(self.area_presum))
        return self._on[device]

    def save_obj(self, obj_file: str):
        with open(obj_file, "w") as fd:
            for v in self.vertices:
                fd.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for n in self.normals:
                fd.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            for f, fn in zip(self.faces, self.facenormals):
                fd.write(f"f {f[0]+1}//{fn[0]+1} {f[1]+1}//{fn[1]+1} "
                         f"{f[2]+1}//{fn[2]+1}\n")

    def sample_with(self, r1: torch.Tensor, r2: torch.Tensor,
                    r3: torch.Tensor):
        """(points (n, 3), unit normals (n, 3)) from three (n,) uniforms in
        [0, 1): ``r1`` picks the face by area, ``r2`` and ``r3`` the
        barycentric point (reference 3D/mesh_sampler.py:71-94)."""
        verts, nrms, faces, fnrms, presum = self._tensors(r1.device)
        fid = torch.searchsorted(presum, r1 * presum[-1]) \
            .clamp(0, faces.shape[0] - 1)
        u = 1.0 - torch.sqrt(r2)
        v = r3 * (1.0 - u)
        w = 1.0 - u - v
        tri = faces[fid]
        a, b, c = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
        p = u[:, None] * a + v[:, None] * b + w[:, None] * c
        if nrms is not None:
            trin = fnrms[fid]
            nrm = (u[:, None] * nrms[trin[:, 0]]
                   + v[:, None] * nrms[trin[:, 1]]
                   + w[:, None] * nrms[trin[:, 2]])
        else:
            nrm = torch.linalg.cross(b - a, c - a, dim=-1)
        return p, nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)

    def sample(self, gen: torch.Generator, n: int):
        """``sample_with`` on three (n,) uniforms drawn from ``gen``."""
        r1, r2, r3 = torch.rand((3, n), generator=gen, device=gen.device)
        return self.sample_with(r1, r2, r3)


def generate_trefoil_tube(extent: float = 0.6,
                          center=(0.0, 0.95, 0.0),
                          tube_ratio: float = 0.30,
                          n_u: int = 240, n_v: int = 20):
    """A procedural stand-in for the reference scene's obstacle
    (``bunny.obj``, which the repository does not carry; the committed
    ``assets/bunny_substitute.obj`` is this mesh): a trefoil-knot tube
    sized to the bunny's pre-transform bounding sphere, so that the scene's
    transform puts it in the same region of the domain. Non-convex (three
    interleaved lobes), so the interpolated normals, the area-weighted face
    sampling and the obstacle flux probe meet concave faces. Normals are
    the tube's radial directions; the frames are rotation-minimizing, with
    the closure holonomy spread as a linear twist so the mesh closes.
    Returns (vertices, normals, faces)."""
    t = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    # (2,3) trefoil curve and its analytic tangent
    c = np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t),
                  np.cos(t) - 2.0 * np.cos(2.0 * t),
                  -np.sin(3.0 * t)], axis=-1)
    dc = np.stack([np.cos(t) + 4.0 * np.cos(2.0 * t),
                   -np.sin(t) + 4.0 * np.sin(2.0 * t),
                   -3.0 * np.cos(3.0 * t)], axis=-1)
    tan = dc / np.linalg.norm(dc, axis=-1, keepdims=True)
    # rotation-minimizing frame by projection transport
    n0 = np.asarray([0.0, 0.0, 1.0])
    n0 = n0 - np.dot(n0, tan[0]) * tan[0]
    frames_n = [n0 / np.linalg.norm(n0)]
    for i in range(1, n_u):
        n_prev = frames_n[-1]
        n_i = n_prev - np.dot(n_prev, tan[i]) * tan[i]
        frames_n.append(n_i / np.linalg.norm(n_i))
    nrm = np.asarray(frames_n)
    binrm = np.cross(tan, nrm)
    # closure holonomy: transporting once around leaves the frame rotated
    # by phi relative to the start; unwind it linearly so ring n_u-1
    # connects smoothly back to ring 0
    n_end = nrm[-1] - np.dot(nrm[-1], tan[0]) * tan[0]
    n_end /= np.linalg.norm(n_end)
    phi = np.arctan2(np.dot(np.cross(nrm[0], n_end), tan[0]),
                     np.dot(nrm[0], n_end))
    theta_corr = -phi * np.arange(n_u) / n_u
    cc, ss = np.cos(theta_corr)[:, None], np.sin(theta_corr)[:, None]
    nrm, binrm = cc * nrm + ss * binrm, -ss * nrm + cc * binrm

    r_curve = np.linalg.norm(c, axis=-1).max()
    tube_r = tube_ratio * extent
    scale = (extent - tube_r) / r_curve
    theta = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    radial = (np.cos(theta)[None, :, None] * nrm[:, None, :]
              + np.sin(theta)[None, :, None] * binrm[:, None, :])
    verts = (scale * c[:, None, :] + tube_r * radial
             + np.asarray(center)).reshape(-1, 3)
    normals = radial.reshape(-1, 3)

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    faces = []
    for i in range(n_u):
        for j in range(n_v):
            a, b = vid(i, j), vid(i + 1, j)
            cq, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces += [(a, cq, b), (a, d, cq)]
    return (verts.astype(np.float32), normals.astype(np.float32),
            np.asarray(faces, np.int32))


def write_obj(path, vertices, normals, faces):
    """An OBJ of vertices, vertex normals and faces (each vertex its own
    normal)."""
    with open(path, "w") as fd:
        for v in vertices:
            fd.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for n in normals:
            fd.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for f in faces:
            fd.write(f"f {f[0]+1}//{f[0]+1} {f[1]+1}//{f[1]+1} "
                     f"{f[2]+1}//{f[2]+1}\n")


def write_centers_obj(mix, path: str) -> None:
    """The alive Gaussian centres as OBJ ``v`` lines (the reference's
    point-cloud dump, 3D/GSR.py:743-748); a 2D mixture gets z = 0."""
    pos = mix.positions[mix.alive].detach().cpu().numpy()
    if pos.shape[1] == 2:
        pos = np.concatenate([pos, np.zeros((len(pos), 1), pos.dtype)], 1)
    with open(path, "w") as fd:
        for p in pos:
            fd.write(f"v {p[0]} {p[1]} {p[2]}\n")
