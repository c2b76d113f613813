"""3D boundary samplers — the port of the JAX package's
``scenes/boundaries3d.py`` (reference 3D/init_cond.py:223-265):
area-weighted points on the six faces of the domain box with inward
normals, and for an obstacle scene the box and the obstacle mesh together.
The random draws come from the caller's ``torch.Generator``; the
arithmetic (``sample_on_box``, ``sample_box_and_mesh``) takes them as
arguments, so tests can feed the JAX package's draws."""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussian_fluids_torch.scenes import mesh as mesh_mod

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "assets")
SUBSTITUTE_OBJ = "bunny_substitute.obj"


def sample_on_box(t, u, v, domain):
    """Points on the box faces and their inward normals from three (n,)
    uniforms in [0, 1): ``t`` picks the face by area, ``u`` and ``v``
    place the point on it."""
    x_min, x_max, y_min, y_max, z_min, z_max = domain
    xs, ys, zs = x_max - x_min, y_max - y_min, z_max - z_min
    areas = torch.tensor([ys * zs, ys * zs, zs * xs, zs * xs, xs * ys,
                          xs * ys], dtype=torch.float32, device=t.device)
    face = torch.searchsorted(torch.cumsum(areas, 0), t * areas.sum())
    # faces 0,1: y from u, z from v; faces 2,3: x from u, z from v;
    # faces 4,5: x from u, y from v
    ux = u * xs + x_min
    uy = u * ys + y_min
    vy = v * ys + y_min
    vz = v * zs + z_min
    full = lambda c: torch.full_like(t, c)   # noqa: E731
    px = torch.where(face == 0, full(x_min),
                     torch.where(face == 1, full(x_max), ux))
    py = torch.where(face <= 1, uy,
                     torch.where(face == 2, full(y_min),
                                 torch.where(face == 3, full(y_max), vy)))
    pz = torch.where(face <= 3, vz,
                     torch.where(face == 4, full(z_min), full(z_max)))
    normals = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                           device=t.device)
    return torch.stack([px, py, pz], -1), normals[face]


def load_obstacle_mesh(info) -> mesh_mod.MeshSampler:
    """The scene's obstacle: ``info["obj_file"]`` from ``assets/`` when the
    repository has it, else the committed trefoil-tube substitute
    (``assets/bunny_substitute.obj``); where that file is absent too, the
    same trefoil generated in memory (nothing is written into
    ``assets/``). Scaled and translated by the scene's ``info``."""
    rotate = np.eye(3, dtype=np.float32)
    for name in (info["obj_file"], SUBSTITUTE_OBJ):
        path = os.path.join(ASSET_DIR, name)
        if os.path.exists(path):
            return mesh_mod.MeshSampler(path, info["scale"], rotate,
                                        info["translate"])
    v, nrm, f = mesh_mod.generate_trefoil_tube()
    print(f"[scenes3d] assets/{info['obj_file']} and {SUBSTITUTE_OBJ} "
          f"missing; generated the trefoil-tube substitute in memory")
    return mesh_mod.MeshSampler.from_arrays(v, nrm, f, f, info["scale"],
                                            rotate, info["translate"])


def sample_box_and_mesh(box_u, mesh_u, domain, mesh):
    """2n points and normals: n on the box faces from the (3, n) uniforms
    ``box_u`` (``sample_on_box``), then n on the obstacle from the (3, n)
    uniforms ``mesh_u`` (``MeshSampler.sample_with``), as the reference
    concatenates them (3D/init_cond.py:255-258)."""
    d1, n1 = sample_on_box(*box_u, domain)
    d2, n2 = mesh.sample_with(*mesh_u)
    return torch.cat([d1, d2]), torch.cat([n1, n2])


def make_sampler(domain, mesh=None):
    """(gen, n) -> (points, normals): n on the box faces, or with an
    obstacle ``mesh`` 2n, box then mesh (``sample_box_and_mesh``)."""
    def box_sampler(gen, n):
        t, u, v = torch.rand((3, n), generator=gen, device=gen.device)
        return sample_on_box(t, u, v, domain)

    if mesh is None:
        return box_sampler

    def combined(gen, n):
        r = torch.rand((6, n), generator=gen, device=gen.device)
        return sample_box_and_mesh(r[:3], r[3:], domain, mesh)

    return combined
