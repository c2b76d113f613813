"""3D scene registry (vortex rings, the obstacle scene) — see
fields3d.py."""

from __future__ import annotations

SCENES_3D = ("leapfrog", "single_vortex_ring", "ring_collide",
             "ring_with_obstacle")


def get_scene_3d(name: str):
    from gaussian_fluids_torch.scenes import fields3d
    return fields3d.build_scene(name)
