"""3D scene registry (vortex rings) — see fields3d.py. ``ring_with_obstacle``
waits for the obstacle mesh sampler and is refused with a clear error."""

from __future__ import annotations

SCENES_3D = ("leapfrog", "single_vortex_ring", "ring_collide")


def get_scene_3d(name: str):
    from gaussian_fluids_torch.scenes import fields3d
    return fields3d.build_scene(name)
