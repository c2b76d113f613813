"""Scene registry (2D)."""

from gaussian_fluids_torch.scenes.registry2d import SCENES_2D, get_scene_2d  # noqa: F401
