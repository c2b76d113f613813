"""Scene registries (2D and 3D)."""

from gaussian_fluids_torch.scenes.registry2d import SCENES_2D, get_scene_2d  # noqa: F401
from gaussian_fluids_torch.scenes.registry3d import SCENES_3D, get_scene_3d  # noqa: F401
