"""A seeded random Karman state for the CPU tests: Gaussians spread over the
scene's scaled initialize domain, their shapes jittered and their values
a uniform inflow with noise, sorted as the frame loop keeps them; and
that state written as a frame's checkpoint."""

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.io import checkpoint
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.scenes import get_scene_2d


def karman_state(n: int = 1024, seed: int = 0):
    """(mixture, spec) on the CPU: ``n`` Gaussians."""
    scene = get_scene_2d("karman")
    sf = scene.scaling_factor
    x0, x1, y0, y1 = scene.initialize_domain
    lo = torch.tensor((x0 * sf, y0 * sf))
    hi = torch.tensor((x1 * sf, y1 * sf))
    spec = FieldSpec.create(tuple(lo.tolist()), tuple(hi.tolist()), n, d=2,
                            vdim=2)
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 2), generator=g) * (hi - lo) + lo
    mix = GaussianMixture.create(pos, spec, device="cpu")
    live = mix.alive
    jitter = {
        "scalings": 0.2 * torch.randn(mix.scalings.shape, generator=g),
        "rotations": 3.0 * torch.rand(mix.rotations.shape, generator=g),
        "values": torch.randn(mix.values.shape, generator=g)
        + torch.tensor([scene.info["v_magnitude"] * sf, 0.0])}
    p = mix.params()
    p = {k: torch.where(live.reshape((-1,) + (1,) * (v.dim() - 1)),
                        v + jitter[k], v) if k in jitter else v
         for k, v in p.items()}
    return mix.with_params(p).spatially_sorted(), spec


def karman_frame(path, n: int = 1024, seed: int = 0):
    """``karman_state`` written as a checkpoint at ``path``."""
    mix, spec = karman_state(n, seed)
    checkpoint.save_checkpoint(str(path), mix, spec)
    return path
