"""2D scene registry: domains, particle counts, physics constants, fields
and boundary samplers. The data are the JAX package's, all eight scenes
(reference 2D/init_cond.py): ``taylor_green``, ``taylor_vortex``,
``leapfrog``, the four ``vortices_pass`` obstacle scenes, and ``karman``,
whose advance domain grows with the inflow every frame
(``Scene2D.extra_advect``, ``advance_domain_at``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from gaussian_fluids_torch.scenes import boundaries2d, fields2d

PI = math.pi

_INITIALIZE_DOMAIN = {
    "taylor_green": (0.0, 2.0 * PI, 0.0, 2.0 * PI),
    "taylor_vortex": (-5.0, 5.0, -5.0, 5.0),
    "leapfrog": (-5.0, 5.0, -5.0, 5.0),
    "vortices_pass": (0.0, 1.0, 0.0, 1.0),
    "vortices_pass_narrow": (0.0, 1.0, 0.0, 1.0),
    "vortices_pass_noslip": (0.0, 1.0, 0.0, 1.0),
    "vortices_pass_particles": (-5.0, 5.0, -5.0, 5.0),
    "karman": (-6.10321, 1.906778, -0.598466, 0.60349),
}
_VISUALIZE_DOMAIN = dict(_INITIALIZE_DOMAIN)
_VISUALIZE_DOMAIN["vortices_pass_particles"] = (-2.5, 2.5, -2.5, 2.5)
_VISUALIZE_DOMAIN["karman"] = (-1.10321, 1.906778, -0.598466, 0.60349)
_PARTICLE_COUNT = {name: (71, 71) for name in _INITIALIZE_DOMAIN}
_PARTICLE_COUNT.update(taylor_green=(24, 24), karman=(400, 60))
_VISUALIZE_RES = {name: (200, 200) for name in _INITIALIZE_DOMAIN}
_VISUALIZE_RES["karman"] = (501, 200)
_VORTEX_PAIR = {"U": 5e-3, "a": 3e-2,
                "vortex_pos1": (0.1, 0.525), "vortex_pos2": (0.1, 0.475),
                "obstacle_radius": 60.0 / 511.0}
_OTHER_INFO = {
    "taylor_green": {},
    "taylor_vortex": {
        "U": 3.0, "a": 0.5,
        "vortex_pos1": (-0.8, 0.0), "vortex_pos2": (0.8, 0.0),
    },
    "leapfrog": {
        "U": 0.5, "a": 0.3,
        "vortex_pos1": (-3.0, -3.0), "vortex_pos2": (-1.0, -3.0),
        "vortex_pos3": (1.0, -3.0), "vortex_pos4": (3.0, -3.0),
    },
    "vortices_pass": {**_VORTEX_PAIR, "obstacle_pos1": (0.5, 0.27),
                      "obstacle_pos2": (0.5, 0.73)},
    "vortices_pass_narrow": {**_VORTEX_PAIR, "obstacle_pos1": (0.5, 0.285),
                             "obstacle_pos2": (0.5, 0.715)},
    "vortices_pass_noslip": {**_VORTEX_PAIR, "obstacle_pos1": (0.5, 0.27),
                             "obstacle_pos2": (0.5, 0.73)},
    "vortices_pass_particles": {
        "obstacle_pos1": (0.0, 1.0), "obstacle_pos2": (0.0, -1.0),
        "obstacle_radius": 0.25,
    },
    "karman": {
        "v_magnitude": 0.5,
        "obstacle_pos": (-0.80356845, -0.00502235),
        "obstacle_radius": 0.04553178393357534,
        "d0": PI / 15.0,
    },
}


def _scaling_factor(domain) -> float:
    """10 / min(initialize-domain extent): solving happens in this
    target space."""
    x0, x1, y0, y1 = domain
    return 10.0 / min(x1 - x0, y1 - y0)


@dataclasses.dataclass
class Scene2D:
    name: str
    initialize_domain: Tuple[float, float, float, float]
    advance_domain: Tuple[float, float, float, float]  # initial value
    visualize_domain: Tuple[float, float, float, float]
    particle_count: Tuple[int, int]
    visualize_res: Tuple[int, int]
    info: Dict
    velocity: Callable       # original space (B,2) -> (B,2)
    velocity_jac: Callable   # original space (B,2) -> (B,2,2)
    boundary_sampler_1: Optional[Callable]
    boundary_sampler_2: Optional[Callable]

    @property
    def scaling_factor(self) -> float:
        return _scaling_factor(self.initialize_domain)

    def target_velocity(self, x):
        return self.scaling_factor * self.velocity(x / self.scaling_factor)

    def target_velocity_jac(self, x):
        return self.velocity_jac(x / self.scaling_factor)

    def extra_advect(self, adv_domain, dt):
        """The advance domain after one more frame: Karman's grows with the
        inflow up to the visualize domain (reference
        2D/init_cond.py:267-271); the others keep theirs."""
        if self.name != "karman":
            return adv_domain
        x0 = min(adv_domain[0] + dt * self.info["v_magnitude"],
                 self.visualize_domain[0])
        return (x0,) + tuple(adv_domain[1:])

    def advance_domain_at(self, start_frame: int, dt: float):
        """The advance domain at ``start_frame``, for a resume (reference
        ``karman_extra_loader``, 2D/init_cond.py:284-298)."""
        if self.name != "karman":
            return self.advance_domain
        x0 = min(self.initialize_domain[0]
                 + start_frame * dt * self.info["v_magnitude"],
                 self.visualize_domain[0])
        return (x0,) + tuple(self.advance_domain[1:])


def get_scene_2d(name: str) -> Scene2D:
    if name not in _INITIALIZE_DOMAIN:
        raise KeyError(f"unknown 2D scene {name!r}; "
                       f"valid: {sorted(_INITIALIZE_DOMAIN)}")
    info = dict(_OTHER_INFO[name])
    if name == "karman":
        info["visualize_x_min"] = _VISUALIZE_DOMAIN["karman"][0]
    vel, jac = fields2d.make_field(name, info)
    sf = _scaling_factor(_INITIALIZE_DOMAIN[name])
    s1, s2 = boundaries2d.make_samplers(name, info, sf)
    dom = _INITIALIZE_DOMAIN[name]
    return Scene2D(name=name, initialize_domain=dom, advance_domain=dom,
                   visualize_domain=_VISUALIZE_DOMAIN[name],
                   particle_count=_PARTICLE_COUNT[name],
                   visualize_res=_VISUALIZE_RES[name], info=info,
                   velocity=vel, velocity_jac=jac,
                   boundary_sampler_1=s1, boundary_sampler_2=s2)


SCENES_2D = tuple(sorted(_INITIALIZE_DOMAIN))
