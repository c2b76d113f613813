"""Gaussian-importance collocation samplers, as the JAX package's
``solver/sampling.py``: training points drawn from the mixture's own
Gaussians instead of uniformly over the domain. ``generate_gaussians``
picks n Gaussians at random and samples each pick's own distribution,
``generate_all_gaussians`` draws one sample per Gaussian; both clamp to
the advance domain. Neither package's solver calls them.

A sample is mu + R diag(e^{-s}) z with z ~ N(0, I): with the precision
P = R diag(e^{2s}) R^T the covariance is R diag(e^{-2s}) R^T, so this is
its closed-form square root, no Cholesky factorisation.

Draws come from an explicit ``torch.Generator``; ``pick`` and ``z`` (and
``fill``, the uniform points that stand in for dead rows) may be passed
instead, which is how the tests feed both packages the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture
from gaussian_fluids_torch.ops.rotations import rotation_matrix

__all__ = ["generate_gaussians", "generate_all_gaussians"]


def _domain_lo_hi(domain, d: int, device):
    dom = torch.as_tensor(domain, dtype=torch.float32, device=device)
    if dom.shape[0] != 2 * d:
        raise ValueError(f"domain needs {2 * d} bounds, got {dom.shape[0]}")
    return dom[0::2], dom[1::2]


def _sample_from(mix: GaussianMixture, d: int, pick: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    rot = rotation_matrix(mix.rotations[pick], d)
    half = rot * torch.exp(-mix.scalings[pick])[:, None, :]  # R diag(e^-s)
    return mix.positions[pick] + torch.einsum("nij,nj->ni", half, z)


def _uniform(gen, shape, lo, hi, fill):
    if fill is None:
        fill = torch.rand(shape, generator=gen, device=lo.device)
    return fill * (hi - lo) + lo


@torch.no_grad()
def generate_gaussians(gen: Optional[torch.Generator], mix: GaussianMixture,
                       spec: FieldSpec, domain, n: int,
                       restrict: Optional[torch.Tensor] = None,
                       pick: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n points from randomly picked (alive, ``restrict``-allowed)
    Gaussians' own distributions, clamped to ``domain`` = (x_min, x_max,
    y_min, y_max[, z_min, z_max]); d = 2 or 3. Where no Gaussian is
    allowed, uniform points of the domain (``fill`` in [0, 1)^d)."""
    d, dev = spec.d, mix.device
    lo, hi = _domain_lo_hi(domain, d, dev)
    ok = mix.alive if restrict is None else mix.alive & restrict
    if not bool(ok.any()):
        return _uniform(gen, (n, d), lo, hi, fill)
    if pick is None:
        pick = torch.multinomial(ok.float(), n, replacement=True,
                                 generator=gen)
    if z is None:
        z = torch.randn((n, d), generator=gen, device=dev)
    pick = torch.as_tensor(pick, device=dev).long()
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    return torch.minimum(torch.maximum(_sample_from(mix, d, pick, z), lo),
                         hi)


@torch.no_grad()
def generate_all_gaussians(gen: Optional[torch.Generator],
                           mix: GaussianMixture, spec: FieldSpec, domain,
                           z: Optional[torch.Tensor] = None,
                           fill: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One point per Gaussian, clamped to the domain; the rows of dead
    (padding) slots are uniform points of the domain, so every row is a
    valid collocation point at the mixture's capacity."""
    d, dev = spec.d, mix.device
    lo, hi = _domain_lo_hi(domain, d, dev)
    cap = mix.capacity
    if z is None:
        z = torch.randn((cap, d), generator=gen, device=dev)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    samp = torch.minimum(torch.maximum(
        _sample_from(mix, d, torch.arange(cap, device=dev), z), lo), hi)
    return torch.where(mix.alive[:, None], samp,
                       _uniform(gen, (cap, d), lo, hi, fill))
