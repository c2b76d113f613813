"""The numbers that decide ``correct``.

Training (the projection cells): each of the first steps' losses, the
first step's gradient as the optimizer gets it and the parameters'
change after the last step, the last two by the worst parameter group
(leaf): the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is
larger. A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of the change.

The replay: the largest gap between the program's advected density and
the reference's at the sampled nodes of every step.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

ROUNDOFF_LEAF = 1e-3


def step_norms(losses: List[float], grads: Dict[str, torch.Tensor],
               delta: Dict[str, torch.Tensor]) -> dict:
    """What the comparison reads of a run's first steps, as host floats."""
    def norms(t):
        return {k: float(torch.linalg.vector_norm(v.double()))
                for k, v in t.items()}
    return {"losses": [float(v) for v in losses], "grad": norms(grads),
            "delta": norms(delta)}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    med = statistics.median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def training_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The worst leaf's gaps (``grad_gap``, ``step_gap``) and the median
    leaf's (``grad_med_gap``, ``step_med_gap``); the worst step's loss
    gap (``loss_gap``) and the first step's (``loss1_gap``)."""
    med = statistics.median(ref["grad"].values())
    moving = [k for k in ref["delta"]
              if ref["grad"][k] >= ROUNDOFF_LEAF * med]
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses = [float("inf")]
    grad = _leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    step = _leaf_gaps(prog["delta"], ref["delta"], moving) or [0.0]
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": max(grad), "grad_med_gap": statistics.median(grad),
            "step_gap": max(step), "step_med_gap": statistics.median(step)}


def density_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |program - reference| at the sampled nodes."""
    return float((prog.double() - ref.double()).abs().max())
