"""Four independent Adam groups, each with a reduce-on-plateau schedule,
held entirely in tensors so the host never reads them during training.

Semantics of torch's defaults: Adam(betas=(0.9, 0.999), eps=1e-8);
plateau mode='min', threshold=1e-4 (relative), cooldown=0: improvement iff
metric < best * (1 - 1e-4); after more than ``patience`` non-improving
steps the lr is multiplied by 0.9 and the counter resets. The plateau
test runs on the device, so no epoch synchronises with the host (torch's
own ``ReduceLROnPlateau`` takes a Python float and would).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
PLATEAU_THRESHOLD = 1e-4
PLATEAU_FACTOR = 0.9


class GroupState(NamedTuple):
    lr: torch.Tensor        # () f32
    step: torch.Tensor      # () f32 — Adam timestep
    m: torch.Tensor
    v: torch.Tensor
    best: torch.Tensor      # () f32 — plateau best metric
    num_bad: torch.Tensor   # () i32


class OptState(NamedTuple):
    groups: Dict[str, GroupState]
    patience: int


def init(params: Params, lrs: Dict[str, float],
         patience: int = 50) -> OptState:
    groups = {}
    for k, p in params.items():
        dev = p.device
        groups[k] = GroupState(
            lr=torch.tensor(lrs[k], dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.float32, device=dev),
            m=torch.zeros_like(p), v=torch.zeros_like(p),
            best=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
            num_bad=torch.zeros((), dtype=torch.int32, device=dev))
    return OptState(groups=groups, patience=int(patience))


def _adam_group(g: GroupState, p, grad):
    t = g.step + 1.0
    m = BETA1 * g.m + (1.0 - BETA1) * grad
    v = BETA2 * g.v + (1.0 - BETA2) * grad * grad
    mhat = m / (1.0 - BETA1 ** t)
    vhat = v / (1.0 - BETA2 ** t)
    p_new = p - g.lr * mhat / (torch.sqrt(vhat) + EPS)
    return p_new, g._replace(step=t, m=m, v=v)


def _plateau_group(g: GroupState, metric, patience: int) -> GroupState:
    improved = metric < g.best * (1.0 - PLATEAU_THRESHOLD)
    best = torch.where(improved, metric, g.best)
    num_bad = torch.where(improved, torch.zeros_like(g.num_bad),
                          g.num_bad + 1)
    reduce = num_bad > patience
    lr = torch.where(reduce, g.lr * PLATEAU_FACTOR, g.lr)
    num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)
    return g._replace(lr=lr, best=best, num_bad=num_bad)


@torch.no_grad()
def step(state: OptState, params: Params, grads: Params, metric):
    """One ``optimizer.step() + scheduler.step(metric)`` over all groups;
    returns new tensors (the inputs are not modified)."""
    metric = metric.detach().to(torch.float32)
    new_params, new_groups = {}, {}
    for k in params:
        p_new, g_new = _adam_group(state.groups[k], params[k], grads[k])
        new_groups[k] = _plateau_group(g_new, metric, state.patience)
        new_params[k] = p_new
    return new_params, OptState(groups=new_groups, patience=state.patience)


def get_lrs(state: OptState) -> Dict[str, torch.Tensor]:
    return {k: g.lr for k, g in state.groups.items()}
