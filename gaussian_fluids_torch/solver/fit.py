"""Initial fitting: fit the Gaussian field to an analytic velocity field.

Per epoch, as in the JAX package's ``solver/fit.py``: a fresh uniform batch
in the (scaled) fit domain; L1 value + L1 Jacobian against the analytic
references plus the anisotropy and volume regularizers; one Adam step per
parameter group with the plateau schedules stepped on the total. Fit has
no early stop; the host reads the losses only every ``log_every`` epochs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from gaussian_fluids_torch.config import FieldSpec
from gaussian_fluids_torch.models.mixture import GaussianMixture, mixture_of
from gaussian_fluids_torch.ops import field
from gaussian_fluids_torch.solver import losses, optim
from gaussian_fluids_torch.utils import profiling

FIT_LRS_2D = {"positions": 1.6e-3, "scalings": 5e-2, "rotations": 5e-2,
              "values": 5e-3}


def uniform_batch(gen: torch.Generator, n: int, lo, hi) -> torch.Tensor:
    """(n, d) points uniform in the box [lo, hi] (tensors on gen's device)."""
    u = torch.rand((n, lo.shape[0]), generator=gen, device=lo.device)
    return u * (hi - lo) + lo


def grads_of(loss_fn, params, *args):
    """(loss, aux, grads): ``loss_fn(params, *args) -> (total, aux)``
    differentiated with respect to every parameter group."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        total, aux = loss_fn(leaves, *args)
        g = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return total.detach(), aux.detach(), dict(zip(leaves, g))


def make_fit_epoch(spec: FieldSpec, ref_val_fn: Callable,
                   ref_jac_fn: Callable):
    """One fit epoch ``epoch(carry, x) -> (carry, aux)`` on the sample batch
    ``x``; carry = (params, opt_state, alive)."""

    def loss_fn(params, alive, x, ref_val, ref_jac):
        val, jac = field.value_and_jac(mixture_of(params, alive), spec, x,
                                       presorted=True, need_dx=False)
        l_val = losses.value_loss(val, ref_val)
        l_grad = losses.grad_loss(jac, ref_jac)
        l_aniso = losses.aniso_loss(params["scalings"], alive)
        l_vol = losses.volume_loss(params["scalings"], alive)
        total = l_val + l_grad + l_aniso + l_vol
        div = losses.divergence(jac)
        aux = torch.stack([l_val, l_grad, l_aniso, l_vol, (div ** 2).mean()])
        return total, aux

    def epoch(carry, x):
        params, opt_state, alive = carry
        if field._use_kernel(x):
            x = x[torch.argsort(x[:, 0])]   # sort once; evals run presorted
        with torch.no_grad():
            ref_val, ref_jac = ref_val_fn(x), ref_jac_fn(x)
        total, aux, grads = grads_of(loss_fn, params, alive, x, ref_val,
                                     ref_jac)
        params, opt_state = optim.step(opt_state, params, grads, total)
        return (params, opt_state, alive), aux

    return epoch


def fit_velocity_with_gradient(mix: GaussianMixture, spec: FieldSpec,
                               ref_val_fn, ref_jac_fn, lo, hi,
                               lrs: Dict[str, float], batch_size: int,
                               max_epoch: int, gen: torch.Generator,
                               patience: int = 50, log_every: int = 100,
                               verbose: int = 1) -> GaussianMixture:
    epoch = make_fit_epoch(spec, ref_val_fn, ref_jac_fn)
    lo = torch.tensor(lo, dtype=torch.float32, device=mix.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=mix.device)
    params = mix.params()
    carry = (params, optim.init(params, lrs, patience=patience), mix.alive)
    st = time.time()
    for done in range(1, max_epoch + 1):
        carry, aux = epoch(carry, uniform_batch(gen, batch_size, lo, hi))
        if verbose and (done % log_every == 0 or done == max_epoch):
            a = aux.tolist()
            print(f"loss: {a[0]:.6f}, loss_grad: {a[1]:.6f}, "
                  f"loss_aniso: {a[2]:.6f}, loss_vol: {a[3]:.6f}, "
                  f"divergence constraint: {a[4]:.6f}")
            print("time:", time.time() - st)
            st = time.time()
        if done % log_every == 0:
            profiling.poll()
    return mix.with_params(carry[0])
