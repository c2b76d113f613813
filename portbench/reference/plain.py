"""The Gaussian field in plain PyTorch.

    g_i(x) = exp(-1/2 (x - mu_i)^T P_i (x - mu_i)),
    P_i    = R_i diag(exp(2 s_i)) R_i^T,
    u(x)   = sum_i 1[g_i >= c] 1[mu_i in the padded domain] v_i (g_i - c),
    du/dx  = sum_i 1[...] v_i (-g_i) (P_i (x - mu_i))^T,

every (query, Gaussian) pair evaluated, in blocks of query rows. The
pair arithmetic runs in ``pair_dtype`` (float32; bfloat16 for the
control), the differences x - mu and the sums over Gaussians in float32.
Differentiable with respect to the parameters.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

PAIRS_PER_BLOCK = 1 << 24


class Mixture(NamedTuple):
    positions: torch.Tensor   # (N, d)
    scalings: torch.Tensor    # (N, d) log inverse scales
    rotations: torch.Tensor   # (N,) angles in 2D, (N, 4) quaternions in 3D
    values: torch.Tensor      # (N, vdim)


class Spec(NamedTuple):
    clamp: float
    lo: tuple                 # padded domain
    hi: tuple


def load_checkpoint(path: str, device) -> tuple:
    """(Mixture, Spec) of a ``gaussian_velocity_{n}.pt`` in the
    reference's format (the alive rows, their clamp and padded domain)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    mix = Mixture(*(torch.as_tensor(data[k], dtype=torch.float32)
                    .to(device) for k in Mixture._fields))
    dr = [float(v) for v in data["domain_range"]]
    d = mix.positions.shape[1]
    spec = Spec(float(data["clamp_threshold"]),
                tuple(dr[2 * i] for i in range(d)),
                tuple(dr[2 * i + 1] for i in range(d)))
    return mix, spec


def packed_precisions(scalings, rotations, d: int) -> torch.Tensor:
    """(N, d(d+1)/2) entries of P: the diagonal, then P_ij for i < j."""
    e = torch.exp(2.0 * scalings)
    if d == 2:
        c, s = torch.cos(rotations), torch.sin(rotations)
        a, b = e[:, 0], e[:, 1]
        return torch.stack([c * c * a + s * s * b, s * s * a + c * c * b,
                            c * s * (a - b)], -1)
    q = rotations / torch.linalg.vector_norm(rotations, dim=-1,
                                             keepdim=True)
    r, x, y, z = q.unbind(-1)
    rows = ((1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
             2 * (x * z + r * y)),
            (2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - r * x)),
            (2 * (x * z - r * y), 2 * (y * z + r * x),
             1 - 2 * (x * x + y * y)))

    def pij(i, j):
        return sum(rows[i][k] * rows[j][k] * e[:, k] for k in range(3))

    return torch.stack([pij(0, 0), pij(1, 1), pij(2, 2), pij(0, 1),
                        pij(0, 2), pij(1, 2)], -1)


def _off(d):
    return [(i, j) for i in range(d) for j in range(i + 1, d)]


def _pairs(m: Mixture, spec: Spec, x: torch.Tensor, pair_dtype):
    """Per pair of the block: (w = 1[support] (g - c), wg = 1[support] g,
    P delta (3 tensors (R, N))), in ``pair_dtype``."""
    d = x.shape[1]
    pk = packed_precisions(m.scalings, m.rotations, d).to(pair_dtype)
    delta = [(x[:, None, k] - m.positions[None, :, k]).to(pair_dtype)
             for k in range(d)]
    pd = []
    for k in range(d):
        acc = pk[:, k] * delta[k]
        for c, (i, j) in enumerate(_off(d)):
            if k == i:
                acc = acc + pk[:, d + c] * delta[j]
            elif k == j:
                acc = acc + pk[:, d + c] * delta[i]
        pd.append(acc)
    quad = sum(delta[k] * pd[k] for k in range(d))
    g = torch.exp(-0.5 * quad)
    with torch.no_grad():
        inside = torch.ones_like(m.positions[:, 0], dtype=torch.bool)
        for k in range(d):
            inside &= (m.positions[:, k] >= spec.lo[k]) \
                & (m.positions[:, k] <= spec.hi[k])
        live = (g >= spec.clamp) & inside[None, :]
    zero = torch.zeros((), dtype=pair_dtype, device=x.device)
    w = torch.where(live, g - spec.clamp, zero)
    wg = torch.where(live, g, zero)
    return w, wg, pd


def evaluate(m: Mixture, spec: Spec, x: torch.Tensor, jac: bool = True,
             pair_dtype=torch.float32):
    """(val (R, vdim), jac (R, vdim, d) or None) at the block ``x``."""
    w, wg, pd = _pairs(m, spec, x, pair_dtype)
    v = m.values
    val = w.float() @ v
    if not jac:
        return val, None
    cols = [-((wg * pd[k]).float() @ v) for k in range(x.shape[1])]
    return val, torch.stack(cols, -1)


def block_rows(n: int) -> int:
    return max(1, PAIRS_PER_BLOCK // max(n, 1))


@torch.no_grad()
def evaluate_blocks(m: Mixture, spec: Spec, x: torch.Tensor,
                    jac: bool = True, pair_dtype=torch.float32):
    """``evaluate`` over many points, block by block, no gradients."""
    rows = block_rows(m.positions.shape[0])
    parts = [evaluate(m, spec, x[i:i + rows], jac, pair_dtype)
             for i in range(0, x.shape[0], rows)]
    val = torch.cat([p[0] for p in parts])
    return val, (torch.cat([p[1] for p in parts]) if jac else None)


def head_grads(params: Dict[str, torch.Tensor], spec: Spec, x, heads,
               jac: bool = True, pair_dtype=torch.float32):
    """The losses and the gradients of several heads that are sums over
    the query rows: ``heads`` are ``f(val, jac, rows) -> partial sum``
    for the rows ``rows`` (a slice of x), already divided by the batch's
    mean. Returns (losses [float tensors], grads [dict per head])."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    grads = [{k: torch.zeros_like(p) for k, p in params.items()}
             for _ in heads]
    totals = [torch.zeros((), device=x.device) for _ in heads]
    m = Mixture(leaves["positions"], leaves["scalings"], leaves["rotations"],
                leaves["values"])
    rows = block_rows(m.positions.shape[0])
    keys = list(leaves)
    for i in range(0, x.shape[0], rows):
        sl = slice(i, min(i + rows, x.shape[0]))
        with torch.enable_grad():
            val, jc = evaluate(m, spec, x[sl], jac, pair_dtype)
            parts = [h(val, jc, sl) for h in heads]
            for h, part in enumerate(parts):
                g = torch.autograd.grad(part, [leaves[k] for k in keys],
                                        retain_graph=h + 1 < len(parts),
                                        allow_unused=True)
                for k, gk in zip(keys, g):
                    if gk is not None:
                        grads[h][k] += gk
                totals[h] += part.detach()
    return totals, grads


@torch.no_grad()
def support_pairs(m: Mixture, spec: Spec, x: torch.Tensor) -> int:
    """How many (query, live Gaussian) pairs of ``x`` have g >= c."""
    rows = block_rows(m.positions.shape[0])
    hits = 0
    for i in range(0, x.shape[0], rows):
        w, wg, _ = _pairs(m, spec, x[i:i + rows], torch.float32)
        hits += int((wg > 0).sum())
    return hits
