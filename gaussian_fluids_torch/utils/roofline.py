"""The bound model of the port on one H100: peak rates, operation counts,
a kernel launch's least time, and the cost of a projection epoch, the
port of the JAX package's ``utils/roofline.py``.

Two kinds of operation counts live side by side here:

* **The math, per (query, Gaussian) pair**, under the JAX package's names
  and values (``tile_quantities_flops``, ``fwd_flops_per_pair``, ...,
  ``DUAL_FACTOR``): counted line by line from the centered kernels' pair
  arithmetic, each multiply, add, select and exp one operation. Both
  packages compute that arithmetic, so these counts describe the work,
  not one implementation of it. ``EpochCost`` and
  ``projection_epoch_cost_{2d,3d}`` build a projection epoch from them.
* **The port's kernels, per pair**, counted from ``csrc/gsr_tile.cuh``,
  ``csrc/gsr_banded.cu`` and ``csrc/rk4_fused.cu`` (an FMA counts 2, an
  exp and a compare 1 each): ``OPS_GEOMETRY``, ``OPS_SUPPORT``,
  ``OPS_BANDED_*``. Every pair a kernel walks pays the geometry; a pair
  inside the support (g >= c) pays the accumulation too. ``pair_ops`` and
  ``kernel_bound`` turn them into a launch's least time, which
  ``chip_smoke.py`` reports beside each kernel's measured time.

Bytes are counted on need: each launch reads its inputs once and writes
its outputs once. Pairs are what the caller passes: the pairs inside the
support (``measured_support_density``), the pairs of the live tiles
(``measured_tile_density``) or all of them.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit. The
kernels run f32 on the CUDA cores (no tensor cores, no TF32), so the f32
peak is the one their share is read against; TF32 and bf16 are listed for
a later kernel that uses the tensor cores. A card held below 700 W runs
slower than these.

``reference_gpu_bound_{2d,3d}`` and ``measured_pair_stats_3d`` are the JAX
package's modelled bounds of the *reference's* PyTorch + Taichi solver on
a GPU of the RTX 4090 or A100 class: models with their arithmetic written
out, not measurements of this card and not figures of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PEAKS = {
    "h100": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
             "hbm": 3.35e12},
}

# the kernel bounds' two rates: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = PEAKS["h100"]["f32"]
PEAK_BYTES_PER_S = PEAKS["h100"]["hbm"]

# ---- the port's kernels: operations per pair (csrc counts) ----

# Every pair of a live tile pays the centered geometry; pairs inside the
# support (g >= c) pay the accumulation too. d = vdim = 2 as counted for
# the first slice; d = vdim = 3 with njac = 3 and the value cotangents
# read (the 3D main path's variants: the projection's helicity head reads
# the value).
OPS_GEOMETRY = {2: 15, 3: 27}
OPS_SUPPORT = {(2, "fwd"): 17, (2, "bwd_dn"): 74, (2, "bwd_dn2"): 126,
               (3, "fwd"): 34, (3, "bwd_dn"): 136, (3, "bwd_dn2"): 272}
# The banded kernel (csrc/gsr_banded.cu, d = vdim = 3): a pair's geometry
# is dx (3), the direct quadratic form (6 terms of a multiply and an FMA:
# 18) and the cut compare (1); a pair inside the support also pays
# -quad/2, the exp and the support compare (3), then g - c and 3 FMAs (7).
OPS_BANDED_WINDOW, OPS_BANDED_SUPPORT = 22, 10
# dL/dx, per pair in the support with njac = d: the value and Jacobian
# cotangents against v (VDIM (1 + d) FMAs), gg (d FMAs), gquad and gpd
# (2 + d), dx_k (2 + 2 d each) and the sums. The triple backward's data
# tiles pay the dual backward's count, its boundary tiles the value-only
# backward's: s1 (2 VDIM), gquad (2), dv (1 + 2 VDIM), dmu (3 d), the
# precisions and the bias (3 d + 4 per off-diagonal + 1). The fused RK4
# kernel: every pair of every stage pays the geometry; in the support a
# stage pays g - c and VDIM FMAs (1 + 2 VDIM), the endpoint's Jacobian
# stage the forward's.
OPS_SUPPORT.update({(2, "bwd_dx"): 36, (3, "bwd_dx"): 65,
                    (2, "bwd_dn_val"): 28, (3, "bwd_dn_val"): 46,
                    (2, "rk4_stage"): 5, (3, "rk4_stage"): 7})


def pair_ops(geometry, support_ops, walked_pairs, support_pairs):
    """(ops the inputs need, ops of the pairs the kernel walks). Counted on
    need, only a pair inside the support (g >= c) does work: its geometry
    and its accumulation; a kernel pays at least the geometry of every
    pair it walks. Every row's bound is the first, so a kernel that culls
    better than its walk can never read faster than its bound."""
    return ((geometry + support_ops) * support_pairs,
            geometry * walked_pairs + support_ops * support_pairs)


def kernel_bound(ops, nbytes):
    """(ms, 'operations' | 'bytes'): the larger of ``ops`` over the f32
    peak and ``nbytes`` over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


# ---- the math: operations per pair under the JAX package's names ----

def _off(d):  # off-diagonal pair count of the packed precision
    return d * (d - 1) // 2


def tile_quantities_flops(d: int) -> int:
    """delta (d) + Pd (d (2d - 1)) + quad (2d) + exp (1) + clamp compare
    (1)."""
    return d + d * (2 * d - 1) + 2 * d + 2


def fwd_flops_per_pair(d: int, vdim: int, njac: int | None = None) -> int:
    """The forward per pair: the tile quantities + the masked selects (3) +
    the value contraction (2 vdim) + njac weighted contractions (2 + 2
    vdim each)."""
    njac = d if njac is None else njac
    return tile_quantities_flops(d) + 3 + 2 * vdim + njac * (2 + 2 * vdim)


def value_only_flops_per_pair(d: int, vdim: int) -> int:
    return fwd_flops_per_pair(d, vdim, njac=0)


def bwd_cotangent_flops(d: int, vdim: int) -> int:
    """The cotangents: s2 contractions (2 vdim d) + gg (2 vdim + 2d) +
    gquad (3) + gpd (2d) + select (1)."""
    return 2 * vdim * d + 2 * vdim + 2 * d + 3 + 2 * d + 1


def dxj_flops(d: int) -> int:
    """dL/dx's tile over all d output dims: d (4 + 2 (d - 1))."""
    return d * (2 * d + 2)


def bwd_dx_flops_per_pair(d: int, vdim: int) -> int:
    """dL/dx: recompute + cotangents + dx tiles + d row sums."""
    return (tile_quantities_flops(d) + bwd_cotangent_flops(d, vdim)
            + dxj_flops(d) + d)


def bwd_dn_flops_per_pair(d: int, vdim: int) -> int:
    """The parameter backward: recompute + cotangents + dv ((1 + d)
    contractions of 2 vdim + 2 selects) + dmu (dx tiles + d sums) + the
    precision's diagonal (4d) + off-diagonal (6 each) + bias (1)."""
    return (tile_quantities_flops(d) + bwd_cotangent_flops(d, vdim)
            + 2 + 2 * vdim * (1 + d)
            + dxj_flops(d) + d
            + 4 * d + 6 * _off(d) + 1)


# The dual-cotangent backward (two loss heads sharing one recompute)
# doubles the cotangent and accumulation work but shares the tile
# quantities: the JAX package's structure factor against one cotangent.
DUAL_FACTOR = 1.8


# ---- a projection epoch ----

@dataclass
class EpochCost:
    flops: float       # per epoch, on the pairs the caller's density gives
    hbm_bytes: float   # per epoch: each launch's inputs read once and
    #                    its outputs written once
    pairs: float       # (b, n) pairs per epoch at that density

    def achieved(self, epochs_per_sec: float) -> float:
        return self.flops * epochs_per_sec

    def utilization(self, epochs_per_sec: float, chip: str = "h100"):
        """Achieved rates and their shares of the card's peaks (percent):
        ``mfu_fp32_pct`` against the f32 peak the kernels run at,
        ``mfu_bf16_pct`` against the tensor cores' bf16 peak."""
        f = self.achieved(epochs_per_sec)
        p = PEAKS[chip]
        bps = self.hbm_bytes * epochs_per_sec
        return {
            "achieved_tflops": f / 1e12,
            "mfu_fp32_pct": 100 * f / p["f32"],
            "mfu_bf16_pct": 100 * f / p["bf16"],
            "hbm_gbps": bps / 1e9,
            "hbm_pct": 100 * bps / p["hbm"],
        }


def launch_bytes(b: int, n: int, d: int, vdim: int, out_cols: int = 0,
                 cot_blocks: int = 0, tb: int = 8, tn: int = 64) -> int:
    """Bytes of one centered launch on need: the queries (b d), the
    transposed rows (positions d n, packed precisions and bias
    (d (d + 1) / 2 + 1) n), the values (n vdim), the rows' radii (n) and
    the tile mask, read once; a forward writes ``out_cols`` per query, a
    parameter backward reads ``cot_blocks`` cotangent blocks of
    (1 + d) vdim per query and writes one parameter cotangent per
    block (positions, precisions, values: (d + npk + vdim) n)."""
    npk = d * (d + 1) // 2 + 1
    mask = -(-b // tb) * -(-n // tn)
    words = b * d + (d + npk + vdim + 1) * n + mask
    words += b * out_cols
    words += cot_blocks * (b * (1 + d) * vdim + (d + npk + vdim) * n)
    return 4 * words


def _projection_epoch_cost(d, b, n, density, vdim, rk4_evals, tb, tn):
    pairs = density * b * n
    f_fwd = fwd_flops_per_pair(d, vdim)
    f_dual = DUAL_FACTOR * (bwd_dx_flops_per_pair(d, vdim)
                            + bwd_dn_flops_per_pair(d, vdim))
    f_bnd = value_only_flops_per_pair(d, vdim) + bwd_dn_flops_per_pair(
        d, vdim) * 0.5   # value-only dn backward (no jac cotangents)
    flops = pairs * (rk4_evals * f_fwd + f_fwd + f_dual + f_bnd)
    jac_cols = (1 + d) * vdim
    fwd = launch_bytes(b, n, d, vdim, out_cols=jac_cols, tb=tb, tn=tn)
    nbytes = (rk4_evals * fwd                       # the covector target
              + fwd                                 # the heads' forward
              + launch_bytes(b, n, d, vdim, cot_blocks=2, tb=tb, tn=tn)
              + launch_bytes(b, n, d, vdim, out_cols=vdim, tb=tb, tn=tn)
              + launch_bytes(b, n, d, vdim, cot_blocks=1, tb=tb, tn=tn))
    return EpochCost(flops, nbytes, pairs)


def projection_epoch_cost_2d(b: int, n: int, density: float,
                             vdim: int = 2, rk4_evals: int = 5,
                             tb: int = 8, tn: int = 64) -> EpochCost:
    """The 2D projection epoch: ``rk4_evals`` value and Jacobian forwards
    for the covector target (the staged RK4), one shared forward and one
    dual-cotangent backward for the two heads, one value-only boundary
    forward and its backward; Adam and the regularizers, O(N), ignored.
    The FLOPs are the JAX package's formula on ``density * b * n`` pairs;
    the bytes those of these ``rk4_evals + 4`` launches on need."""
    return _projection_epoch_cost(2, b, n, density, vdim, rk4_evals, tb,
                                  tn)


def projection_epoch_cost_3d(b: int, n: int, density: float,
                             vdim: int = 3, rk4_evals: int = 5,
                             tb: int = 8, tn: int = 64) -> EpochCost:
    """The 3D projection epoch (vorticity, helicity and divergence heads
    over the shared forward, a boundary value head): the 2D structure at
    d = 3."""
    return _projection_epoch_cost(3, b, n, density, vdim, rk4_evals, tb,
                                  tn)


@torch.no_grad()
def measured_support_density(mix, spec, x, chunk: int = 256) -> float:
    """The fraction of (query, live Gaussian) pairs with g >= c, the pairs
    the inputs need, over ``x.shape[0] * mix.n_alive()``: pass it with
    ``n = mix.n_alive()``. Live: alive with its centre in the padded
    domain, as the field's mask (``ops/field.in_domain_mask``)."""
    from gaussian_fluids_torch.ops import field
    x = torch.as_tensor(x, dtype=torch.float32, device=mix.device)
    hits = 0
    for i in range(0, x.shape[0], chunk):
        hits += int(field.masked_kernel(mix, spec, x[i:i + chunk])[1].sum())
    return hits / max(x.shape[0] * mix.n_alive(), 1)


@torch.no_grad()
def measured_tile_density(mix, spec, x, tb: int = 8, tn: int = 64) -> float:
    """The fraction of (query tile, Gaussian tile) blocks the port's tile
    mask keeps (``ops/field._tile_mask``), the queries sorted along
    coordinate 0 and tiled at (tb, tn)."""
    from gaussian_fluids_torch.ops import field
    x = torch.as_tensor(x, dtype=torch.float32, device=mix.device)
    x = x[torch.argsort(x[:, 0], stable=True)]
    x_p = field._pad_axis(x, tb)
    tmask = field._tile_mask_of(mix, spec, x_p, x.shape[0], tb, tn)
    return int(tmask.sum()) / tmask.numel()


# ---------------------------------------------------------------------------
# The reference's GPU bound (the JAX package's model, unchanged): the
# reference's 2D projection epoch (2D/advance.py:187-302) is bound by
# launch and sync latency at leapfrog scale, not by FLOPs: its device
# work at B = 512, N = 5041 is ~1e8 FLOPs, but each eager epoch issues
#
#   - Taichi launches: advection_rk4 (1), get_grad_losses (1), boundary
#     get_losses (1), reinitialize_grid_ti (1, with a serialized
#     row-prefix-sum loop) = 4 (2D/GSR.py:549,365,256,194)
#   - eager torch ops: 8 zeros_like + data/vorticity math (~12) +
#     gradient_project 4x (~6 each, with one `(g1*g2).sum() < 0` host
#     sync per group, 2D/advance.py:189) + grad += (8) + aniso/vol/dpos
#     forward (~15) + .backward() (~30) + 4 single-tensor Adam steps
#     (~10 kernels each) + 4 plateau schedulers with float(metric) host
#     syncs + zero_grad (8) + scalings.min().item() host sync
#     (2D/GSR.py:226) ~= 130 kernel launches and >= 6 host syncs/epoch.
#
# On a GPU of the RTX 4090 class (the reference needs "CUDA 11+"):
#   generous (unreachably fast): 3 us/launch, 5 us/sync, no Python
#     dispatch -> 130*3 + 6*5 = 420 us/epoch -> ~2400 epochs/s
#   realistic eager PyTorch+Taichi: ~10 us/op, 20 us/sync
#     -> 130*10 + 6*20 = 1.42 ms/epoch -> ~700 epochs/s
REFERENCE_2D_EPOCH_BOUND = {"generous_eps": 2400.0, "realistic_eps": 700.0}


def reference_gpu_bound_2d():
    """(low, high) plausible epochs/s of the reference's 2D projection on
    a modern GPU at leapfrog scale: the modelled bound above."""
    return (REFERENCE_2D_EPOCH_BOUND["realistic_eps"],
            REFERENCE_2D_EPOCH_BOUND["generous_eps"])


# The reference's fused 3D kernel (3D/GSR.py:254-597) per projection epoch
# at ring_collide scale, as the JAX package models it:
#   - visited pairs: the kernel walks all Gaussians in the 27 cells
#     around each query (grid scale = the largest Gaussian's support
#     radius, 3D/GSR.py:247-252); both passes rebuild the quaternion, R
#     and the inverse covariance per visited pair (~150 FLOP); pass 2 adds
#     the derivative chain (~1,500 FLOP) for contributing pairs only.
#   - atomic adds: 39 atomic f32 += per contributing interior pair (13
#     per loss bucket x {vor, hel, div}, 3D/GSR.py:495-556) + 13 per
#     boundary pair.
#   - floors: atomics at 64e9/s (spread addresses, generous) or 8e9/s
#     (realistic, under collision); compute at 80 TFLOP/s f32, never
#     binding; launch/sync as in 2D.
REFERENCE_3D_ATOMIC_RATE = {"generous": 64e9, "realistic": 8e9}
REFERENCE_3D_LAUNCH_FLOOR_S = {"generous": 420e-6, "realistic": 1.42e-3}


def reference_gpu_bound_3d(contributing_pairs: float,
                           boundary_pairs: float,
                           visited_pairs: float) -> tuple:
    """(realistic_eps, generous_eps) plausible epochs/s of the reference's
    3D projection epoch: each 1 / (atomic time + launch/sync floor), the
    compute time checked but never binding at these scales."""
    atomics = 39.0 * contributing_pairs + 13.0 * boundary_pairs
    flops = 2.0 * visited_pairs * 150.0 + contributing_pairs * 1500.0
    out = []
    for mode in ("realistic", "generous"):
        t = (atomics / REFERENCE_3D_ATOMIC_RATE[mode]
             + REFERENCE_3D_LAUNCH_FLOOR_S[mode])
        t = max(t, flops / 80e12)
        out.append(1.0 / t)
    return tuple(out)


def measured_pair_stats_3d(mix, spec, x, boundary_x=None):
    """(visited, contributing, boundary_contributing) pairs per epoch of
    the reference's kernel at this mixture and batch, the inputs of
    :func:`reference_gpu_bound_3d`: ``visited`` simulates the reference's
    27-cell walk at its dynamic grid scale; ``contributing`` counts
    g >= clamp exactly (float32, as the JAX package counts it)."""
    from gaussian_fluids_torch.ops.rotations import precision_matrix

    alive = mix.alive.cpu().numpy()
    mu = mix.positions.detach().cpu().numpy()[alive]
    s = mix.scalings.detach().cpu().numpy()[alive]
    rot = mix.rotations.detach().cpu()[torch.as_tensor(alive)]
    P = precision_matrix(torch.as_tensor(s), rot, 3).numpy()
    c = spec.clamp_threshold
    x = np.asarray(x)

    def contributing(pts):
        tot = 0
        for i in range(0, pts.shape[0], 512):
            dl = pts[i:i + 512, None, :] - mu[None]
            quad = np.einsum("bni,nij,bnj->bn", dl, P, dl)
            tot += int((np.exp(-0.5 * quad) >= c).sum())
        return tot

    # the reference's dynamic grid scale (3D/GSR.py:247-252)
    gs = max(float(np.sqrt(-2 * np.log(c)) * np.exp(-s.min())),
             float(spec.min_grid_scale))
    lo = np.asarray(spec.lo, np.float32)
    nx = int(np.ceil((np.asarray(spec.hi) - lo).max() / gs)) + 2
    ci = np.clip(((mu - lo + gs) / gs).astype(int), 0, nx - 1)
    occ = {}
    for t in map(tuple, ci):
        occ[t] = occ.get(t, 0) + 1
    xi = np.clip(((x - lo + gs) / gs).astype(int), 0, nx - 1)
    visited = 0
    for q in range(x.shape[0]):
        a, b, cc = xi[q]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    visited += occ.get((a + dx, b + dy, cc + dz), 0)
    return (float(visited), float(contributing(x)),
            float(contributing(np.asarray(boundary_x)))
            if boundary_x is not None else 0.0)
