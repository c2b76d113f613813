// Shared device code of the Gaussian-splatting field kernels for Hopper
// (sm_90a): the centered geometry of one query-Gaussian pair, the
// per-tile forward and backward accumulations, for d = 2 and 3 and
// vdim = 1, 2, 3, and the staging of Gaussian tiles in shared memory by
// cp.async with the block compaction of the tiles to stage. Included by
// gsr_centered.cu (the tile-masked sweep), gsr_cells.cu (the work-list
// walk), gsr_banded.cu (the replay's windowed value) and rk4_fused.cu (the
// fused RK4 backtrace); the first two compute the same terms over the
// same pairs (the cells forward skips those outside a row's box, which
// add nothing).
//
// Math (the TPU kernels' _tile_quantities, all f32 on the CUDA cores):
//   delta = x - mu;  Pd_k = sum_j P_kj delta_j;  quad = delta.Pd + bias
//   g = exp(-quad / 2);  m = g >= clamp
//   val   += m (g - c) v          jac_k += -m g Pd_k v
// The quadratic form is CENTERED: the expanded form x'Px - 2x'P mu + mu'P mu
// cancels O(1e3) terms to O(1) (docs/KERNELS.md). Dead and padded rows
// carry a +1e9 bias so g underflows to exactly 0.
//
// Layout: x (B, D); muT (D, N); ppT (NP, N) = rows P_kk (k < D), the
// off-diagonals P_ij (i < j, lexicographic), the bias; v (N, vdim).
// Forward output (B, (1+njac) vdim) = [val | jac_0 | ... | jac_{D-1}].
// Backward outputs dmp (D + NP, N) = rows dmu_k, dP (packed as ppT), dbias,
// and dv (N, vdim).

#pragma once

#include <cuda_runtime.h>

namespace gsr {

constexpr int TB = 8;   // queries per tile: a warp each, centered forward
constexpr int TN = 64;  // Gaussians per tile: one thread each in backward

template <int D>
struct Dims {
  static constexpr int NB = D * (D + 1) / 2;  // packed precision entries
  static constexpr int NOFF = NB - D;         // off-diagonal entries
  static constexpr int NP = NB + 1;           // + the dead-row bias
  static constexpr int NMP = D + NP;          // backward rows per Gaussian
};

// Off-diagonal entry c is P_{pi(c), pj(c)}: (0,1) in 2D; (0,1), (0,2),
// (1,2) in 3D.
template <int D>
__device__ __forceinline__ constexpr int pair_i(int c) {
  return D == 2 ? 0 : (c < 2 ? 0 : 1);
}
template <int D>
__device__ __forceinline__ constexpr int pair_j(int c) {
  return D == 2 ? 1 : (c == 0 ? 1 : 2);
}

template <int D>
struct Geom {
  float dx[D], pd[D], g;
};

// One Gaussian's parameters, read from the transposed layouts.
template <int D>
struct Gauss {
  float mu[D], p[Dims<D>::NB], bias;
};

template <int D>
__device__ __forceinline__ Gauss<D> load_gauss(const float* __restrict__ muT,
                                               const float* __restrict__ ppT,
                                               int N, int n) {
  Gauss<D> G;
#pragma unroll
  for (int k = 0; k < D; ++k) G.mu[k] = muT[k * N + n];
#pragma unroll
  for (int k = 0; k < Dims<D>::NB; ++k) G.p[k] = ppT[k * N + n];
  G.bias = ppT[Dims<D>::NB * N + n];
  return G;
}

// The geometry is rounded as the plain PyTorch version rounds it: every
// product and sum on its own (__fmul_rn, __fadd_rn: no FMA contraction),
// in the same order, so quad, and with it the support test g >= clamp, is
// bitwise the plain version's. A pair at the edge of the support
// otherwise lands inside on one side and outside on the other, and the
// terms that jump there (g Pd in the Jacobian and in every backward) put
// one pair's whole contribution between the two.
template <int D>
__device__ __forceinline__ Geom<D> centered(const float* xq,
                                            const Gauss<D>& G) {
  Geom<D> q;
#pragma unroll
  for (int k = 0; k < D; ++k) q.dx[k] = xq[k] - G.mu[k];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float acc = __fmul_rn(G.p[k], q.dx[k]);
#pragma unroll
    for (int c = 0; c < Dims<D>::NOFF; ++c) {
      if (pair_i<D>(c) == k)
        acc = __fadd_rn(acc, __fmul_rn(G.p[D + c], q.dx[pair_j<D>(c)]));
      else if (pair_j<D>(c) == k)
        acc = __fadd_rn(acc, __fmul_rn(G.p[D + c], q.dx[pair_i<D>(c)]));
    }
    q.pd[k] = acc;
  }
  float quad = __fadd_rn(G.bias, __fmul_rn(q.dx[0], q.pd[0]));
#pragma unroll
  for (int k = 1; k < D; ++k)
    quad = __fadd_rn(quad, __fmul_rn(q.dx[k], q.pd[k]));
  q.g = expf(-0.5f * quad);
  return q;
}

// Forward: query xq against the 64 Gaussians of tile j, the 32 lanes of
// the query's warp taking two each. acc holds (1 + D) * VDIM partial sums.
template <int D, int VDIM>
__device__ __forceinline__ void fwd_tile(const float* xq, int j, int lane,
                                         const float* __restrict__ muT,
                                         const float* __restrict__ ppT,
                                         const float* __restrict__ v, int N,
                                         int njac, float clamp, float* acc) {
  for (int n = j * TN + lane; n < (j + 1) * TN; n += 32) {
    const Geom<D> q = centered<D>(xq, load_gauss<D>(muT, ppT, N, n));
    if (q.g >= clamp) {
      const float gc = q.g - clamp;
#pragma unroll
      for (int a = 0; a < VDIM; ++a) {
        const float va = v[n * VDIM + a];
        acc[a] += gc * va;
        if (njac) {
#pragma unroll
          for (int k = 0; k < D; ++k)
            acc[(1 + k) * VDIM + a] += -q.g * q.pd[k] * va;
        }
      }
    }
  }
}

// Sum the warp's partial sums (a fixed shuffle tree) and store query b.
template <int D, int VDIM>
__device__ __forceinline__ void fwd_store(float* acc, int lane, int b,
                                          int njac, float* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k)
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  if (lane == 0) {
    const int cols = (1 + njac) * VDIM;
    for (int k = 0; k < cols; ++k) out[b * cols + k] = acc[k];
  }
}

// The cotangents of one pair with g >= clamp (the TPU kernels'
// _bwd_cotangents): returns gquad = dL/dquad and fills gpd_k = dL/dPd_k
// and s2_k = djac_k . v (zero when njac = 0, the value-only mode).
// use_val = 0 promises a zero value cotangent.
template <int D, int VDIM>
__device__ __forceinline__ float pair_cotangents(
    const Geom<D>& q, const float* __restrict__ dout_row, const float* vv,
    int njac, int use_val, float* s2, float* gpd) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    s2[k] = 0.f;
    if (njac) {
#pragma unroll
      for (int a = 0; a < VDIM; ++a)
        s2[k] += dout_row[(1 + k) * VDIM + a] * vv[a];
    }
  }
  float gg;
  if (use_val) {
    float s1 = 0.f;
#pragma unroll
    for (int a = 0; a < VDIM; ++a) s1 += dout_row[a] * vv[a];
    gg = s1;
    if (njac) {
#pragma unroll
      for (int k = 0; k < D; ++k) gg -= s2[k] * q.pd[k];
    }
  } else {
    gg = -s2[0] * q.pd[0];
#pragma unroll
    for (int k = 1; k < D; ++k) gg -= s2[k] * q.pd[k];
  }
#pragma unroll
  for (int k = 0; k < D; ++k) gpd[k] = -q.g * s2[k];
  return -0.5f * q.g * gg;
}

// dL/dx_k of one pair (the TPU kernels' _dxj_tile): dquad/dx_k = 2 Pd_k,
// dPd_i/dx_k = P_ik; no Pd cotangents in the value-only mode.
template <int D>
__device__ __forceinline__ float pair_dx(const Geom<D>& q, float gquad,
                                         const float* gpd, const float* p,
                                         int njac, int k) {
  float t = gquad * (2.f * q.pd[k]);
  if (njac) {
    t += gpd[k] * p[k];
#pragma unroll
    for (int c = 0; c < Dims<D>::NOFF; ++c) {
      if (pair_i<D>(c) == k) t += gpd[pair_j<D>(c)] * p[D + c];
      else if (pair_j<D>(c) == k) t += gpd[pair_i<D>(c)] * p[D + c];
    }
  }
  return t;
}

// One cotangent block's contribution of one query to one Gaussian, given
// the shared geometry q (with g >= clamp). Mirrors _bwd_cotangents and
// _dn_accumulate of the TPU kernels.
template <int D, int VDIM>
__device__ __forceinline__ void dn_accumulate(
    const Geom<D>& q, const float* __restrict__ dout_row, const float* vv,
    const float* p, int njac, int use_val, float clamp, float* accm,
    float* accv) {
  float s2[D], gpd[D];
  const float gquad =
      pair_cotangents<D, VDIM>(q, dout_row, vv, njac, use_val, s2, gpd);

#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
    float t = 0.f;
    if (use_val) t += (q.g - clamp) * dout_row[a];
    if (njac) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        t += -q.g * q.pd[k] * dout_row[(1 + k) * VDIM + a];
    }
    accv[a] += t;
  }
  // dmu_k = -dL/dx_k
#pragma unroll
  for (int k = 0; k < D; ++k) accm[k] -= pair_dx<D>(q, gquad, gpd, p, njac, k);
  // diagonal precisions
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float r = gquad * q.dx[k] * q.dx[k];
    if (njac) r += gpd[k] * q.dx[k];
    accm[D + k] += r;
  }
  // off-diagonal precisions
#pragma unroll
  for (int c = 0; c < Dims<D>::NOFF; ++c) {
    const int i = pair_i<D>(c), j = pair_j<D>(c);
    float r = 2.f * gquad * q.dx[i] * q.dx[j];
    if (njac) r += gpd[i] * q.dx[j] + gpd[j] * q.dx[i];
    accm[2 * D + c] += r;
  }
  accm[D + Dims<D>::NB] += gquad;   // dead-row bias
}

// Backward: the Gaussian G (one thread) against the TB queries of tile i,
// for NCOT cotangent blocks sharing one geometry.
template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void bwd_tile(
    int i, const float* __restrict__ x, const Gauss<D>& G, const float* vv,
    const float* __restrict__ dout1, const float* __restrict__ dout2,
    int njac, int use_val, float clamp, float (*accm)[Dims<D>::NMP],
    float (*accv)[VDIM]) {
  const int cols = (1 + njac) * VDIM;
  for (int r = 0; r < TB; ++r) {
    const int b = i * TB + r;
    const Geom<D> q = centered<D>(x + b * D, G);
    // every term carries the mask m = g >= clamp
    if (!(q.g >= clamp)) continue;
    dn_accumulate<D, VDIM>(q, dout1 + b * cols, vv, G.p, njac, use_val,
                           clamp, accm[0], accv[0]);
    if (NCOT == 2)
      dn_accumulate<D, VDIM>(q, dout2 + b * cols, vv, G.p, njac, use_val,
                             clamp, accm[NCOT - 1], accv[NCOT - 1]);
  }
}

template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void bwd_store(
    int n, int N, float (*accm)[Dims<D>::NMP], float (*accv)[VDIM],
    float* __restrict__ dmp1, float* __restrict__ dv1,
    float* __restrict__ dmp2, float* __restrict__ dv2) {
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
    float* dmp = c == 0 ? dmp1 : dmp2;
    float* dv = c == 0 ? dv1 : dv2;
#pragma unroll
    for (int k = 0; k < Dims<D>::NMP; ++k) dmp[k * N + n] = accm[c][k];
#pragma unroll
    for (int a = 0; a < VDIM; ++a) dv[n * VDIM + a] = accv[c][a];
  }
}

// Asynchronous 16-byte copies from global to shared memory (sm_80+
// cp.async, L2 only): the staged kernels issue a later tile's copies,
// commit them as one group, and wait for all but the newest groups before
// the block reads the current tile (walk_staged below).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage Gaussian tile j (TN rows) into shared memory as a structure of
// arrays of TN floats each: D rows mu_k, NP rows of ppT (P_kk, P_ij, the
// bias), one row of dilated radii, then the TN x VDIM values. Every slice
// is 256 contiguous bytes of a (., N) row (N a multiple of TN), so each
// goes as 16 cp.async copies of 16 bytes. A thread of NT takes copies
// tid, tid + NT, ...: their sources and destinations, apart from the
// tile's offset, are computed once.
template <int D, int VDIM>
struct StagedTile {
  static constexpr int MU = 0;
  static constexpr int PP = D * TN;
  static constexpr int RAD = (D + Dims<D>::NP) * TN;
  static constexpr int V = RAD + TN;
  static constexpr int FLOATS = V + TN * VDIM;
};

template <int D, int VDIM, int NT>
struct Stager {
  static constexpr int C = TN / 4;                   // copies per slice
  static constexpr int ROWS = D + Dims<D>::NP + 1;   // mu, ppT, radius
  static constexpr int TOTAL = ROWS * C + TN * VDIM / 4;
  static constexpr int PER = (TOTAL + NT - 1) / NT;
  const float* src[PER];
  int step[PER], dst[PER];

  __device__ __forceinline__ Stager(const float* __restrict__ muT,
                                    const float* __restrict__ ppT,
                                    const float* __restrict__ rad,
                                    const float* __restrict__ v, int N) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * NT;
      dst[p] = e < TOTAL ? 4 * e : -1;
      if (e < ROWS * C) {
        const int f = e / C, c = e % C;
        src[p] = (f < D ? muT + f * N
                        : (f < ROWS - 1 ? ppT + (f - D) * N : rad)) + 4 * c;
        step[p] = TN;
      } else {
        src[p] = v + 4 * (e - ROWS * C);
        step[p] = TN * VDIM;
      }
    }
  }
  __device__ __forceinline__ void stage(float* st, int j) const {
#pragma unroll
    for (int p = 0; p < PER; ++p)
      if (dst[p] >= 0) cp_async16(st + dst[p], src[p] + j * step[p]);
  }
};

// Block-wide stream compaction: the threads' (flag, value) pairs with
// flag set go to list[0, count) in thread order (a ballot per warp, the
// warps' counts in order); returns the count to every thread. Every
// thread of the block (nwarps whole warps) calls it; the caller's earlier
// reads of list and wcount must be behind a __syncthreads.
__device__ __forceinline__ int compact_warps(bool flag, int value,
                                             int* list, int* wcount,
                                             int nwarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int off = 0, cnt = 0;
#pragma unroll
  for (int w = 0; w < nwarps; ++w) {
    off += w < warp ? wcount[w] : 0;
    cnt += wcount[w];
  }
  if (flag) list[off + __popc(bal & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return cnt;
}

// The same for a block of NT threads known at compile time.
template <int NT>
__device__ __forceinline__ int compact_block(bool flag, int value,
                                             int* list, int* wcount) {
  return compact_warps(flag, value, list, wcount, NT / 32);
}

// Walk the cnt Gaussian tiles of list (in shared memory) in order through
// NSTAGE staging buffers: tile m + NSTAGE - 1 is in flight by cp.async
// while eval(tile m's buffer) runs. Every thread of the block (NT) calls
// it; it ends behind a __syncthreads, so list may be refilled after.
template <int D, int VDIM, int NSTAGE, int NT, class Eval>
__device__ __forceinline__ void walk_staged(
    const int* list, int cnt, float (*stage)[StagedTile<D, VDIM>::FLOATS],
    const Stager<D, VDIM, NT>& st, Eval eval) {
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < cnt) st.stage(stage[p], list[p]);
    cp_async_commit();
  }
  for (int m = 0; m < cnt; ++m) {
    const int pf = m + NSTAGE - 1;
    if (pf < cnt) st.stage(stage[pf % NSTAGE], list[pf]);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();   // this thread's copies of tile m landed
    __syncthreads();               // ... and every thread's
    eval(stage[m % NSTAGE]);
    __syncthreads();               // every thread is done with its buffer
  }
}

inline bool bad_shape(int B, int N, int d, int vdim, int njac) {
  return B < 0 || N < 0 || B % TB || N % TN || (d != 2 && d != 3) ||
         vdim < 1 || vdim > 3 || (njac != 0 && njac != d);
}

// Calls f.template run<D, VDIM>() for the runtime (d, vdim), which
// bad_shape has checked.
template <class F>
int dispatch(int d, int vdim, F f) {
  if (d == 2) {
    if (vdim == 1) return f.template run<2, 1>();
    if (vdim == 2) return f.template run<2, 2>();
    return f.template run<2, 3>();
  }
  if (vdim == 1) return f.template run<3, 1>();
  if (vdim == 2) return f.template run<3, 2>();
  return f.template run<3, 3>();
}

}  // namespace gsr
