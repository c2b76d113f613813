// Shared device code of the Gaussian-splatting field kernels for Hopper
// (sm_90a): the centered geometry of one query-Gaussian pair, the
// backward accumulations, for d = 2 and 3 and vdim = 1, 2, 3; the staging
// of Gaussian tiles in shared memory by cp.async with the block compaction
// of the tiles to stage; the staged sweep of a query tile over its live
// Gaussian tiles (fwd_sweep, templated on the per-pair body: the forward's
// accumulation in the centered and the cells forwards and the fused RK4
// kernel, dL/dx in the centered dL/dx kernel) with its fixed-order meeting
// of a query's sums (query_meet); and the split parameter backward's tile
// step and its fixed-order meeting of partial sums (dn_tile,
// dn_meet_store), shared by the centered and the cells backwards.
// Included by gsr_centered.cu (the tile-masked kernels), gsr_cells.cu (the
// work-list kernels), gsr_banded.cu (the replay's windowed value) and
// rk4_fused.cu (the fused RK4 backtrace); all compute the same terms over
// the same pairs as their plain twins (a box test skips only pairs
// outside a row's support box, which add nothing).
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
// off-diagonals P_ij (i < j, lexicographic), the bias; v (N, vdim); rad
// (N) each row's support radius dilated by 1e-3, -1 on dead and padded
// rows (ops/field.py row_radius).
// Forward output (B, (1+njac) vdim) = [val | jac_0 | ... | jac_{D-1}].
// Backward outputs dmp (D + NP, N) = rows dmu_k, dP (packed as ppT), dbias,
// and dv (N, vdim).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gsr {

constexpr int TB = 8;   // queries per tile
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

// The outputs of up to MAX_NCOT cotangent blocks: block c's parameter rows
// dmp[c] (D + NP, N) and values dv[c] (N, VDIM).
constexpr int MAX_NCOT = 3;
struct DnOut {
  float* dmp[MAX_NCOT];
  float* dv[MAX_NCOT];
};

template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void bwd_store(int n, int N,
                                          float (*accm)[Dims<D>::NMP],
                                          float (*accv)[VDIM],
                                          const DnOut& out) {
  static_assert(NCOT <= MAX_NCOT, "at most MAX_NCOT blocks");
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
#pragma unroll
    for (int k = 0; k < Dims<D>::NMP; ++k)
      out.dmp[c][k * N + n] = accm[c][k];
#pragma unroll
    for (int a = 0; a < VDIM; ++a) out.dv[c][n * VDIM + a] = accv[c][a];
  }
}

// The split parameter backward (the centered rows 2, 3 and 10, the cells
// rows 6 and 7): each Gaussian gets W x S threads, W workers of TN threads a
// block and S blocks of a thread-block cluster, each walking an equal
// share of its tile's live query tiles. Its limits: at most MAX_W workers
// a block and MAX_S blocks a cluster (the portable cluster maximum).
constexpr int MAX_W = 8;
constexpr int MAX_S = 8;

inline bool bad_split(int W, int S) {
  return (W != 1 && W != 2 && W != 4 && W != MAX_W) ||
         (S != 1 && S != 2 && S != 4 && S != MAX_S);
}

template <int D, int VDIM, int NCOT>
constexpr int dn_sums() {   // the partial sums a thread keeps
  return NCOT * (Dims<D>::NMP + VDIM);
}

// The Gaussian G (one thread) against the TB queries of one tile, x rows
// at xt and xg (the same values: xt may be a copy in registers, indexed
// here only by constants; xg in global memory), cotangent rows at d1 and
// d2 (cols apart), for NCOT <= 2 blocks sharing one geometry, the pairs
// in query order and each pair's terms dn_accumulate's. Unboxed, the
// support test of all TB pairs runs first as independent chains, then
// the accumulation of the pairs inside, in query order, the recomputed
// geometry bitwise the tested one. BOXED first tests every query against
// the Gaussian's box, |x_k - mu_k| <= rad on every axis k (rad: its
// dilated support radius, -1 on a dead row), and takes the geometry, the
// support test and the accumulation only for the queries inside, in query
// order, as a loop over their bits (a branch per query would be
// if-converted, and every geometry paid): a pair outside has g < c
// however f32 rounds, so the skip never decides the support.
template <int D, int VDIM, int NCOT, bool BOXED>
__device__ __forceinline__ void dn_tile(const float* xt, const float* xg,
                                        const float* d1, const float* d2,
                                        int cols, const Gauss<D>& G,
                                        float rad, const float* vv, int njac,
                                        int use_val, float clamp,
                                        float (*accm)[Dims<D>::NMP],
                                        float (*accv)[VDIM]) {
  static_assert(NCOT <= 2, "dn_tile takes one or two blocks");
  unsigned in = 0;
  if (BOXED) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      bool box = true;
#pragma unroll
      for (int k = 0; k < D; ++k)
        box &= fabsf(xt[r * D + k] - G.mu[k]) <= rad;
      in |= static_cast<unsigned>(box) << r;
    }
  } else {
#pragma unroll
    for (int r = 0; r < TB; ++r)
      if (centered<D>(xt + r * D, G).g >= clamp) in |= 1u << r;
  }
  for (; in; in &= in - 1) {
    const int r = __ffs(in) - 1;
    const Geom<D> q = centered<D>(xg + r * D, G);
    if (BOXED && !(q.g >= clamp)) continue;
    dn_accumulate<D, VDIM>(q, d1 + r * cols, vv, G.p, njac, use_val, clamp,
                           accm[0], accv[0]);
    if (NCOT == 2)
      dn_accumulate<D, VDIM>(q, d2 + r * cols, vv, G.p, njac, use_val,
                             clamp, accm[NCOT - 1], accv[NCOT - 1]);
  }
}

// One Gaussian's partial sums to and from a slot of TN x dn_sums floats.
template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void put_sums(float* slot, int g,
                                         float (*accm)[Dims<D>::NMP],
                                         float (*accv)[VDIM]) {
  constexpr int NMP = Dims<D>::NMP;
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
#pragma unroll
    for (int k = 0; k < NMP; ++k) slot[(c * NMP + k) * TN + g] = accm[c][k];
#pragma unroll
    for (int a = 0; a < VDIM; ++a)
      slot[(NCOT * NMP + c * VDIM + a) * TN + g] = accv[c][a];
  }
}
template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void add_sums(const float* slot, int g,
                                         float (*accm)[Dims<D>::NMP],
                                         float (*accv)[VDIM]) {
  constexpr int NMP = Dims<D>::NMP;
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
#pragma unroll
    for (int k = 0; k < NMP; ++k) accm[c][k] += slot[(c * NMP + k) * TN + g];
#pragma unroll
    for (int a = 0; a < VDIM; ++a)
      accv[c][a] += slot[(NCOT * NMP + c * VDIM + a) * TN + g];
  }
}

// The partial sums of Gaussian n (lane g of its tile) held by worker w of
// W in block rank s of S meet in one fixed order through `red` (a slot of
// TN x dn_sums floats in shared memory): the W workers' in w order
// (worker r hands its sums to worker 0), then the S blocks' in rank order
// through distributed shared memory, added by rank 0, whose worker 0
// stores. One owner and one fixed order per output element, no atomics.
// Every thread of the cluster calls it.
template <int D, int VDIM, int NCOT>
__device__ __forceinline__ void dn_meet_store(float* red, int g, int w,
                                              int W, int s, int S, int n,
                                              int N,
                                              float (*accm)[Dims<D>::NMP],
                                              float (*accv)[VDIM],
                                              const DnOut& out) {
  for (int r = 1; r < W; ++r) {
    if (w == r) put_sums<D, VDIM, NCOT>(red, g, accm, accv);
    __syncthreads();
    if (w == 0) add_sums<D, VDIM, NCOT>(red, g, accm, accv);
    __syncthreads();
  }
  if (S > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (w == 0 && s > 0) put_sums<D, VDIM, NCOT>(red, g, accm, accv);
    cluster.sync();
    if (w == 0 && s == 0) {
      for (int r = 1; r < S; ++r)
        add_sums<D, VDIM, NCOT>(cluster.map_shared_rank(red, r), g, accm,
                                accv);
    }
    cluster.sync();   // the other blocks' slots stay until rank 0 read them
  }
  if (w == 0 && s == 0) bwd_store<D, VDIM, NCOT>(n, N, accm, accv, out);
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

// Walk the cnt Gaussian tiles list[0], list[stride], ... (in shared
// memory) in order through NSTAGE staging buffers: tile m + NSTAGE - 1 is
// in flight by cp.async while eval(tile m's buffer) runs. Every thread of
// the block (NT) calls it; it ends behind a __syncthreads when cnt > 0, so
// list may be refilled after, and leaves no copy in flight.
template <int D, int VDIM, int NSTAGE, int NT, class Eval>
__device__ __forceinline__ void walk_staged(
    const int* list, int cnt, float (*stage)[StagedTile<D, VDIM>::FLOATS],
    const Stager<D, VDIM, NT>& st, Eval eval, int stride = 1) {
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < cnt) st.stage(stage[p], list[p * stride]);
    cp_async_commit();
  }
  for (int m = 0; m < cnt; ++m) {
    const int pf = m + NSTAGE - 1;
    if (pf < cnt) st.stage(stage[pf % NSTAGE], list[pf * stride]);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();   // this thread's copies of tile m landed
    __syncthreads();               // ... and every thread's
    eval(stage[m % NSTAGE]);
    __syncthreads();               // every thread is done with its buffer
  }
}

// First w in [0, cap) with keys[w] >= key (keys ascending).
__device__ __forceinline__ int run_start(const int* __restrict__ keys,
                                         int cap, int key) {
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// run_start by one warp, every lane calling it and getting the answer:
// 31 probes a step narrow [lo, hi] 32-fold, so a list of n items costs
// ~log32(n) + 1 dependent loads where the binary search costs log2(n)
// (4 against 19 for a Ring-Collide list).
__device__ __forceinline__ int run_start_warp(const int* __restrict__ keys,
                                              int cap, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;   // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step;
    const int c =
        __popc(__ballot_sync(0xffffffffu, p < hi && keys[p] < key));
    const int nlo = c ? lo + c * step + 1 : lo;
    hi = min(hi, lo + (c + 1) * step);
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(0xffffffffu,
                                   lo + lane < hi && keys[lo + lane] < key));
}

// The live tiles of one walker, in order, as candidates c = 0, 1, ...:
// when `listed`, the run of `key` in a work list (heads row-sorted, items
// the live tile or -1: ops/spatial.py flat_work_list) from w0 =
// run_start(heads, cap, key), whose live items come first, so a chunk of
// candidates with a dead one is the run's last; otherwise the key's line
// of the tile mask, line[c * stride] for c < total (a query tile's row,
// stride 1, or a Gaussian tile's column, stride nnt). WORKLIST = false
// promises `listed` is false and drops the list's code.
template <bool WORKLIST>
struct LiveTiles {
  const int* heads;
  const int* items;
  int cap, w0, key;
  const int* line;
  int stride, total;
  bool listed;
  // whether candidate c is live, and its tile
  __device__ __forceinline__ bool live(int c, int& tile) const {
    if (WORKLIST && listed) {
      const int w = w0 + c;
      if (w >= cap || heads[w] != key) return false;
      tile = items[w];
      return tile >= 0;
    }
    tile = c;
    return c < total && line[c * stride] != 0;
  }
  // whether a chunk of nt candidates ending before `next`, with k live,
  // was the last
  __device__ __forceinline__ bool last(int next, int k, int nt) const {
    return (WORKLIST && listed) ? k < nt : next >= total;
  }
};

// Compact the next window of a walker's live tiles into list[0, cnt): the
// candidates from `base` on, in chunks of min(nthreads, win) (every thread
// of the block calls it, nthreads whole warps), until `win` candidates (a
// multiple of the chunk) or the last chunk. Returns cnt; `more` says
// whether candidates remain. The caller's earlier reads of list must be
// behind a __syncthreads.
template <bool WORKLIST>
__device__ __forceinline__ int compact_window(const LiveTiles<WORKLIST>& src,
                                              int base, int win,
                                              int nthreads, int* list,
                                              int* wcount, bool& more) {
  const int chunk = min(nthreads, win);
  int cnt = 0;
  more = true;
  for (int c = 0; c < win; c += chunk) {
    int tile = -1;
    const bool f = static_cast<int>(threadIdx.x) < chunk &&
                   src.live(base + c + threadIdx.x, tile);
    const int k = compact_warps(f, tile, list + cnt, wcount, nthreads / 32);
    cnt += k;
    if (src.last(base + c + chunk, k, chunk)) {
      more = false;
      break;
    }
  }
  return cnt;
}

// The staged forward walk (the centered forward, row 1, and the cells
// forward, row 5; its sweep also runs the fused RK4 stages, row 9, and
// dL/dx, row 4). Of the pairs of the live tiles at Ring-Collide only
// ~1.3% have the query inside the Gaussian's support box, and a warp that
// loads its tile from global memory itself has only two pairs a lane
// before its next dependent load. So the block, query tile i (FWD_SLOTS
// threads per query, FWD_THREADS in all), compacts its live Gaussian
// tiles FWD_THREADS candidates at a time (LiveTiles: its run of the work
// list, or its row of the tile mask) and stages each tile's rows (mu,
// packed P and bias, dilated radius, v) in shared memory once, two later
// tiles in flight by cp.async while the current one is evaluated
// (walk_staged). Thread (q, s) takes query q against FWD_ROWS = TN /
// FWD_SLOTS consecutive rows of every tile (independent pairs). A pair
// first tests |x_k - mu_k| <= r on every axis (r the row's radius
// dilated by 1e-3, -1 on dead rows): one that fails has g < c however f32
// rounds, so the test is a pure skip; one that passes takes centered<D>
// unchanged, whose rounding keeps the support test bitwise the plain
// version's. Each query's FWD_SLOTS partial sums meet in one fixed
// shuffle tree.
//
// Split: when the query tiles are too few to fill the card, S blocks of
// a thread-block cluster (gridDim.y = S, cluster (1, S, 1)) share query
// tile i: rank s walks the live tiles whose place in the compacted list
// is s modulo S (carried over the chunks, so the shares differ by at most
// one tile however the live tiles cluster). The ranks' sums meet in rank
// order through distributed shared memory, added by rank 0, which alone
// stores: one owner and one fixed order per output, no atomics.
constexpr int FWD_SLOTS = 16;
constexpr int FWD_THREADS = TB * FWD_SLOTS;
constexpr int FWD_ROWS = TN / FWD_SLOTS;
constexpr int FWD_STAGES = 3;
static_assert(FWD_ROWS % 4 == 0 && 32 % FWD_SLOTS == 0,
              "rows in fours; a query's slots share one warp");

template <int D, int VDIM>
struct FwdSmem {
  float stage[FWD_STAGES][StagedTile<D, VDIM>::FLOATS];
  int list[FWD_THREADS];
  int wcount[FWD_THREADS / 32];
};
static_assert(TB * 12 <= StagedTile<2, 1>::FLOATS,
              "a block's query sums fit one staging buffer");

// The Gaussian tiles whose boxes meet a query tile's box [qlo, qhi]:
// lo, hi (D, nnt), each tile's box over its live rows, every row dilated
// by its radius, +-inf on a tile with none (ops/field.py
// gaussian_tile_boxes). Candidate c is tile c. A query tile whose box
// misses a tile's holds no pair with g >= c there, however f32 rounds
// (the margin of ops/field.py row_radius), so the test is a pure skip.
// The live tiles of a fused RK4 stage (rk4_fused.cu), LiveTiles'
// interface.
template <int D>
struct BoxTiles {
  const float* lo;
  const float* hi;
  int nnt;
  float qlo[D], qhi[D];
  __device__ __forceinline__ bool live(int c, int& tile) const {
    tile = c;
    if (c >= nnt) return false;
    bool meet = true;
#pragma unroll
    for (int k = 0; k < D; ++k)
      meet &= __ldg(lo + k * nnt + c) <= qhi[k] &&
              __ldg(hi + k * nnt + c) >= qlo[k];
    return meet;
  }
  __device__ __forceinline__ bool last(int next, int, int) const {
    return next >= nnt;
  }
};

// The forward's pair body: the value and njac Jacobian groups of one pair
// inside the support (g >= clamp), v read from the staged tile t, added to
// the query's partial sums acc.
template <int D, int VDIM>
struct FwdPair {
  float* acc;
  int njac;
  float clamp;
  __device__ __forceinline__ void operator()(const Geom<D>& qg,
                                             const Gauss<D>&, const float* t,
                                             int n) const {
    const float gc = qg.g - clamp;
#pragma unroll
    for (int a = 0; a < VDIM; ++a) {
      const float va = t[StagedTile<D, VDIM>::V + n * VDIM + a];
      acc[a] += gc * va;
      if (njac) {
#pragma unroll
        for (int k = 0; k < D; ++k)
          acc[(1 + k) * VDIM + a] += -qg.g * qg.pd[k] * va;
      }
    }
  }
};

// The staged sweep of fwd_walk: this thread's query xq (registers) against
// FWD_ROWS rows of every live tile that src gives (a LiveTiles or a
// BoxTiles), rank s of S walking places s, s + S, ... of the compacted
// list; calls pair(geometry, Gaussian, staged tile, row) for every pair
// inside the support, tiles in order, rows ascending (FwdPair: the
// forward's sums; DxPair in gsr_centered.cu: dL/dx). Every thread of the
// block calls it; it leaves no copy in flight, and a __syncthreads lies
// between its start and its end.
template <int D, int VDIM, class Src, class Pair>
__device__ __forceinline__ void fwd_sweep(
    const Src& src, const float* xq, const Stager<D, VDIM, FWD_THREADS>& st,
    float clamp, FwdSmem<D, VDIM>& sm, const Pair& pair) {
  constexpr int NB = Dims<D>::NB;
  using ST = StagedTile<D, VDIM>;
  const int tid = threadIdx.x;
  const int slot = tid % FWD_SLOTS;
  const int s = blockIdx.y, S = gridDim.y;
  // A staged tile: rows FWD_ROWS slot .. FWD_ROWS (slot + 1) - 1 are
  // this thread's. Their box tests first (16-byte reads), then the
  // geometry of the rows that pass, ascending: a warp runs the geometry as
  // often as its busiest lane has passing rows, not once per row.
  auto eval = [&](const float* t) {
    float r[FWD_ROWS];
#pragma unroll
    for (int g = 0; g < FWD_ROWS / 4; ++g) {
      const float4 r4 = *reinterpret_cast<const float4*>(
          t + ST::RAD + FWD_ROWS * slot + 4 * g);
      r[4 * g] = r4.x;
      r[4 * g + 1] = r4.y;
      r[4 * g + 2] = r4.z;
      r[4 * g + 3] = r4.w;
    }
    unsigned hit = (1u << FWD_ROWS) - 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int g = 0; g < FWD_ROWS / 4; ++g) {
        const float4 m4 = *reinterpret_cast<const float4*>(
            t + ST::MU + k * TN + FWD_ROWS * slot + 4 * g);
        const float m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          if (!(fabsf(xq[k] - m[rr]) <= r[4 * g + rr]))
            hit &= ~(1u << (4 * g + rr));
      }
    }
    for (; hit; hit &= hit - 1) {   // outside a row's box: g < c, skipped
      const int n = FWD_ROWS * slot + __ffs(hit) - 1;
      Gauss<D> G;
#pragma unroll
      for (int k = 0; k < D; ++k) G.mu[k] = t[ST::MU + k * TN + n];
#pragma unroll
      for (int k = 0; k < NB; ++k) G.p[k] = t[ST::PP + k * TN + n];
      G.bias = t[ST::PP + NB * TN + n];
      const Geom<D> qg = centered<D>(xq, G);
      if (qg.g >= clamp) pair(qg, G, t, n);
    }
  };

  // the live tiles, FWD_THREADS candidates at a time; rank s walks the
  // ones at places s, s + S, ... of the whole compacted list
  int seen = 0;
  for (int base = 0;; base += FWD_THREADS) {
    int tile = -1;
    const bool f = src.live(base + tid, tile);
    const int cnt = compact_block<FWD_THREADS>(f, tile, sm.list, sm.wcount);
    const int first = (s - seen % S + S) % S;
    walk_staged<D, VDIM, FWD_STAGES, FWD_THREADS>(
        sm.list + first, cnt > first ? (cnt - first + S - 1) / S : 0,
        sm.stage, st, eval, S);
    seen += cnt;
    if (src.last(base + FWD_THREADS, cnt, FWD_THREADS)) break;
  }
}

// A query's NACC partial sums after fwd_sweep (thread (q, slot), rank s
// of S): its FWD_SLOTS threads' meet in one fixed butterfly tree, then the
// S ranks' in rank order through distributed shared memory (the block's
// first staging buffer, free after the sweep: no copy in flight, every
// read of it behind a __syncthreads), added by rank 0, whose first slot
// then holds the query's sums and alone stores them. Every thread of the
// cluster calls it.
template <int NACC, int D, int VDIM>
__device__ __forceinline__ void query_meet(float* acc, FwdSmem<D, VDIM>& sm,
                                           int q, int slot, int s, int S) {
#pragma unroll
  for (int k = 0; k < NACC; ++k)
    for (int off = FWD_SLOTS / 2; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (S > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* red = sm.stage[0] + q * NACC;
    if (slot == 0 && s > 0) {
#pragma unroll
      for (int k = 0; k < NACC; ++k) red[k] = acc[k];
    }
    cluster.sync();
    if (slot == 0 && s == 0) {
      for (int r = 1; r < S; ++r) {
        const float* o = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] += o[k];
      }
    }
    cluster.sync();   // the other blocks' sums stay until rank 0 read them
  }
}

template <int D, int VDIM, bool WORKLIST>
__device__ __forceinline__ void fwd_walk(
    const LiveTiles<WORKLIST>& src, int i, const float* __restrict__ x,
    const float* __restrict__ muT, const float* __restrict__ ppT,
    const float* __restrict__ rad, const float* __restrict__ v,
    float* __restrict__ out, int N, int njac, float clamp,
    FwdSmem<D, VDIM>& sm) {
  constexpr int NACC = (1 + D) * VDIM;
  const int tid = threadIdx.x;
  const int slot = tid % FWD_SLOTS, q = tid / FWD_SLOTS;
  const int b = i * TB + q;
  const int s = blockIdx.y, S = gridDim.y;
  float xq[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  const Stager<D, VDIM, FWD_THREADS> st(muT, ppT, rad, v, N);
  fwd_sweep<D, VDIM>(src, xq, st, clamp, sm,
                     FwdPair<D, VDIM>{acc, njac, clamp});
  query_meet<NACC>(acc, sm, q, slot, s, S);
  if (s == 0 && slot == 0) {
    const int ncol = (1 + njac) * VDIM;
    for (int k = 0; k < ncol; ++k) out[b * ncol + k] = acc[k];
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
