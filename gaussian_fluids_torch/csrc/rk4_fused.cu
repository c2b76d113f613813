// Fused RK4 backtrace through a Gaussian velocity field, with the value
// and Jacobian at the endpoint, for Hopper (sm_90a); d = vdim = 2 or 3.
//
// Replaces the Pallas TPU kernel _rk4_kernel of the JAX package
// (gaussian_fluids_tpu/ops/pallas/rk4_fused.py, launched from fused_rk4):
// the 2D covector target's four RK4 stages and its endpoint (value,
// Jacobian) in ONE launch instead of five field evaluations, each with
// its own sort, padding, tile mask and launch.
//
//   stage 0..3: v_s = u(p_s) with p_0 = x, p_1 = x + dt/2 v_0,
//               p_2 = x + dt/2 v_1, p_3 = x + dt v_2
//   phi = x + dt/6 (v_0 + 2 v_1 + 2 v_2 + v_3)
//   stage 4:    (u, du/dx) at phi
//
// u is the clamp-subtracted Gaussian sum of gsr_tile.cuh (g >= clamp;
// dead and padded Gaussian rows carry the +1e9 bias).
//
// What bounds it on an H100. At Karman width (B = 512 queries, N = 24,576
// Gaussian rows) the five stages hold 5 x 512 x 24,576 = 6.3e7 pairs, of
// which ~7e4 lie in the support: a few MFLOP and under 1 MB of inputs, so
// the bound is microseconds, and what the kernel pays is the pairs it
// walks and the latency of its stages. A start-position tile mask would
// not be exact for the drifted stage positions (the TPU kernel visits
// every tile at every stage), but a box test at each stage's OWN positions
// is: ~3.5% of the (query tile, Gaussian tile) pairs meet there. So a
// block owns a query tile of TB = 8 queries, FWD_SLOTS threads each (the
// staged forward's block), and at each stage
//   1. writes the tile's stage positions to shared memory and takes their
//      box;
//   2. compacts the Gaussian tiles whose boxes (field.gaussian_tile_boxes:
//      every live row dilated by its radius) meet it (BoxTiles);
//   3. walks them through the staged, per-pair box-tested sweep of the
//      forward (gsr_tile.cuh fwd_sweep), sums in registers;
//   4. meets each query's sums in one fixed butterfly and, split, the S
//      ranks' in rank order through distributed shared memory, which every
//      rank reads alike;
//   5. forms the next stage position in every thread, as the plain twin's
//      recurrence (v0 + 2 v1 + 2 v2 summed left to right, then dt/6).
// Both box tests skip only pairs with g < clamp however f32 rounds (the
// margin of ops/field.py row_radius), so the kernel computes the plain
// twin's function, which reads no box. 64 query tiles at Karman fill few
// of the 132 SMs, so S blocks of a cluster share a query tile along the
// Gaussian axis (ops/rk4_fused.py picks S). One owner per output, no
// atomics, a fixed order: two launches on the same inputs are bitwise
// equal, and the kernel is correct in any query order (only its speed
// depends on how compact the query tiles are).

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

template <int D>
__global__ void __launch_bounds__(FWD_THREADS)
rk4_fused_kernel(const float* __restrict__ x, const float* __restrict__ muT,
                 const float* __restrict__ ppT,
                 const float* __restrict__ rad, const float* __restrict__ v,
                 const float* __restrict__ tlo,
                 const float* __restrict__ thi, float* __restrict__ phi_out,
                 float* __restrict__ vj_out, int N, int njac, float dt,
                 float clamp) {
  namespace cg = cooperative_groups;
  constexpr int VDIM = D;
  constexpr int NACC = (1 + D) * VDIM;
  __shared__ __align__(16) FwdSmem<D, VDIM> sm;
  __shared__ float pos[TB][D];
  __shared__ float red[2][TB][NACC];   // a stage's partial sums, by parity
  const int tid = threadIdx.x, lane = tid & 31;
  const int slot = tid % FWD_SLOTS, q = tid / FWD_SLOTS;
  const int b = blockIdx.x * TB + q;
  const int s = blockIdx.y, S = gridDim.y;
  const Stager<D, VDIM, FWD_THREADS> st(muT, ppT, rad, v, N);
  BoxTiles<D> src{tlo, thi, N / TN};
  float x0[D], p[D], vsum[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x0[k] = x[b * D + k];
    p[k] = x0[k];
    vsum[k] = 0.f;
  }
#pragma unroll 1
  for (int stage = 0; stage < 5; ++stage) {
    const int nj = stage == 4 ? njac : 0;
    const int nacc = (1 + nj) * VDIM;
    // the tile's box at this stage's positions (the sweep's barriers lie
    // between these reads and the next stage's writes)
    if (slot == 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) pos[q][k] = p[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float lo = pos[0][k], hi = lo;
#pragma unroll
      for (int r = 1; r < TB; ++r) {
        lo = fminf(lo, pos[r][k]);
        hi = fmaxf(hi, pos[r][k]);
      }
      src.qlo[k] = lo;
      src.qhi[k] = hi;
    }
    float tot[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) tot[k] = 0.f;
    fwd_sweep<D, VDIM>(src, p, st, nj, clamp, sm, tot);
    // the query's FWD_SLOTS partial sums, one fixed butterfly tree: every
    // slot holds the same sums (a + b == b + a)
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      if (k < nacc) {
        for (int off = FWD_SLOTS / 2; off > 0; off >>= 1)
          tot[k] += __shfl_xor_sync(0xffffffffu, tot[k], off);
      }
    }
    // the ranks' sums in rank order, read alike by every rank (slot 0,
    // then handed to the query's other slots); the buffers alternate, so
    // a rank writes the next stage's while another still reads this one's
    if (S > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* r = red[stage & 1][q];
      if (slot == 0) {
#pragma unroll
        for (int k = 0; k < NACC; ++k)
          if (k < nacc) r[k] = tot[k];
      }
      cluster.sync();
      if (slot == 0) {
        const float* o = cluster.map_shared_rank(r, 0);
#pragma unroll
        for (int k = 0; k < NACC; ++k)
          if (k < nacc) tot[k] = o[k];
        for (int rr = 1; rr < S; ++rr) {
          o = cluster.map_shared_rank(r, rr);
#pragma unroll
          for (int k = 0; k < NACC; ++k)
            if (k < nacc) tot[k] += o[k];
        }
      }
#pragma unroll
      for (int k = 0; k < NACC; ++k)
        tot[k] = __shfl_sync(0xffffffffu, tot[k], lane & ~(FWD_SLOTS - 1));
    }
    if (stage < 3) {
      // v0 + 2 v1 + 2 v2, summed left to right as the plain twin does
      const float h = stage == 2 ? dt : 0.5f * dt;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        vsum[k] = stage == 0 ? tot[k] : vsum[k] + 2.f * tot[k];
        p[k] = x0[k] + h * tot[k];
      }
    } else if (stage == 3) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        p[k] = x0[k] + dt / 6.f * (vsum[k] + tot[k]);
      if (s == 0 && slot == 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) phi_out[b * D + k] = p[k];
      }
    } else if (s == 0 && slot == 0) {
#pragma unroll
      for (int k = 0; k < NACC; ++k)
        if (k < nacc) vj_out[b * nacc + k] = tot[k];
    }
  }
  // every rank's last sums stay until the other ranks read them
  if (S > 1) cg::this_cluster().sync();
}

template <int D>
int launch(const float* x, const float* mu, const float* pp,
           const float* rad, const float* v, const float* lo,
           const float* hi, float* phi, float* vj, int B, int N, int njac,
           float dt, float clamp, int S, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / TB, S);
  cfg.blockDim = dim3(FWD_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = S;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, rk4_fused_kernel<D>, x,
                                            mu, pp, rad, v, lo, hi, phi, vj,
                                            N, njac, dt, clamp);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace

extern "C" {

int rk4_tile_sizes(int* tb, int* tn) {
  *tb = TB;
  *tn = TN;
  return 0;
}

// phi (B, d) and valjac (B, (1 + njac) d) for queries x (B, d; B a
// multiple of TB) through the velocity field (muT (d, N), ppT (np, N),
// v (N, d); N a multiple of TN), rad (N) the rows' dilated radii, lo and
// hi (d, N / TN) the Gaussian tiles' boxes; dt may be negative. S in 1,
// 2, 4, 8 blocks a cluster share a query tile; anything else is refused.
int rk4_fused(const void* x, const void* muT, const void* ppT,
              const void* rad, const void* v, const void* lo,
              const void* hi, void* phi, void* valjac, int B, int N, int d,
              int njac, float dt, float clamp, int S, void* stream) {
  if (B < 0 || N < 0 || B % TB || N % TN || (d != 2 && d != 3) ||
      (njac != 0 && njac != d) || bad_split(1, S))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* mu = static_cast<const float*>(muT);
  const auto* pp = static_cast<const float*>(ppT);
  const auto* rr = static_cast<const float*>(rad);
  const auto* vv = static_cast<const float*>(v);
  const auto* tl = static_cast<const float*>(lo);
  const auto* th = static_cast<const float*>(hi);
  auto* ph = static_cast<float*>(phi);
  auto* vj = static_cast<float*>(valjac);
  return d == 2 ? launch<2>(xx, mu, pp, rr, vv, tl, th, ph, vj, B, N, njac,
                            dt, clamp, S, s)
                : launch<3>(xx, mu, pp, rr, vv, tl, th, ph, vj, B, N, njac,
                            dt, clamp, S, s);
}

}  // extern "C"
