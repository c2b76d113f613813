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
// dead and padded Gaussian rows carry the +1e9 bias). There is no tile
// mask: the stage positions drift from the start positions, so every
// Gaussian is visited at every stage, as the TPU kernel does.
//
// What bounds it on an H100. At Karman width (B = 512 queries, N = 24,576
// Gaussian rows) a launch evaluates 5 x 512 x 24,576 = 6.3e7 pairs of ~20
// operations of geometry each: ~1.3e9 operations, ~0.02 ms at the f32
// peak; the inputs are under 1 MB. So it is bound by operations, and by
// how many of them run in parallel: 512 queries alone would give 512
// warps, too few for 132 SMs. The design gives every query a block of
// 256 threads that split the Gaussian axis (consecutive threads read
// consecutive Gaussians); each stage's sums go through a fixed shuffle
// tree per warp and then the 8 warps' partial sums in warp order, so the
// result is deterministic, and every thread of the block then holds the
// next stage position in registers. A query's stages depend only on its
// own sums: no grid-wide synchronisation.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

constexpr int RK4_THREADS = 256;
constexpr int RK4_WARPS = RK4_THREADS / 32;

template <int D>
__global__ void __launch_bounds__(RK4_THREADS)
rk4_fused_kernel(const float* __restrict__ x, const float* __restrict__ muT,
                 const float* __restrict__ ppT, const float* __restrict__ v,
                 float* __restrict__ phi_out, float* __restrict__ vj_out,
                 int N, int njac, float dt, float clamp) {
  constexpr int VDIM = D;
  constexpr int NACC = (1 + D) * VDIM;
  __shared__ float red[RK4_WARPS][NACC];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x0[D], p[D], vsum[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x0[k] = x[b * D + k];
    p[k] = x0[k];
    vsum[k] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < 5; ++s) {
    const bool jac = s == 4 && njac;
    const int nacc = jac ? NACC : VDIM;
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    for (int n = tid; n < N; n += RK4_THREADS) {
      const Geom<D> q = centered<D>(p, load_gauss<D>(muT, ppT, N, n));
      if (q.g >= clamp) {
        const float gc = q.g - clamp;
#pragma unroll
        for (int a = 0; a < VDIM; ++a) {
          const float va = v[n * VDIM + a];
          acc[a] += gc * va;
          if (jac) {
#pragma unroll
            for (int k = 0; k < D; ++k)
              acc[(1 + k) * VDIM + a] += -q.g * q.pd[k] * va;
          }
        }
      }
    }
    // the block's sums: a fixed shuffle tree per warp, then the warps in
    // order; every thread reads the same totals
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      if (k < nacc) {
        for (int off = 16; off > 0; off >>= 1)
          acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
        if (lane == 0) red[warp][k] = acc[k];
      }
    }
    __syncthreads();
    float tot[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      tot[k] = 0.f;
      if (k < nacc) {
        tot[k] = red[0][k];
#pragma unroll
        for (int w = 1; w < RK4_WARPS; ++w) tot[k] += red[w][k];
      }
    }
    __syncthreads();   // red is rewritten by the next stage
    if (s < 3) {
      // v0 + 2 v1 + 2 v2, summed left to right as the reference does
      const float h = s == 2 ? dt : 0.5f * dt;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        vsum[k] = s == 0 ? tot[k] : vsum[k] + 2.f * tot[k];
        p[k] = x0[k] + h * tot[k];
      }
    } else if (s == 3) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        p[k] = x0[k] + dt / 6.f * (vsum[k] + tot[k]);
      if (tid == 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) phi_out[b * D + k] = p[k];
      }
    } else if (tid == 0) {
      const int cols = (1 + njac) * VDIM;
      for (int k = 0; k < cols; ++k) vj_out[b * cols + k] = tot[k];
    }
  }
}

}  // namespace

extern "C" {

// phi (B, d) and valjac (B, (1 + njac) d) for queries x (B, d) through the
// velocity field (muT (d, N), ppT (np, N), v (N, d)); dt may be negative.
int rk4_fused(const void* x, const void* muT, const void* ppT, const void* v,
              void* phi, void* valjac, int B, int N, int d, int njac,
              float dt, float clamp, void* stream) {
  if (B < 0 || N < 0 || (d != 2 && d != 3) || (njac != 0 && njac != d))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* mu = static_cast<const float*>(muT);
  const auto* pp = static_cast<const float*>(ppT);
  const auto* vv = static_cast<const float*>(v);
  auto* ph = static_cast<float*>(phi);
  auto* vj = static_cast<float*>(valjac);
  if (d == 2)
    rk4_fused_kernel<2><<<B, RK4_THREADS, 0, s>>>(xx, mu, pp, vv, ph, vj, N,
                                                 njac, dt, clamp);
  else
    rk4_fused_kernel<3><<<B, RK4_THREADS, 0, s>>>(xx, mu, pp, vv, ph, vj, N,
                                                 njac, dt, clamp);
  return cudaGetLastError();
}

}  // extern "C"
