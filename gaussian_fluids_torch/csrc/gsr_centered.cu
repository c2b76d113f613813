// Centered Gaussian-splatting field kernels for Hopper (sm_90a), d = 2.
//
// Replaces three Pallas TPU kernels of the JAX package
// (gaussian_fluids_tpu/ops/pallas/gsr_centered.py):
//   gsr_fwd_kernel     <- _fwd_kernel      (launched from _fwd)
//   gsr_bwd_dn_kernel  <- _bwd_dn_kernel   (launched from _bwd)
//                         _bwd_dn2_kernel  (launched from
//                                           fused_gsr_centered_bwd2)
//
// Math (the TPU kernels' _tile_quantities, all f32 on the CUDA cores):
//   delta = x - mu;  Pd_k = sum_j P_kj delta_j;  quad = delta.Pd + bias
//   g = exp(-quad / 2);  m = g >= clamp
//   val   += m (g - c) v          jac_k += -m g Pd_k v
// The quadratic form is CENTERED: the expanded form x'Px - 2x'P mu + mu'P mu
// cancels O(1e3) terms to O(1) (docs/KERNELS.md). Dead and padded rows
// carry a +1e9 bias so g underflows to exactly 0.
//
// Layout: x (B, 2); muT (2, N); ppT (4, N) = rows P00, P11, P01, bias;
// v (N, vdim); tmask (B/TB, N/TN) int32, 0 = the tile pair cannot
// interact and is skipped. Forward output (B, (1+njac) vdim) =
// [val | jac_0 | jac_1]. Backward outputs dmp (6, N) = rows dmu0, dmu1,
// dP00, dP11, dP01, dbias and dv (N, vdim).
//
// What bounds them on an H100: at the Leapfrog-2D shapes (B = 512,
// N = 5120) the live tile pairs hold ~1e6 query-Gaussian pairs, a few tens
// of MFLOP and under 200 KB of input, so neither the 67 TFLOP/s f32 rate
// nor the 3.35 TB/s memory rate binds: launch latency and the serial
// per-thread loop do. The design therefore maximises independent threads
// at these small shapes: the forward gives every query its own warp, whose
// 32 lanes split the Gaussians of each live tile; the backward gives every
// Gaussian its own thread, which walks the live query tiles in order.
// No atomics: each output element has exactly one owner thread (backward)
// or one fixed shuffle tree (forward), so sums are deterministic, as the
// TPU kernels' sequential grid reductions are.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 8;   // queries per tile: one warp each in the forward
constexpr int TN = 64;  // Gaussians per tile: one thread each in backward
constexpr int D = 2;
constexpr int NP = 4;   // packed precision rows (P00, P11, P01, bias)
constexpr int NMP = D + NP;

struct Geom {
  float dx0, dx1, pd0, pd1, g;
};

__device__ __forceinline__ Geom centered(float x0, float x1, float mu0,
                                         float mu1, float p00, float p11,
                                         float p01, float bias) {
  Geom q;
  q.dx0 = x0 - mu0;
  q.dx1 = x1 - mu1;
  q.pd0 = p00 * q.dx0 + p01 * q.dx1;
  q.pd1 = p11 * q.dx1 + p01 * q.dx0;
  float quad = bias + q.dx0 * q.pd0;
  quad += q.dx1 * q.pd1;
  q.g = expf(-0.5f * quad);
  return q;
}

template <int VDIM>
__global__ void __launch_bounds__(32 * TB)
gsr_fwd_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
               const float* __restrict__ muT, const float* __restrict__ ppT,
               const float* __restrict__ v, float* __restrict__ out, int N,
               int njac, float clamp) {
  const int nnt = N / TN;
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int b = i * TB + threadIdx.y;
  const float x0 = x[2 * b], x1 = x[2 * b + 1];
  float acc[3 * VDIM];
#pragma unroll
  for (int k = 0; k < 3 * VDIM; ++k) acc[k] = 0.f;

  for (int j = 0; j < nnt; ++j) {
    if (tmask[i * nnt + j] == 0) continue;
    for (int n = j * TN + lane; n < (j + 1) * TN; n += 32) {
      const Geom q = centered(x0, x1, muT[n], muT[N + n], ppT[n],
                              ppT[N + n], ppT[2 * N + n], ppT[3 * N + n]);
      if (q.g >= clamp) {
        const float gc = q.g - clamp;
#pragma unroll
        for (int a = 0; a < VDIM; ++a) {
          const float va = v[n * VDIM + a];
          acc[a] += gc * va;
          if (njac) {
            acc[VDIM + a] += -q.g * q.pd0 * va;
            acc[2 * VDIM + a] += -q.g * q.pd1 * va;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3 * VDIM; ++k)
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  if (lane == 0) {
    const int cols = (1 + njac) * VDIM;
    for (int k = 0; k < cols; ++k) out[b * cols + k] = acc[k];
  }
}

// One cotangent block's contribution of query b to Gaussian n, given the
// shared geometry q (with g >= clamp). Mirrors _bwd_cotangents and
// _dn_accumulate of the TPU kernels.
template <int VDIM>
__device__ __forceinline__ void dn_accumulate(
    const Geom& q, const float* __restrict__ dout_row, const float* vv,
    float p00, float p11, float p01, int njac, int use_val, float clamp,
    float* accm, float* accv) {
  float s2_0 = 0.f, s2_1 = 0.f;
  if (njac) {
#pragma unroll
    for (int a = 0; a < VDIM; ++a) {
      s2_0 += dout_row[VDIM + a] * vv[a];
      s2_1 += dout_row[2 * VDIM + a] * vv[a];
    }
  }
  float gg;
  if (use_val) {
    float s1 = 0.f;
#pragma unroll
    for (int a = 0; a < VDIM; ++a) s1 += dout_row[a] * vv[a];
    gg = s1;
    if (njac) {
      gg -= s2_0 * q.pd0;
      gg -= s2_1 * q.pd1;
    }
  } else {
    gg = -s2_0 * q.pd0;
    gg -= s2_1 * q.pd1;
  }
  const float gquad = -0.5f * q.g * gg;
  const float gpd0 = -q.g * s2_0, gpd1 = -q.g * s2_1;

#pragma unroll
  for (int a = 0; a < VDIM; ++a) {
    float t = 0.f;
    if (use_val) t += (q.g - clamp) * dout_row[a];
    if (njac) {
      t += -q.g * q.pd0 * dout_row[VDIM + a];
      t += -q.g * q.pd1 * dout_row[2 * VDIM + a];
    }
    accv[a] += t;
  }
  float t0 = gquad * (2.f * q.pd0), t1 = gquad * (2.f * q.pd1);
  float r0 = gquad * q.dx0 * q.dx0, r1 = gquad * q.dx1 * q.dx1;
  float r2 = 2.f * gquad * q.dx0 * q.dx1;
  if (njac) {
    t0 += gpd0 * p00 + gpd1 * p01;
    t1 += gpd1 * p11 + gpd0 * p01;
    r0 += gpd0 * q.dx0;
    r1 += gpd1 * q.dx1;
    r2 += gpd0 * q.dx1 + gpd1 * q.dx0;
  }
  accm[0] -= t0;
  accm[1] -= t1;
  accm[2] += r0;
  accm[3] += r1;
  accm[4] += r2;
  accm[5] += gquad;
}

template <int VDIM, int NCOT>
__global__ void __launch_bounds__(TN)
gsr_bwd_dn_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                  const float* __restrict__ muT,
                  const float* __restrict__ ppT, const float* __restrict__ v,
                  const float* __restrict__ dout1,
                  const float* __restrict__ dout2, float* __restrict__ dmp1,
                  float* __restrict__ dv1, float* __restrict__ dmp2,
                  float* __restrict__ dv2, int B, int N, int njac,
                  int use_val, float clamp) {
  const int nbt = B / TB, nnt = N / TN;
  const int j = blockIdx.x;
  const int n = j * TN + threadIdx.x;
  const int cols = (1 + njac) * VDIM;
  const float mu0 = muT[n], mu1 = muT[N + n];
  const float p00 = ppT[n], p11 = ppT[N + n], p01 = ppT[2 * N + n];
  const float bias = ppT[3 * N + n];
  float vv[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) vv[a] = v[n * VDIM + a];
  float accm[NCOT][NMP];
  float accv[NCOT][VDIM];
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
#pragma unroll
    for (int k = 0; k < NMP; ++k) accm[c][k] = 0.f;
#pragma unroll
    for (int a = 0; a < VDIM; ++a) accv[c][a] = 0.f;
  }

  for (int i = 0; i < nbt; ++i) {
    if (tmask[i * nnt + j] == 0) continue;
    for (int r = 0; r < TB; ++r) {
      const int b = i * TB + r;
      const Geom q = centered(x[2 * b], x[2 * b + 1], mu0, mu1, p00, p11,
                              p01, bias);
      // every term carries the mask m = g >= clamp
      if (!(q.g >= clamp)) continue;
      dn_accumulate<VDIM>(q, dout1 + b * cols, vv, p00, p11, p01, njac,
                          use_val, clamp, accm[0], accv[0]);
      if (NCOT == 2)
        dn_accumulate<VDIM>(q, dout2 + b * cols, vv, p00, p11, p01, njac,
                            use_val, clamp, accm[NCOT - 1],
                            accv[NCOT - 1]);
    }
  }
#pragma unroll
  for (int c = 0; c < NCOT; ++c) {
    float* dmp = c == 0 ? dmp1 : dmp2;
    float* dv = c == 0 ? dv1 : dv2;
#pragma unroll
    for (int k = 0; k < NMP; ++k) dmp[k * N + n] = accm[c][k];
#pragma unroll
    for (int a = 0; a < VDIM; ++a) dv[n * VDIM + a] = accv[c][a];
  }
}

bool bad_shape(int B, int N, int vdim, int njac) {
  return B < 0 || N < 0 || B % TB || N % TN || (vdim != 1 && vdim != 2) ||
         (njac != 0 && njac != D);
}

template <int NCOT>
int launch_bwd(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout1,
               const void* dout2, void* dmp1, void* dv1, void* dmp2,
               void* dv2, int B, int N, int vdim, int njac, int use_val,
               float clamp, void* stream) {
  if (bad_shape(B, N, vdim, njac) || (!use_val && njac == 0))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / TN), block(TN);
  const int* tm = static_cast<const int*>(tmask);
  const float* xf = static_cast<const float*>(x);
  const float* mu = static_cast<const float*>(muT);
  const float* pp = static_cast<const float*>(ppT);
  const float* vf = static_cast<const float*>(v);
  const float* d1 = static_cast<const float*>(dout1);
  const float* d2 = static_cast<const float*>(dout2);
  float* m1 = static_cast<float*>(dmp1);
  float* v1 = static_cast<float*>(dv1);
  float* m2 = static_cast<float*>(dmp2);
  float* v2 = static_cast<float*>(dv2);
  if (vdim == 1)
    gsr_bwd_dn_kernel<1, NCOT><<<grid, block, 0, s>>>(
        tm, xf, mu, pp, vf, d1, d2, m1, v1, m2, v2, B, N, njac, use_val,
        clamp);
  else
    gsr_bwd_dn_kernel<2, NCOT><<<grid, block, 0, s>>>(
        tm, xf, mu, pp, vf, d1, d2, m1, v1, m2, v2, B, N, njac, use_val,
        clamp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The compiled tile sizes, so the Python side can refuse a tile mask
// built for other tiles.
int gsr_tile_sizes(int* tb, int* tn) {
  *tb = TB;
  *tn = TN;
  return 0;
}

int gsr_fwd(const void* tmask, const void* x, const void* muT,
            const void* ppT, const void* v, void* out, int B, int N,
            int vdim, int njac, float clamp, void* stream) {
  if (bad_shape(B, N, vdim, njac)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B / TB), block(32, TB);
  const int* tm = static_cast<const int*>(tmask);
  const float* xf = static_cast<const float*>(x);
  const float* mu = static_cast<const float*>(muT);
  const float* pp = static_cast<const float*>(ppT);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (vdim == 1)
    gsr_fwd_kernel<1><<<grid, block, 0, s>>>(tm, xf, mu, pp, vf, o, N, njac,
                                             clamp);
  else
    gsr_fwd_kernel<2><<<grid, block, 0, s>>>(tm, xf, mu, pp, vf, o, N, njac,
                                             clamp);
  return cudaGetLastError();
}

int gsr_bwd_dn(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout, void* dmp,
               void* dv, int B, int N, int vdim, int njac, int use_val,
               float clamp, void* stream) {
  return launch_bwd<1>(tmask, x, muT, ppT, v, dout, dout, dmp, dv, dmp, dv,
                       B, N, vdim, njac, use_val, clamp, stream);
}

int gsr_bwd_dn2(const void* tmask, const void* x, const void* muT,
                const void* ppT, const void* v, const void* dout1,
                const void* dout2, void* dmp1, void* dv1, void* dmp2,
                void* dv2, int B, int N, int vdim, int njac, int use_val,
                float clamp, void* stream) {
  return launch_bwd<2>(tmask, x, muT, ppT, v, dout1, dout2, dmp1, dv1, dmp2,
                       dv2, B, N, vdim, njac, use_val, clamp, stream);
}

}  // extern "C"
