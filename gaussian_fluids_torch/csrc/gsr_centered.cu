// Centered Gaussian-splatting field kernels for Hopper (sm_90a): the
// tile-masked sweep, d = 2 and 3, vdim = 1, 2, 3.
//
// Replaces five Pallas TPU kernels of the JAX package
// (gaussian_fluids_tpu/ops/pallas/gsr_centered.py):
//   gsr_fwd_kernel     <- _fwd_kernel      (launched from _fwd)
//   gsr_bwd_dn_kernel  <- _bwd_dn_kernel   (launched from _bwd)
//                         _bwd_dn2_kernel  (launched from
//                                           fused_gsr_centered_bwd2)
//   gsr_bwd_dx_kernel  <- _bwd_dx_kernel   (launched from _bwd when the
//                                           query points need a gradient)
//   gsr_bwd_dn3_kernel <- _bwd_dn3_kernel  (launched from
//                                           fused_gsr_centered_bwd3)
// The math and layouts are in gsr_tile.cuh. tmask (B/TB, N/TN) int32:
// 0 = the tile pair cannot interact and is skipped.
//
// What bounds them on an H100. At the Leapfrog-2D shapes (B = 512,
// N = 6144) the live tile pairs hold ~3.5e5 query-Gaussian pairs, a few
// MFLOP and under 1 MB, so neither the 67 TFLOP/s f32 rate nor the
// 3.35 TB/s memory rate binds: launch latency and the serial per-thread
// loop do. In 3D at Ring-Collide width (N = 75,776) these kernels serve
// the evaluations with a Jacobian on the 128^3 test grid, in chunks of
// 32,768 queries: ~10% of the tile pairs are live, ~2.5e8 pairs a chunk,
// ~30 operations each (operations-bound, ~0.1 ms at the f32 peak; the
// inputs are ~4 MB). The design maximises independent threads and keeps
// every sum in registers: the forward gives every query its own warp,
// whose 32 lanes split the Gaussians of each live tile; the backward gives
// every Gaussian its own thread, which walks the live query tiles in
// order. No atomics: each output element has exactly one owner thread
// (backward) or one fixed shuffle tree (forward), so sums are
// deterministic, as the TPU kernels' sequential grid reductions are.
//
// The two backwards that no training epoch runs follow the same owners.
// dL/dx (gsr_bwd_dx_kernel) has the forward's layout: a warp per query,
// its lanes splitting each live Gaussian tile, one fixed shuffle tree at
// the end; per pair it recomputes the geometry and the cotangents of the
// parameter backward. The triple backward (gsr_bwd_dn3_kernel, the fused
// [data; boundary] projection geometry) is the per-Gaussian owner of
// gsr_bwd_dn_kernel with three accumulator blocks: query tiles below
// data_tiles feed blocks 1 and 2 (the dual backward's tile step), the
// boundary tiles after them feed block 3 with a value-only cotangent.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

template <int D, int VDIM>
__global__ void __launch_bounds__(32 * TB)
gsr_fwd_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
               const float* __restrict__ muT, const float* __restrict__ ppT,
               const float* __restrict__ v, float* __restrict__ out, int N,
               int njac, float clamp) {
  const int nnt = N / TN;
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int b = i * TB + threadIdx.y;
  float xq[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];
  float acc[(1 + D) * VDIM];
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k) acc[k] = 0.f;
  for (int j = 0; j < nnt; ++j) {
    if (tmask[i * nnt + j] == 0) continue;
    fwd_tile<D, VDIM>(xq, j, lane, muT, ppT, v, N, njac, clamp, acc);
  }
  fwd_store<D, VDIM>(acc, lane, b, njac, out);
}

template <int D, int VDIM, int NCOT>
__global__ void __launch_bounds__(TN)
gsr_bwd_dn_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                  const float* __restrict__ muT,
                  const float* __restrict__ ppT, const float* __restrict__ v,
                  const float* __restrict__ dout1,
                  const float* __restrict__ dout2, float* __restrict__ dmp1,
                  float* __restrict__ dv1, float* __restrict__ dmp2,
                  float* __restrict__ dv2, int B, int N, int njac,
                  int use_val, float clamp) {
  constexpr int NMP = Dims<D>::NMP;
  const int nbt = B / TB, nnt = N / TN;
  const int j = blockIdx.x;
  const int n = j * TN + threadIdx.x;
  const Gauss<D> G = load_gauss<D>(muT, ppT, N, n);
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
    bwd_tile<D, VDIM, NCOT>(i, x, G, vv, dout1, dout2, njac, use_val, clamp,
                            accm, accv);
  }
  bwd_store<D, VDIM, NCOT>(n, N, accm, accv, dmp1, dv1, dmp2, dv2);
}

template <int D, int VDIM>
__global__ void __launch_bounds__(32 * TB)
gsr_bwd_dx_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                  const float* __restrict__ muT,
                  const float* __restrict__ ppT, const float* __restrict__ v,
                  const float* __restrict__ dout, float* __restrict__ dx,
                  int N, int njac, float clamp) {
  const int nnt = N / TN;
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int b = i * TB + threadIdx.y;
  const int cols = (1 + njac) * VDIM;
  float xq[D], drow[(1 + D) * VDIM];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k)
    drow[k] = k < cols ? dout[b * cols + k] : 0.f;
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;
  for (int j = 0; j < nnt; ++j) {
    if (tmask[i * nnt + j] == 0) continue;
    for (int n = j * TN + lane; n < (j + 1) * TN; n += 32) {
      const Gauss<D> G = load_gauss<D>(muT, ppT, N, n);
      const Geom<D> q = centered<D>(xq, G);
      if (!(q.g >= clamp)) continue;
      float vv[VDIM], s2[D], gpd[D];
#pragma unroll
      for (int a = 0; a < VDIM; ++a) vv[a] = v[n * VDIM + a];
      const float gquad =
          pair_cotangents<D, VDIM>(q, drow, vv, njac, 1, s2, gpd);
#pragma unroll
      for (int k = 0; k < D; ++k)
        acc[k] += pair_dx<D>(q, gquad, gpd, G.p, njac, k);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) dx[b * D + k] = acc[k];
  }
}

template <int D, int VDIM>
__global__ void __launch_bounds__(TN)
gsr_bwd_dn3_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                   const float* __restrict__ muT,
                   const float* __restrict__ ppT, const float* __restrict__ v,
                   const float* __restrict__ dout1,
                   const float* __restrict__ dout2,
                   const float* __restrict__ dout3, float* __restrict__ dmp1,
                   float* __restrict__ dv1, float* __restrict__ dmp2,
                   float* __restrict__ dv2, float* __restrict__ dmp3,
                   float* __restrict__ dv3, int B, int N, int njac,
                   int use_val12, int data_tiles, float clamp) {
  constexpr int NMP = Dims<D>::NMP;
  const int nbt = B / TB, nnt = N / TN;
  const int j = blockIdx.x;
  const int n = j * TN + threadIdx.x;
  const Gauss<D> G = load_gauss<D>(muT, ppT, N, n);
  float vv[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) vv[a] = v[n * VDIM + a];
  float accm[3][NMP];
  float accv[3][VDIM];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < NMP; ++k) accm[c][k] = 0.f;
#pragma unroll
    for (int a = 0; a < VDIM; ++a) accv[c][a] = 0.f;
  }
  for (int i = 0; i < nbt; ++i) {
    if (tmask[i * nnt + j] == 0) continue;
    if (i < data_tiles)
      bwd_tile<D, VDIM, 2>(i, x, G, vv, dout1, dout2, njac, use_val12, clamp,
                           accm, accv);
    else   // boundary rows: a value-only cotangent
      bwd_tile<D, VDIM, 1>(i, x, G, vv, dout3, dout3, 0, 1, clamp, accm + 2,
                           accv + 2);
  }
  bwd_store<D, VDIM, 2>(n, N, accm, accv, dmp1, dv1, dmp2, dv2);
  bwd_store<D, VDIM, 1>(n, N, accm + 2, accv + 2, dmp3, dv3, dmp3, dv3);
}

struct FwdLaunch {
  const int* tm;
  const float *x, *mu, *pp, *v;
  float* out;
  int B, N, njac;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    gsr_fwd_kernel<D, VDIM><<<dim3(B / TB), dim3(32, TB), 0, s>>>(
        tm, x, mu, pp, v, out, N, njac, clamp);
    return cudaGetLastError();
  }
};

template <int NCOT>
struct BwdLaunch {
  const int* tm;
  const float *x, *mu, *pp, *v, *d1, *d2;
  float *m1, *v1, *m2, *v2;
  int B, N, njac, use_val;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    gsr_bwd_dn_kernel<D, VDIM, NCOT><<<dim3(N / TN), dim3(TN), 0, s>>>(
        tm, x, mu, pp, v, d1, d2, m1, v1, m2, v2, B, N, njac, use_val,
        clamp);
    return cudaGetLastError();
  }
};

struct DxLaunch {
  const int* tm;
  const float *x, *mu, *pp, *v, *dout;
  float* dx;
  int B, N, njac;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    gsr_bwd_dx_kernel<D, VDIM><<<dim3(B / TB), dim3(32, TB), 0, s>>>(
        tm, x, mu, pp, v, dout, dx, N, njac, clamp);
    return cudaGetLastError();
  }
};

struct Dn3Launch {
  const int* tm;
  const float *x, *mu, *pp, *v, *d1, *d2, *d3;
  float *m1, *v1, *m2, *v2, *m3, *v3;
  int B, N, njac, use_val12, data_tiles;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    gsr_bwd_dn3_kernel<D, VDIM><<<dim3(N / TN), dim3(TN), 0, s>>>(
        tm, x, mu, pp, v, d1, d2, d3, m1, v1, m2, v2, m3, v3, B, N, njac,
        use_val12, data_tiles, clamp);
    return cudaGetLastError();
  }
};

template <int NCOT>
int launch_bwd(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout1,
               const void* dout2, void* dmp1, void* dv1, void* dmp2,
               void* dv2, int B, int N, int d, int vdim, int njac,
               int use_val, float clamp, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || (!use_val && njac == 0))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const BwdLaunch<NCOT> f{
      static_cast<const int*>(tmask),   static_cast<const float*>(x),
      static_cast<const float*>(muT),   static_cast<const float*>(ppT),
      static_cast<const float*>(v),     static_cast<const float*>(dout1),
      static_cast<const float*>(dout2), static_cast<float*>(dmp1),
      static_cast<float*>(dv1),         static_cast<float*>(dmp2),
      static_cast<float*>(dv2),         B, N, njac, use_val, clamp,
      static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
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
            const void* ppT, const void* v, void* out, int B, int N, int d,
            int vdim, int njac, float clamp, void* stream) {
  if (bad_shape(B, N, d, vdim, njac)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const FwdLaunch f{static_cast<const int*>(tmask),
                    static_cast<const float*>(x),
                    static_cast<const float*>(muT),
                    static_cast<const float*>(ppT),
                    static_cast<const float*>(v),
                    static_cast<float*>(out),
                    B, N, njac, clamp, static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

int gsr_bwd_dn(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout, void* dmp,
               void* dv, int B, int N, int d, int vdim, int njac,
               int use_val, float clamp, void* stream) {
  return launch_bwd<1>(tmask, x, muT, ppT, v, dout, dout, dmp, dv, dmp, dv,
                       B, N, d, vdim, njac, use_val, clamp, stream);
}

int gsr_bwd_dn2(const void* tmask, const void* x, const void* muT,
                const void* ppT, const void* v, const void* dout1,
                const void* dout2, void* dmp1, void* dv1, void* dmp2,
                void* dv2, int B, int N, int d, int vdim, int njac,
                int use_val, float clamp, void* stream) {
  return launch_bwd<2>(tmask, x, muT, ppT, v, dout1, dout2, dmp1, dv1, dmp2,
                       dv2, B, N, d, vdim, njac, use_val, clamp, stream);
}

int gsr_bwd_dx(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout, void* dx,
               int B, int N, int d, int vdim, int njac, float clamp,
               void* stream) {
  if (bad_shape(B, N, d, vdim, njac)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const DxLaunch f{static_cast<const int*>(tmask),
                   static_cast<const float*>(x),
                   static_cast<const float*>(muT),
                   static_cast<const float*>(ppT),
                   static_cast<const float*>(v),
                   static_cast<const float*>(dout),
                   static_cast<float*>(dx),
                   B, N, njac, clamp, static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

// Blocks 1 and 2 on the query tiles below data_rows / TB, block 3 (value
// only, vdim columns) on the rest.
int gsr_bwd_dn3(const void* tmask, const void* x, const void* muT,
                const void* ppT, const void* v, const void* dout1,
                const void* dout2, const void* dout3, void* dmp1, void* dv1,
                void* dmp2, void* dv2, void* dmp3, void* dv3, int B, int N,
                int d, int vdim, int njac, int use_val12, int data_rows,
                float clamp, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || (!use_val12 && njac == 0) ||
      data_rows < 0 || data_rows > B || data_rows % TB)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const Dn3Launch f{
      static_cast<const int*>(tmask),   static_cast<const float*>(x),
      static_cast<const float*>(muT),   static_cast<const float*>(ppT),
      static_cast<const float*>(v),     static_cast<const float*>(dout1),
      static_cast<const float*>(dout2), static_cast<const float*>(dout3),
      static_cast<float*>(dmp1),        static_cast<float*>(dv1),
      static_cast<float*>(dmp2),        static_cast<float*>(dv2),
      static_cast<float*>(dmp3),        static_cast<float*>(dv3),
      B, N, njac, use_val12, data_rows / TB, clamp,
      static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

}  // extern "C"
