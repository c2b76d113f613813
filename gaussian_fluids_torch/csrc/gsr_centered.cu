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
// 3.35 TB/s memory rate binds: launch latency and the chains of
// dependent loads do. In 3D at Ring-Collide width (N = 75,776) the
// forward serves the evaluations with a Jacobian on the 128^3 test grid,
// in chunks of 32,768 queries: ~10% of the tile pairs are live, ~2.5e8
// pairs a chunk, of which ~1% have the query inside the Gaussian's
// support box. The designs keep every sum in registers and give the
// chains independent threads:
// - the forward (row 1) is the cells forward's staged walk over the
//   tile's mask row (gsr_tile.cuh fwd_walk): each live Gaussian tile
//   staged in shared memory once per block, every pair box-tested on the
//   row's dilated radius before its geometry, FWD_SLOTS threads a query;
//   where the query tiles are too few to fill the card (Leapfrog-2D: 64
//   blocks for 132 SMs) S blocks of a cluster share a query tile along
//   the Gaussian axis (ops/gsr_centered.py fwd_split picks S from the
//   shape and the SM count);
// - the parameter backwards (rows 2 and 3) give every Gaussian W x S
//   threads, W in one block and S blocks of a cluster, each walking an
//   equal share of the Gaussian tile's compacted live query tiles. One
//   thread a Gaussian filled 16 blocks of the 132 SMs at Leapfrog-3D
//   (N = 1024, B = 8192), each thread walking ~500 query tiles in a chain
//   of global loads; the split puts 64 threads on each Gaussian there
//   (bwd_split picks W and S).
// No atomics: each output element has exactly one owner thread, which
// adds the split's partial sums in a fixed order after one fixed shuffle
// tree (forward) or worker by worker (backward), so sums are
// deterministic, as the TPU kernels' sequential grid reductions are.
//
// The two backwards that no training epoch runs keep their owners.
// dL/dx (gsr_bwd_dx_kernel) gives every query a warp, its lanes
// splitting each live Gaussian tile, one fixed shuffle tree at the end;
// per pair it recomputes the geometry and the cotangents of the
// parameter backward. The triple backward (gsr_bwd_dn3_kernel, the fused
// [data; boundary] projection geometry) gives every Gaussian one thread,
// which walks every live query tile in order (bwd_tile), with three
// accumulator blocks: query tiles below
// data_tiles feed blocks 1 and 2 (the dual backward's tile step), the
// boundary tiles after them feed block 3 with a value-only cotangent.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

// Row 1: query tile i's block (rank s of a cluster of S along y) walks
// the tile's row of the mask through the staged forward (gsr_tile.cuh
// fwd_walk, the cells forward's body).
template <int D, int VDIM>
__global__ void __launch_bounds__(FWD_THREADS)
gsr_fwd_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
               const float* __restrict__ muT, const float* __restrict__ ppT,
               const float* __restrict__ rad, const float* __restrict__ v,
               float* __restrict__ out, int N, int njac, float clamp) {
  __shared__ __align__(16) FwdSmem<D, VDIM> sm;
  const int i = blockIdx.x, nnt = N / TN;
  const LiveTiles<false> src{nullptr, nullptr, 0, 0, i, tmask + i * nnt, 1,
                             nnt, false};
  fwd_walk<D, VDIM>(src, i, x, muT, ppT, rad, v, out, N, njac, clamp, sm);
}

// The split parameter backward (rows 2 and 3) compacts LIST_CAP query
// tiles at once.
constexpr int LIST_CAP = 4096;

// Dynamic shared memory of one block: the compacted list, the warps'
// counts, and one slot of TN x dn_sums partial sums.
template <int D, int VDIM, int NCOT>
size_t dn_smem_bytes() {
  return sizeof(float) *
         (LIST_CAP + MAX_W * TN / 32 + dn_sums<D, VDIM, NCOT>() * TN);
}

// Rows 2 and 3. Block (j, s) of a cluster of S along y: Gaussian tile j,
// split rank s. Thread (g, w) owns Gaussian j TN + g for worker u = s W +
// w of U = W S. Each block compacts column j of the tile mask (LIST_CAP
// query tiles at a time, in order) and worker u walks the u-th of U equal
// contiguous shares of the live list, reading each tile's rows where they
// lie (staging them in shared memory by cp.async did not pay). The sums
// meet in one fixed order (gsr_tile.cuh dn_meet_store).
template <int D, int VDIM, int NCOT>
__global__ void __launch_bounds__(TN * MAX_W)
gsr_bwd_dn_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                  const float* __restrict__ muT,
                  const float* __restrict__ ppT, const float* __restrict__ v,
                  const float* __restrict__ dout1,
                  const float* __restrict__ dout2, float* __restrict__ dmp1,
                  float* __restrict__ dv1, float* __restrict__ dmp2,
                  float* __restrict__ dv2, int B, int N, int njac,
                  int use_val, float clamp) {
  constexpr int NMP = Dims<D>::NMP;
  extern __shared__ float smem[];
  int* list = reinterpret_cast<int*>(smem);
  int* wcount = list + LIST_CAP;
  float* red = smem + LIST_CAP + MAX_W * TN / 32;
  const int nbt = B / TB, nnt = N / TN;
  const int W = blockDim.x / TN, S = gridDim.y;
  const int g = threadIdx.x % TN, w = threadIdx.x / TN;
  const int s = blockIdx.y, j = blockIdx.x;
  const int U = W * S, u = s * W + w;
  const int n = j * TN + g;
  const int cols = (1 + njac) * VDIM;

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

  for (int base = 0; base < nbt; base += LIST_CAP) {
    const int nwin = min(LIST_CAP, nbt - base);
    int live = 0;
    for (int c = 0; c < nwin; c += blockDim.x) {
      const int i = base + c + threadIdx.x;
      const bool f = c + threadIdx.x < nwin && tmask[i * nnt + j] != 0;
      live += compact_warps(f, i, list + live, wcount, blockDim.x / 32);
    }
    const int lo = static_cast<int>(static_cast<long long>(u) * live / U);
    const int hi = static_cast<int>(static_cast<long long>(u + 1) * live / U);
    for (int m = lo; m < hi; ++m) {
      const int i = list[m];
      const float* xt = x + i * TB * D;
      dn_tile<D, VDIM, NCOT, false>(xt, xt, dout1 + i * TB * cols,
                                    dout2 + i * TB * cols, cols, G, 0.f, vv,
                                    njac, use_val, clamp, accm, accv);
    }
    __syncthreads();   // the next window refills the list
  }

  dn_meet_store<D, VDIM, NCOT>(red, g, w, W, s, S, n, N, accm, accv, dmp1,
                               dv1, dmp2, dv2);
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
  const float *x, *mu, *pp, *rad, *v;
  float* out;
  int B, N, njac, S;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B / TB, S);
    cfg.blockDim = dim3(FWD_THREADS);
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = S;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, gsr_fwd_kernel<D, VDIM>, tm, x, mu, pp, rad, v, out, N, njac,
        clamp);
    return rc != cudaSuccess ? rc : cudaGetLastError();
  }
};

template <int NCOT>
struct BwdLaunch {
  const int* tm;
  const float *x, *mu, *pp, *v, *d1, *d2;
  float *m1, *v1, *m2, *v2;
  int B, N, njac, use_val, W, S;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N / TN, S);
    cfg.blockDim = dim3(TN * W);
    cfg.dynamicSmemBytes = dn_smem_bytes<D, VDIM, NCOT>();
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = S;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, gsr_bwd_dn_kernel<D, VDIM, NCOT>, tm, x, mu, pp, v, d1, d2, m1,
        v1, m2, v2, B, N, njac, use_val, clamp);
    return rc != cudaSuccess ? rc : cudaGetLastError();
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
               int use_val, float clamp, int W, int S, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || (!use_val && njac == 0) ||
      bad_split(W, S))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const BwdLaunch<NCOT> f{
      static_cast<const int*>(tmask),   static_cast<const float*>(x),
      static_cast<const float*>(muT),   static_cast<const float*>(ppT),
      static_cast<const float*>(v),     static_cast<const float*>(dout1),
      static_cast<const float*>(dout2), static_cast<float*>(dmp1),
      static_cast<float*>(dv1),         static_cast<float*>(dmp2),
      static_cast<float*>(dv2),         B, N, njac, use_val, W, S, clamp,
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

// The forward split S ways along the Gaussian axis (S in 1, 2, 4, 8
// blocks a cluster; anything else is refused), rad the rows' dilated radii
// of the box test.
int gsr_fwd(const void* tmask, const void* x, const void* muT,
            const void* ppT, const void* rad, const void* v, void* out,
            int B, int N, int d, int vdim, int njac, float clamp, int S,
            void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || bad_split(1, S))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const FwdLaunch f{static_cast<const int*>(tmask),
                    static_cast<const float*>(x),
                    static_cast<const float*>(muT),
                    static_cast<const float*>(ppT),
                    static_cast<const float*>(rad),
                    static_cast<const float*>(v),
                    static_cast<float*>(out),
                    B, N, njac, S, clamp,
                    static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

// The parameter backwards split W x S ways along the query axis (W in
// 1, 2, 4, 8 workers a block, S in 1, 2, 4, 8 blocks a cluster; anything
// else is refused).
int gsr_bwd_dn(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout, void* dmp,
               void* dv, int B, int N, int d, int vdim, int njac,
               int use_val, float clamp, int W, int S, void* stream) {
  return launch_bwd<1>(tmask, x, muT, ppT, v, dout, dout, dmp, dv, dmp, dv,
                       B, N, d, vdim, njac, use_val, clamp, W, S, stream);
}

int gsr_bwd_dn2(const void* tmask, const void* x, const void* muT,
                const void* ppT, const void* v, const void* dout1,
                const void* dout2, void* dmp1, void* dv1, void* dmp2,
                void* dv2, int B, int N, int d, int vdim, int njac,
                int use_val, float clamp, int W, int S, void* stream) {
  return launch_bwd<2>(tmask, x, muT, ppT, v, dout1, dout2, dmp1, dv1, dmp2,
                       dv2, B, N, d, vdim, njac, use_val, clamp, W, S,
                       stream);
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
