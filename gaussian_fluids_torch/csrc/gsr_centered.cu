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
// - the query-side kernels, the forward (row 1) and dL/dx (row 4), run
//   the cells forward's staged sweep over the tile's mask row
//   (gsr_tile.cuh fwd_sweep, with the forward's or dL/dx's pair body):
//   each live Gaussian tile staged in shared memory once per block, every
//   pair box-tested on the row's dilated radius before its geometry,
//   FWD_SLOTS threads a query; where the query tiles are too few to fill
//   the card (Leapfrog-2D and Karman-2D: 64 blocks for 132 SMs) S blocks
//   of a cluster share a query tile along the Gaussian axis
//   (ops/gsr_centered.py fwd_split picks S from the shape and the SM
//   count);
// - the parameter backwards (rows 2, 3 and 10) give every Gaussian W x S
//   threads, W in one block and S blocks of a cluster, each walking an
//   equal share of the Gaussian tile's compacted live query tiles. One
//   thread a Gaussian filled 16 blocks of the 132 SMs at Leapfrog-3D
//   (N = 1024, B = 8192), each thread walking ~500 query tiles in a chain
//   of global loads; the split puts 64 threads on each Gaussian there
//   (bwd_split picks W and S). Row 10 (the fused [data; boundary]
//   projection geometry) keeps three accumulator blocks: query tiles
//   below data_tiles feed blocks 1 and 2, the boundary tiles after them
//   block 3 with a value-only cotangent; at Karman-2D its busiest columns
//   hold ~70 live query tiles, mostly boundary tiles, against a mean of
//   ~10, so the split shortens the longest walk.
// No atomics: each output element has exactly one owner thread, which
// adds the split's partial sums in a fixed order after one fixed shuffle
// tree (the query-side kernels) or worker by worker (the backwards), so
// sums are deterministic, as the TPU kernels' sequential grid reductions
// are.

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

// The split parameter backwards (rows 2, 3 and 10) compact LIST_CAP
// query tiles at once.
constexpr int LIST_CAP = 4096;

// Dynamic shared memory of one block: the compacted list, the warps'
// counts, and one slot of TN x dn_sums partial sums.
template <int D, int VDIM, int NCOT>
size_t dn_smem_bytes() {
  return sizeof(float) *
         (LIST_CAP + MAX_W * TN / 32 + dn_sums<D, VDIM, NCOT>() * TN);
}

// Rows 2 (NCOT = 1), 3 (NCOT = 2) and 10 (NCOT = 3). Block (j, s) of a
// cluster of S along y: Gaussian tile j, split rank s. Thread (g, w) owns
// Gaussian j TN + g for worker u = s W + w of U = W S. Each block compacts
// column j of the tile mask (LIST_CAP query tiles at a time, in order) and
// worker u walks the u-th of U equal contiguous shares of the live list,
// reading each tile's rows where they lie (staging them in shared memory
// by cp.async did not pay), all of a tile's support tests first, as
// independent chains (dn_tile unboxed). Rows 2 and 3 feed every tile to
// their NCOT blocks. Row 10 feeds a query tile below data_tiles to blocks
// 1 and 2 (njac, use_val) and a later one to block 3 with a value-only
// cotangent (vdim columns); a worker's tiles are one kind but at the
// share that holds the last data tile, so a warp's branch is uniform.
// Only ~6% of the pairs a Karman-2D column walks lie inside the
// Gaussian's box, but a box test on the rows' radii first (BOXED: dn_tile
// as the cells backward runs it, rad the rows' dilated radii) was slower
// at nearly every split on an H100 (python -m
// gaussian_fluids_torch.dn3_box_ab; PERF.md): the box puts a dependent
// branch and a second read of the rows before the geometry, where the
// unboxed tile issues its 8 chains at once. The sums meet in one fixed
// order (gsr_tile.cuh dn_meet_store).
template <int D, int VDIM, int NCOT, bool BOXED = false>
__device__ __forceinline__ void dn_column(
    const int* __restrict__ tmask, const float* __restrict__ x,
    const float* __restrict__ muT, const float* __restrict__ ppT,
    const float* __restrict__ v, const float* __restrict__ dout1,
    const float* __restrict__ dout2, const float* __restrict__ dout3,
    const DnOut& out, int B, int N, int njac, int use_val, int data_tiles,
    float clamp, const float* __restrict__ rad = nullptr) {
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
  const float r = BOXED ? rad[n] : 0.f;
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
      if constexpr (NCOT < 3) {
        dn_tile<D, VDIM, NCOT, false>(xt, xt, dout1 + i * TB * cols,
                                      dout2 + i * TB * cols, cols, G, 0.f,
                                      vv, njac, use_val, clamp, accm, accv);
      } else if (i < data_tiles) {   // data rows: blocks 1 and 2
        dn_tile<D, VDIM, 2, BOXED>(xt, xt, dout1 + i * TB * cols,
                                   dout2 + i * TB * cols, cols, G, r, vv,
                                   njac, use_val, clamp, accm, accv);
      } else {                       // boundary rows: block 3, value only
        const float* d3 = dout3 + i * TB * VDIM;
        dn_tile<D, VDIM, 1, BOXED>(xt, xt, d3, d3, VDIM, G, r, vv, 0, 1,
                                   clamp, accm + 2, accv + 2);
      }
    }
    __syncthreads();   // the next window refills the list
  }

  dn_meet_store<D, VDIM, NCOT>(red, g, w, W, s, S, n, N, accm, accv, out);
}

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
  dn_column<D, VDIM, NCOT>(tmask, x, muT, ppT, v, dout1, dout2, nullptr,
                           DnOut{{dmp1, dmp2}, {dv1, dv2}}, B, N, njac,
                           use_val, 0, clamp);
}

template <int D, int VDIM>
__global__ void __launch_bounds__(TN * MAX_W)
gsr_bwd_dn3_kernel(const int* __restrict__ tmask,
                   const float* __restrict__ x, const float* __restrict__ muT,
                   const float* __restrict__ ppT, const float* __restrict__ v,
                   const float* __restrict__ dout1,
                   const float* __restrict__ dout2,
                   const float* __restrict__ dout3, DnOut out, int B, int N,
                   int njac, int use_val12, int data_tiles, float clamp) {
  dn_column<D, VDIM, 3>(tmask, x, muT, ppT, v, dout1, dout2, dout3, out, B,
                        N, njac, use_val12, data_tiles, clamp);
}

// dL/dx's pair body (row 4): the pair's cotangents against the query's
// cotangent row drow (registers) and v from the staged tile t, each
// dL/dx_k added to acc (pair_cotangents and pair_dx: the plain twin's
// terms).
template <int D, int VDIM>
struct DxPair {
  float* acc;
  const float* drow;
  int njac;
  __device__ __forceinline__ void operator()(const Geom<D>& qg,
                                             const Gauss<D>& G,
                                             const float* t, int n) const {
    float vv[VDIM], s2[D], gpd[D];
#pragma unroll
    for (int a = 0; a < VDIM; ++a)
      vv[a] = t[StagedTile<D, VDIM>::V + n * VDIM + a];
    const float gquad =
        pair_cotangents<D, VDIM>(qg, drow, vv, njac, 1, s2, gpd);
#pragma unroll
    for (int k = 0; k < D; ++k)
      acc[k] += pair_dx<D>(qg, gquad, gpd, G.p, njac, k);
  }
};

// Row 4: query tile i's block (rank s of a cluster of S along y) walks the
// tile's row of the mask through the forward's staged, box-tested sweep
// with dL/dx as the pair body, the query's cotangent row in registers; the
// sums meet as the forward's do (query_meet).
template <int D, int VDIM>
__global__ void __launch_bounds__(FWD_THREADS)
gsr_bwd_dx_kernel(const int* __restrict__ tmask, const float* __restrict__ x,
                  const float* __restrict__ muT,
                  const float* __restrict__ ppT,
                  const float* __restrict__ rad, const float* __restrict__ v,
                  const float* __restrict__ dout, float* __restrict__ dx,
                  int N, int njac, float clamp) {
  __shared__ __align__(16) FwdSmem<D, VDIM> sm;
  const int i = blockIdx.x, nnt = N / TN;
  const int tid = threadIdx.x;
  const int slot = tid % FWD_SLOTS, q = tid / FWD_SLOTS;
  const int b = i * TB + q;
  const int s = blockIdx.y, S = gridDim.y;
  const int cols = (1 + njac) * VDIM;
  const LiveTiles<false> src{nullptr, nullptr, 0, 0, i, tmask + i * nnt, 1,
                             nnt, false};
  float xq[D], drow[(1 + D) * VDIM], acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xq[k] = x[D * b + k];
    acc[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k)
    drow[k] = k < cols ? dout[b * cols + k] : 0.f;
  const Stager<D, VDIM, FWD_THREADS> st(muT, ppT, rad, v, N);
  fwd_sweep<D, VDIM>(src, xq, st, clamp, sm,
                     DxPair<D, VDIM>{acc, drow, njac});
  query_meet<D>(acc, sm, q, slot, s, S);
  if (s == 0 && slot == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) dx[b * D + k] = acc[k];
  }
}

// Launches kernel on an (nx, S) grid of blocks of `threads`, S blocks a
// cluster along y; returns the launch's error.
template <class... K, class... A>
int launch_cluster(void (*kernel)(K...), int nx, int S, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nx, S);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = S;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc != cudaSuccess ? rc : cudaGetLastError();
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
    return launch_cluster(gsr_fwd_kernel<D, VDIM>, B / TB, S, FWD_THREADS,
                          0, s, tm, x, mu, pp, rad, v, out, N, njac, clamp);
  }
};

struct DxLaunch {
  const int* tm;
  const float *x, *mu, *pp, *rad, *v, *dout;
  float* dx;
  int B, N, njac, S;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    return launch_cluster(gsr_bwd_dx_kernel<D, VDIM>, B / TB, S,
                          FWD_THREADS, 0, s, tm, x, mu, pp, rad, v, dout, dx,
                          N, njac, clamp);
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
    return launch_cluster(gsr_bwd_dn_kernel<D, VDIM, NCOT>, N / TN, S,
                          TN * W, dn_smem_bytes<D, VDIM, NCOT>(), s, tm, x,
                          mu, pp, v, d1, d2, m1, v1, m2, v2, B, N, njac,
                          use_val, clamp);
  }
};

struct Dn3Launch {
  const int* tm;
  const float *x, *mu, *pp, *v, *d1, *d2, *d3;
  DnOut out;
  int B, N, njac, use_val12, data_tiles, W, S;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    return launch_cluster(gsr_bwd_dn3_kernel<D, VDIM>, N / TN, S, TN * W,
                          dn_smem_bytes<D, VDIM, 3>(), s, tm, x, mu, pp, v,
                          d1, d2, d3, out, B, N, njac, use_val12, data_tiles,
                          clamp);
  }
};

inline bool bad_bwd(int B, int N, int d, int vdim, int njac, int use_val,
                    int W, int S) {
  return bad_shape(B, N, d, vdim, njac) || (!use_val && njac == 0) ||
         bad_split(W, S);
}

template <int NCOT>
int launch_bwd(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* v, const void* dout1,
               const void* dout2, void* dmp1, void* dv1, void* dmp2,
               void* dv2, int B, int N, int d, int vdim, int njac,
               int use_val, float clamp, int W, int S, void* stream) {
  if (bad_bwd(B, N, d, vdim, njac, use_val, W, S))
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

// dL/dx split S ways along the Gaussian axis as the forward is; rad the
// rows' dilated radii of the box test.
int gsr_bwd_dx(const void* tmask, const void* x, const void* muT,
               const void* ppT, const void* rad, const void* v,
               const void* dout, void* dx, int B, int N, int d, int vdim,
               int njac, float clamp, int S, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || bad_split(1, S))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const DxLaunch f{static_cast<const int*>(tmask),
                   static_cast<const float*>(x),
                   static_cast<const float*>(muT),
                   static_cast<const float*>(ppT),
                   static_cast<const float*>(rad),
                   static_cast<const float*>(v),
                   static_cast<const float*>(dout),
                   static_cast<float*>(dx),
                   B, N, njac, S, clamp, static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

// Blocks 1 and 2 on the query tiles below data_rows / TB, block 3 (value
// only, vdim columns) on the rest; split as the parameter backwards.
int gsr_bwd_dn3(const void* tmask, const void* x, const void* muT,
                const void* ppT, const void* v, const void* dout1,
                const void* dout2, const void* dout3, void* dmp1, void* dv1,
                void* dmp2, void* dv2, void* dmp3, void* dv3, int B, int N,
                int d, int vdim, int njac, int use_val12, int data_rows,
                float clamp, int W, int S, void* stream) {
  if (bad_bwd(B, N, d, vdim, njac, use_val12, W, S) || data_rows < 0 ||
      data_rows > B || data_rows % TB)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const Dn3Launch f{
      static_cast<const int*>(tmask),
      static_cast<const float*>(x),
      static_cast<const float*>(muT),
      static_cast<const float*>(ppT),
      static_cast<const float*>(v),
      static_cast<const float*>(dout1),
      static_cast<const float*>(dout2),
      static_cast<const float*>(dout3),
      DnOut{{static_cast<float*>(dmp1), static_cast<float*>(dmp2),
             static_cast<float*>(dmp3)},
            {static_cast<float*>(dv1), static_cast<float*>(dv2),
             static_cast<float*>(dv3)}},
      B, N, njac, use_val12, data_rows / TB, W, S, clamp,
      static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

}  // extern "C"
