// Work-list ("cells") Gaussian-splatting field kernels for Hopper
// (sm_90a), d = 2 and 3, vdim = 1, 2, 3.
//
// Replaces three Pallas TPU kernels of the JAX package
// (gaussian_fluids_tpu/ops/pallas/gsr_cells.py):
//   cells_fwd_kernel             <- _fwd_work_kernel  (fused_gsr_cells_fwd)
//   cells_bwd_split_kernel<.,1>  <- _dn1_work_kernel  (fused_gsr_cells_bwd1)
//   cells_bwd_split_kernel<.,2>  <- _dn2_work_kernel  (fused_gsr_cells_bwd2)
// They compute the centered sums of gsr_centered.cu (shared device code in
// gsr_tile.cuh) over only the live tile pairs of a flat work list
// (ops/spatial.py flat_work_list): the row-sorted list (rows, cols) of
// the (B/TB, N/TN) tile mask for the forward, the list of its transpose
// (gtiles, qtiles) for the backward.
//
// The TPU grid walks the list in order and zeroes an output block at the
// first item of each run of equal rows; CUDA blocks run in no order. Here
// every output has one owner that walks its own run: the forward gives
// query tile i a block, which finds the start of row i's run by binary
// search in `rows` and walks it until the first -1; the backward gives
// Gaussian tile j W x S threads a Gaussian (rows 6 and 7), which do the
// same in `gtiles`. No atomics, a fixed order, and the owner writes every
// output element, so the sums are deterministic and need no zeroing pass.
//
// Overflow: `ok` (a device int) is 0 when the list's capacity was too
// small to hold every live pair. The kernel reads it on the device and
// then sweeps the whole row (column) of the same fine tile mask instead,
// exactly as the centered kernels do: exact in both cases, and no host
// read. Block 0's first thread adds 1 to *overflows when that happens.
//
// What bounds them on an H100, counted at Ring-Collide shapes (B = 8192
// queries, N = 75,776 Gaussian rows, d = vdim = 3, tiles 8 x 64, ~10% of
// the 1024 x 1184 tile pairs live): ~6e7 query-Gaussian pairs of the
// live tiles, of which ~1.3% have the query inside the Gaussian's support
// box and ~0.4% inside the support. Counted on the pairs the work needs
// (geometry and accumulation of those in the support) and the bytes
// (parameters 4 MB, the lists' live items 1 MB, outputs under 4 MB) the
// bound is a few microseconds; what the kernels pay is latency. So both
// box-test every pair before its geometry (the row's dilated radius): the
// forward on staged tiles (gsr_tile.cuh fwd_walk, shared with the
// centered forward), the backward on the Gaussian's own radius against
// each query tile's x rows read ahead. The backward splits each tile's
// run over W workers a block and S blocks a cluster (ops/gsr_centered.py
// bwd_split picks them from the shape): one thread a Gaussian filled 18
// of an SM's 64 warp slots, each walking ~100 query tiles in one chain of
// loads. Rows 6 and 7 are one kernel over NCOT cotangent blocks, which
// share each pair's box test and geometry.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

template <int D, int VDIM>
__global__ void __launch_bounds__(FWD_THREADS)
cells_fwd_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 int cap, const int* __restrict__ ok,
                 const int* __restrict__ tmask, const float* __restrict__ x,
                 const float* __restrict__ muT,
                 const float* __restrict__ ppT,
                 const float* __restrict__ rad, const float* __restrict__ v,
                 float* __restrict__ out, int* __restrict__ overflows, int N,
                 int njac, float clamp) {
  __shared__ __align__(16) FwdSmem<D, VDIM> sm;
  const int i = blockIdx.x, nnt = N / TN;
  // the live tiles of query tile i, ascending: its run of the work list
  // up to the first -1, or, when the list overflowed, its mask row
  const bool listed = *ok != 0;
  if (!listed && i == 0 && threadIdx.x == 0) *overflows += 1;
  const LiveTiles<true> src{rows, cols, cap,
                            listed ? run_start(rows, cap, i) : 0, i,
                            tmask + i * nnt, 1, nnt, listed};
  fwd_walk<D, VDIM>(src, i, x, muT, ppT, rad, v, out, N, njac, clamp, sm);
}

// Rows 7 (NCOT = 1) and 6 (NCOT = 2), the split parameter backward over
// the transposed work list:
// block (j, s) of a cluster of S along y, Gaussian tile j, rank s; thread
// (g, w) owns Gaussian j TN + g for worker u = s W + w of U = W S. The run
// of tile j (its live query tiles, ascending; found by run_start_warp) is
// compacted into shared memory BWD_WINDOW candidates at a time (on
// overflow its column of the tile mask instead), the window's x rows are
// copied beside it (independent 16-byte loads), and worker u walks the
// u-th of U equal contiguous shares, every pair box-tested on the
// Gaussian's own radius before its geometry (dn_tile): with ~99% of the
// pairs skipped, a tile costs its box tests, read from shared memory, not
// a dependent global load. The partial sums meet in one fixed order
// (dn_meet_store).
constexpr int BWD_WINDOW = 128;

template <int D, int VDIM, int NCOT>
size_t split_smem_bytes() {   // list, warps' counts, x rows, one sum slot
  return sizeof(float) * (BWD_WINDOW + MAX_W * TN / 32 +
                          BWD_WINDOW * TB * D + dn_sums<D, VDIM, NCOT>() * TN);
}

template <int D, int VDIM, int NCOT>
__global__ void __launch_bounds__(TN * MAX_W)
cells_bwd_split_kernel(const int* __restrict__ gtiles,
                       const int* __restrict__ qtiles, int cap,
                       const int* __restrict__ ok,
                       const int* __restrict__ tmask,
                       const float* __restrict__ x,
                       const float* __restrict__ muT,
                       const float* __restrict__ ppT,
                       const float* __restrict__ rad,
                       const float* __restrict__ v,
                       const float* __restrict__ dout1,
                       const float* __restrict__ dout2,
                       float* __restrict__ dmp1, float* __restrict__ dv1,
                       float* __restrict__ dmp2, float* __restrict__ dv2,
                       int* __restrict__ overflows, int B, int N, int njac,
                       int use_val, float clamp) {
  constexpr int NMP = Dims<D>::NMP;
  constexpr int Q4 = TB * D / 4;   // a query tile's x rows in 16 bytes
  extern __shared__ float smem[];
  int* list = reinterpret_cast<int*>(smem);
  int* wcount = list + BWD_WINDOW;
  float* xs = smem + BWD_WINDOW + MAX_W * TN / 32;
  float* red = xs + BWD_WINDOW * TB * D;
  const int nbt = B / TB, nnt = N / TN;
  const int W = blockDim.x / TN, S = gridDim.y;
  const int g = threadIdx.x % TN, w = threadIdx.x / TN;
  const int s = blockIdx.y, j = blockIdx.x;
  const int U = W * S, u = s * W + w;
  const int n = j * TN + g;
  const int cols = (1 + njac) * VDIM;

  const Gauss<D> G = load_gauss<D>(muT, ppT, N, n);
  const float r = rad[n];
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

  const bool listed = *ok != 0;
  if (!listed && j == 0 && s == 0 && threadIdx.x == 0) *overflows += 1;
  const LiveTiles<true> src{gtiles, qtiles, cap,
                            listed ? run_start_warp(gtiles, cap, j) : 0, j,
                            tmask + j, nnt, nbt, listed};
  for (int base = 0;; base += BWD_WINDOW) {
    bool more;
    const int live = compact_window(src, base, BWD_WINDOW, blockDim.x, list,
                                    wcount, more);
    for (int e = threadIdx.x; e < live * Q4; e += blockDim.x)
      reinterpret_cast<float4*>(xs)[e] = __ldg(
          reinterpret_cast<const float4*>(x) + list[e / Q4] * Q4 + e % Q4);
    __syncthreads();
    const int lo = static_cast<int>(static_cast<long long>(u) * live / U);
    const int hi =
        static_cast<int>(static_cast<long long>(u + 1) * live / U);
    for (int m = lo; m < hi; ++m) {
      const int i = list[m];
      const float* xt = xs + m * TB * D;
      dn_tile<D, VDIM, NCOT, true>(xt, xt, dout1 + i * TB * cols,
                                   dout2 + i * TB * cols, cols, G, r, vv,
                                   njac, use_val, clamp, accm, accv);
    }
    __syncthreads();   // the next window refills the list and the rows
    if (!more) break;
  }
  dn_meet_store<D, VDIM, NCOT>(red, g, w, W, s, S, n, N, accm, accv,
                               DnOut{{dmp1, dmp2}, {dv1, dv2}});
}

struct FwdLaunch {
  const int *rows, *cols;
  int cap;
  const int *ok, *tm;
  const float *x, *mu, *pp, *rad, *v;
  float* out;
  int* over;
  int B, N, njac;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    cells_fwd_kernel<D, VDIM><<<dim3(B / TB), dim3(FWD_THREADS), 0, s>>>(
        rows, cols, cap, ok, tm, x, mu, pp, rad, v, out, over, N, njac,
        clamp);
    return cudaGetLastError();
  }
};

template <int NCOT>
struct SplitLaunch {
  const int *gt, *qt;
  int cap;
  const int *ok, *tm;
  const float *x, *mu, *pp, *rad, *v, *d1, *d2;
  float *m1, *v1, *m2, *v2;
  int* over;
  int B, N, njac, use_val, W, S;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N / TN, S);
    cfg.blockDim = dim3(TN * W);
    cfg.dynamicSmemBytes = split_smem_bytes<D, VDIM, NCOT>();
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = S;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, cells_bwd_split_kernel<D, VDIM, NCOT>, gt, qt, cap, ok, tm, x,
        mu, pp, rad, v, d1, d2, m1, v1, m2, v2, over, B, N, njac, use_val,
        clamp);
    return rc != cudaSuccess ? rc : cudaGetLastError();
  }
};

template <int NCOT>
int launch_split(const void* gtiles, const void* qtiles, int cap,
                 const void* ok, const void* tmask, const void* x,
                 const void* muT, const void* ppT, const void* rad,
                 const void* v, const void* dout1, const void* dout2,
                 void* dmp1, void* dv1, void* dmp2, void* dv2,
                 void* overflows, int B, int N, int d, int vdim, int njac,
                 int use_val, float clamp, int W, int S, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || (!use_val && njac == 0) ||
      cap < 1 || bad_split(W, S))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const SplitLaunch<NCOT> f{
      static_cast<const int*>(gtiles),  static_cast<const int*>(qtiles),
      cap,                              static_cast<const int*>(ok),
      static_cast<const int*>(tmask),   static_cast<const float*>(x),
      static_cast<const float*>(muT),   static_cast<const float*>(ppT),
      static_cast<const float*>(rad),   static_cast<const float*>(v),
      static_cast<const float*>(dout1), static_cast<const float*>(dout2),
      static_cast<float*>(dmp1),        static_cast<float*>(dv1),
      static_cast<float*>(dmp2),        static_cast<float*>(dv2),
      static_cast<int*>(overflows),     B, N, njac, use_val, W, S, clamp,
      static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

}  // namespace

extern "C" {

int cells_tile_sizes(int* tb, int* tn) {
  *tb = TB;
  *tn = TN;
  return 0;
}

int cells_fwd(const void* rows, const void* cols, int cap, const void* ok,
              const void* tmask, const void* x, const void* muT,
              const void* ppT, const void* rad, const void* v, void* out,
              void* overflows, int B, int N, int d, int vdim, int njac,
              float clamp, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || cap < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const FwdLaunch f{static_cast<const int*>(rows),
                    static_cast<const int*>(cols),
                    cap,
                    static_cast<const int*>(ok),
                    static_cast<const int*>(tmask),
                    static_cast<const float*>(x),
                    static_cast<const float*>(muT),
                    static_cast<const float*>(ppT),
                    static_cast<const float*>(rad),
                    static_cast<const float*>(v),
                    static_cast<float*>(out),
                    static_cast<int*>(overflows),
                    B, N, njac, clamp, static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

// Rows 7 (one cotangent) and 6 (cells_bwd_dn2, two), split W x S ways
// (W in 1, 2, 4, 8 workers a block, S in 1, 2, 4, 8 blocks a cluster;
// anything else is refused), rad the rows' dilated radii of the box test.
int cells_bwd_dn(const void* gtiles, const void* qtiles, int cap,
                 const void* ok, const void* tmask, const void* x,
                 const void* muT, const void* ppT, const void* rad,
                 const void* v, const void* dout, void* dmp, void* dv,
                 void* overflows, int B, int N, int d, int vdim, int njac,
                 int use_val, float clamp, int W, int S, void* stream) {
  return launch_split<1>(gtiles, qtiles, cap, ok, tmask, x, muT, ppT, rad,
                         v, dout, dout, dmp, dv, dmp, dv, overflows, B, N, d,
                         vdim, njac, use_val, clamp, W, S, stream);
}

int cells_bwd_dn2(const void* gtiles, const void* qtiles, int cap,
                  const void* ok, const void* tmask, const void* x,
                  const void* muT, const void* ppT, const void* rad,
                  const void* v, const void* dout1, const void* dout2,
                  void* dmp1, void* dv1, void* dmp2, void* dv2,
                  void* overflows, int B, int N, int d, int vdim, int njac,
                  int use_val, float clamp, int W, int S, void* stream) {
  return launch_split<2>(gtiles, qtiles, cap, ok, tmask, x, muT, ppT, rad,
                         v, dout1, dout2, dmp1, dv1, dmp2, dv2, overflows, B,
                         N, d, vdim, njac, use_val, clamp, W, S, stream);
}

}  // extern "C"
