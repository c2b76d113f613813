// Work-list ("cells") Gaussian-splatting field kernels for Hopper
// (sm_90a), d = 2 and 3, vdim = 1, 2, 3.
//
// Replaces three Pallas TPU kernels of the JAX package
// (gaussian_fluids_tpu/ops/pallas/gsr_cells.py):
//   cells_fwd_kernel          <- _fwd_work_kernel  (fused_gsr_cells_fwd)
//   cells_bwd_dn_kernel<.,1>  <- _dn1_work_kernel  (fused_gsr_cells_bwd1)
//   cells_bwd_dn_kernel<.,2>  <- _dn2_work_kernel  (fused_gsr_cells_bwd2)
// They compute the centered sums of gsr_centered.cu (shared device code in
// gsr_tile.cuh) over only the live tile pairs of a flat work list
// (ops/spatial.py flat_work_list): the row-sorted list (rows, cols) of
// the (B/TB, N/TN) tile mask for the forward, the list of its transpose
// (gtiles, qtiles) for the backward.
//
// The TPU grid walks the list in order and zeroes an output block at the
// first item of each run of equal rows; CUDA blocks run in no order. Here
// every output has one owner that walks its own run: the forward gives
// query tile i a block (FWD_SLOTS threads per query, below), which finds
// the start of row i's run by binary search in `rows` and walks it until
// the first -1; the backward gives Gaussian tile j a block (a thread per
// Gaussian), which does the same in `gtiles`. No atomics, a fixed order,
// and the owner writes every output element, so the sums are
// deterministic and need no zeroing pass.
//
// Overflow: `ok` (a device int) is 0 when the list's capacity was too
// small to hold every live pair. The kernel reads it on the device and
// then sweeps the whole row (column) of the same fine tile mask instead,
// exactly as the centered kernels do: exact in both cases, and no host
// read. Block 0's first thread adds 1 to *overflows when that happens.
//
// What bounds them on an H100, counted at Ring-Collide shapes (B = 8192
// queries, N = 75,776 Gaussian rows, d = vdim = 3, tiles 8 x 64, ~10% of
// the 1024 x 1184 tile pairs live): ~6e7 query-Gaussian pairs of ~30
// operations of centered geometry each, plus the accumulation for the
// ~1% of pairs inside the support (the forward ~40 more, the backward
// ~100 more per cotangent) — about 2 GFLOP, 0.03 ms at the 67 TFLOP/s f32
// peak. The bytes (parameters 4 MB, the lists' live items 1 MB, outputs
// under 4 MB) take ~3 us at 3.35 TB/s. So they are operations-bound on
// the pairs they walk; counted on the pairs the work needs (those in the
// support, ~0.4% of the walked ones) the bound is far lower, and the
// forward's own walk (below) skips the geometry of every pair outside
// its row's box. The backward keeps every sum in registers and reads each
// parameter row once per walk; its occupancy (1184 blocks of 2 warps, a
// thread walking ~100 query tiles) and the runs' imbalance are left to a
// later pass.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

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

// The forward's own walk. Of the ~6e7 pairs of the live tiles at
// Ring-Collide only ~1.3% have the query inside the Gaussian's support
// box, and a warp that loads its tile from global memory itself has only
// two pairs a lane before its next dependent load. So the block (FWD_SLOTS
// threads per query, FWD_THREADS in all) reads its run's live tiles into
// shared memory, FWD_THREADS items at a time, and stages each tile's rows
// (mu, packed P and bias, dilated radius, v) there once, two later tiles
// in flight by cp.async while the current one is evaluated
// (gsr_tile.cuh walk_staged). Thread (q, s) takes query q against
// FWD_ROWS = TN / FWD_SLOTS consecutive rows of every tile (independent
// pairs). A pair first tests |x_k - mu_k| <= r on every axis (r the row's
// radius dilated by 1e-3, -1 on dead rows): one that fails has g < c
// however f32 rounds, so the test is a pure skip; one that passes takes
// centered<D> unchanged, whose rounding keeps the support test bitwise
// the plain version's. Each query's FWD_SLOTS partial sums meet in one
// fixed shuffle tree: deterministic, no atomics, one owner per output.
constexpr int FWD_SLOTS = 16;
constexpr int FWD_THREADS = TB * FWD_SLOTS;
constexpr int FWD_ROWS = TN / FWD_SLOTS;
constexpr int FWD_STAGES = 3;
static_assert(FWD_ROWS % 4 == 0 && 32 % FWD_SLOTS == 0,
              "rows in fours; a query's slots share one warp");

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
  constexpr int NB = Dims<D>::NB;
  using S = StagedTile<D, VDIM>;
  __shared__ __align__(16) float stage[FWD_STAGES][S::FLOATS];
  __shared__ int list[FWD_THREADS];
  __shared__ int wcount[FWD_THREADS / 32];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int slot = tid % FWD_SLOTS;
  const int b = i * TB + tid / FWD_SLOTS;
  float xq[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];
  float acc[(1 + D) * VDIM];
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k) acc[k] = 0.f;
  const Stager<D, VDIM, FWD_THREADS> st(muT, ppT, rad, v, N);
  // A staged tile: rows FWD_ROWS slot .. FWD_ROWS (slot + 1) - 1 are
  // this thread's. Their box tests first (16-byte reads), then the
  // geometry of the rows that pass, ascending: a warp runs the geometry as
  // often as its busiest lane has passing rows, not once per row.
  auto eval = [&](const float* s) {
    float r[FWD_ROWS];
#pragma unroll
    for (int g = 0; g < FWD_ROWS / 4; ++g) {
      const float4 r4 = *reinterpret_cast<const float4*>(
          s + S::RAD + FWD_ROWS * slot + 4 * g);
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
            s + S::MU + k * TN + FWD_ROWS * slot + 4 * g);
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
      for (int k = 0; k < D; ++k) G.mu[k] = s[S::MU + k * TN + n];
#pragma unroll
      for (int k = 0; k < NB; ++k) G.p[k] = s[S::PP + k * TN + n];
      G.bias = s[S::PP + NB * TN + n];
      const Geom<D> q = centered<D>(xq, G);
      if (q.g >= clamp) {
        const float gc = q.g - clamp;
#pragma unroll
        for (int a = 0; a < VDIM; ++a) {
          const float va = s[S::V + n * VDIM + a];
          acc[a] += gc * va;
          if (njac) {
#pragma unroll
            for (int k = 0; k < D; ++k)
              acc[(1 + k) * VDIM + a] += -q.g * q.pd[k] * va;
          }
        }
      }
    }
  };

  // the live tiles of query tile i, ascending: its run of the work list
  // up to the first -1, or, when the list overflowed, its mask row
  const bool listed = *ok != 0;
  const int nnt = N / TN;
  const int w0 = listed ? run_start(rows, cap, i) : 0;
  if (!listed && i == 0 && tid == 0) *overflows += 1;
  for (int base = 0;; base += FWD_THREADS) {
    bool live;
    int j;
    if (listed) {
      const int w = w0 + base + tid;
      live = w < cap && rows[w] == i;
      j = live ? cols[w] : -1;
      live = live && j >= 0;
    } else {
      j = base + tid;
      live = j < nnt && tmask[i * nnt + j] != 0;
    }
    const int cnt = compact_block<FWD_THREADS>(live, j, list, wcount);
    walk_staged<D, VDIM, FWD_STAGES, FWD_THREADS>(list, cnt, stage, st,
                                                  eval);
    // a run's live items come first: a short chunk is its last
    if (listed ? cnt < FWD_THREADS : base + FWD_THREADS >= nnt) break;
  }

  // the query's FWD_SLOTS partial sums, one fixed butterfly tree
#pragma unroll
  for (int k = 0; k < (1 + D) * VDIM; ++k)
    for (int off = FWD_SLOTS / 2; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (slot == 0) {
    const int ncol = (1 + njac) * VDIM;
    for (int k = 0; k < ncol; ++k) out[b * ncol + k] = acc[k];
  }
}

template <int D, int VDIM, int NCOT>
__global__ void __launch_bounds__(TN)
cells_bwd_dn_kernel(const int* __restrict__ gtiles,
                    const int* __restrict__ qtiles, int cap,
                    const int* __restrict__ ok,
                    const int* __restrict__ tmask,
                    const float* __restrict__ x,
                    const float* __restrict__ muT,
                    const float* __restrict__ ppT,
                    const float* __restrict__ v,
                    const float* __restrict__ dout1,
                    const float* __restrict__ dout2,
                    float* __restrict__ dmp1, float* __restrict__ dv1,
                    float* __restrict__ dmp2, float* __restrict__ dv2,
                    int* __restrict__ overflows, int B, int N, int njac,
                    int use_val, float clamp) {
  constexpr int NMP = Dims<D>::NMP;
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
  if (*ok) {
    for (int w = run_start(gtiles, cap, j); w < cap && gtiles[w] == j;
         ++w) {
      const int i = qtiles[w];
      if (i < 0) break;
      bwd_tile<D, VDIM, NCOT>(i, x, G, vv, dout1, dout2, njac, use_val,
                              clamp, accm, accv);
    }
  } else {
    const int nbt = B / TB, nnt = N / TN;
    for (int i = 0; i < nbt; ++i) {
      if (tmask[i * nnt + j] == 0) continue;
      bwd_tile<D, VDIM, NCOT>(i, x, G, vv, dout1, dout2, njac, use_val,
                              clamp, accm, accv);
    }
    if (j == 0 && threadIdx.x == 0) *overflows += 1;
  }
  bwd_store<D, VDIM, NCOT>(n, N, accm, accv, dmp1, dv1, dmp2, dv2);
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
struct BwdLaunch {
  const int *gt, *qt;
  int cap;
  const int *ok, *tm;
  const float *x, *mu, *pp, *v, *d1, *d2;
  float *m1, *v1, *m2, *v2;
  int* over;
  int B, N, njac, use_val;
  float clamp;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    cells_bwd_dn_kernel<D, VDIM, NCOT><<<dim3(N / TN), dim3(TN), 0, s>>>(
        gt, qt, cap, ok, tm, x, mu, pp, v, d1, d2, m1, v1, m2, v2, over, B,
        N, njac, use_val, clamp);
    return cudaGetLastError();
  }
};

template <int NCOT>
int launch_bwd(const void* gtiles, const void* qtiles, int cap,
               const void* ok, const void* tmask, const void* x,
               const void* muT, const void* ppT, const void* v,
               const void* dout1, const void* dout2, void* dmp1, void* dv1,
               void* dmp2, void* dv2, void* overflows, int B, int N, int d,
               int vdim, int njac, int use_val, float clamp, void* stream) {
  if (bad_shape(B, N, d, vdim, njac) || (!use_val && njac == 0) || cap < 1)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const BwdLaunch<NCOT> f{
      static_cast<const int*>(gtiles),  static_cast<const int*>(qtiles),
      cap,                              static_cast<const int*>(ok),
      static_cast<const int*>(tmask),   static_cast<const float*>(x),
      static_cast<const float*>(muT),   static_cast<const float*>(ppT),
      static_cast<const float*>(v),     static_cast<const float*>(dout1),
      static_cast<const float*>(dout2), static_cast<float*>(dmp1),
      static_cast<float*>(dv1),         static_cast<float*>(dmp2),
      static_cast<float*>(dv2),         static_cast<int*>(overflows),
      B, N, njac, use_val, clamp, static_cast<cudaStream_t>(stream)};
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

int cells_bwd_dn(const void* gtiles, const void* qtiles, int cap,
                 const void* ok, const void* tmask, const void* x,
                 const void* muT, const void* ppT, const void* v,
                 const void* dout, void* dmp, void* dv, void* overflows,
                 int B, int N, int d, int vdim, int njac, int use_val,
                 float clamp, void* stream) {
  return launch_bwd<1>(gtiles, qtiles, cap, ok, tmask, x, muT, ppT, v, dout,
                       dout, dmp, dv, dmp, dv, overflows, B, N, d, vdim,
                       njac, use_val, clamp, stream);
}

int cells_bwd_dn2(const void* gtiles, const void* qtiles, int cap,
                  const void* ok, const void* tmask, const void* x,
                  const void* muT, const void* ppT, const void* v,
                  const void* dout1, const void* dout2, void* dmp1,
                  void* dv1, void* dmp2, void* dv2, void* overflows, int B,
                  int N, int d, int vdim, int njac, int use_val, float clamp,
                  void* stream) {
  return launch_bwd<2>(gtiles, qtiles, cap, ok, tmask, x, muT, ppT, v,
                       dout1, dout2, dmp1, dv1, dmp2, dv2, overflows, B, N,
                       d, vdim, njac, use_val, clamp, stream);
}

}  // extern "C"
