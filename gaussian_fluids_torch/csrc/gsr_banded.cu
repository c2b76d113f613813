// Banded value-only Gaussian field kernel for Hopper (sm_90a): the RK4
// stage evaluations of the density replay, d = 2 and 3, vdim = 1, 2, 3.
//
// Replaces the Pallas TPU kernel _val_banded_kernel of the JAX package
// (gaussian_fluids_tpu/ops/pallas/gsr_centered.py, launched from
// fused_gsr_value_banded). What it computes, per query b of query tile i:
//   out[b] = sum over the Gaussian rows n of the window of tile i of
//            1[g >= c] (g - c) v[n],   g = exp(-quad / 2),
//   quad   = sum_k P_kk dx_k^2 + sum_{i<j} 2 P_ij dx_i dx_j + bias,
//            dx = x - mu
// The quadratic form is taken directly (no P dx), as the TPU kernel's
// _val_tile takes it. Queries are sorted along x and Gaussians slab-major
// (x-slab first), so the tiles whose x range can reach a query tile form
// one contiguous window of `band` Gaussian tiles, starting at jlo[i]
// (clamped into [0, N/BTN - band], as the TPU kernel's index maps clamp
// it); inside the window only the tiles whose box meets the query tile's
// are walked (below).
//
// The band guard without a host read. The caller computes on the device
// whether every Gaussian tile that can reach a query tile lies inside its
// window (ok[0]). When it does not, every block sweeps the whole Gaussian
// axis in this same launch, so the result is exact either way; block 0
// counts such launches in *guard_failures. Outside the support a pair adds
// nothing, so the full sweep and a sufficient window give bitwise-equal
// sums: the same nonzero terms, added in the same order.
//
// Layout: x (B, D); muT (D, N); ppT (NP, N) = rows P_kk, the off-diagonal
// P_ij (i < j, lexicographic), the dead-row bias (+1e9 on dead and padded
// rows); rad (N,) each row's dilated support radius, -1 on dead and
// padded rows; v (N, VDIM); tlo, thi (D, N/BTN) the tiles' boxes; out
// (B, VDIM).
//
// What bounds it on an H100, and the design (the slab-major replay).
// At the production chunk (B = 262,144 grid nodes, N = 75,776 rows at
// Ring-Collide width) an x-sorted window held ~1.3e4 rows, all evaluated,
// of which 0.2% reach a query: the walk, not the pair, was the cost. The
// replay now sorts the mixture slab-major (GaussianMixture.slab_sorted:
// x-slab, y-cell, then z), so a tile of 64 rows is a short z-run of one
// column, and the wrapper hands in each tile's box (tlo, thi: (D, N/BTN),
// every row dilated by its own radius and a 1e-3 margin). Each block
//   1. forms its query tile's box from its real queries (the first
//      nvalid rows of x);
//   2. tests the window's tiles against it, BTB at a time, one tile a
//      thread, and compacts the meeting tiles, ascending, into a list in
//      shared memory (a ballot per warp, the warps' counts in order);
//   3. walks the list through three staging buffers: the next two tiles'
//      rows (mu, ppT, radius, v: 256-byte slices) fly in by cp.async
//      while the current one is evaluated from shared memory, read there
//      as broadcasts (gsr_tile.cuh walk_staged).
// Per thread the loop is the one before: one query, rows ascending, the
// sums in registers, no atomics. Of a staged tile a warp walks only the
// rows whose dilated box meets its 32 queries' box (a ballot: no
// divergence); a pair outside its row's dilated box (|x_k - mu_k| > r on
// some axis) skips the quadratic form (it has g < c however f32 rounds,
// so every such skip changes nothing), and a pair whose quad exceeds qcut
// skips its exp: qcut lies far enough above -2 ln c that such a pair has
// g < c for certain. The guard's full sweep
// takes the same culled walk over the whole axis: the window's x range
// comes from the same boxes, so both walks visit the same tiles in the
// same order, and the sweep stays bitwise equal to a covering window.
// What is left is bound by operations on the pairs of the meeting tiles
// (~20 tiles a query tile at the 512^3 step, against 199-252 before).

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

constexpr int BTB = 128;   // queries per tile: one thread each
constexpr int BTN = TN;    // Gaussians per tile, staged in shared memory
constexpr int NWARP = BTB / 32;
constexpr int NSTAGE = 3;  // staging buffers: two tiles in flight

template <int D, int VDIM>
__global__ void __launch_bounds__(BTB)
val_banded_kernel(const int* __restrict__ jlo, const int* __restrict__ ok,
                  const float* __restrict__ x, const float* __restrict__ muT,
                  const float* __restrict__ ppT,
                  const float* __restrict__ rad, const float* __restrict__ v,
                  const float* __restrict__ tlo,
                  const float* __restrict__ thi, float* __restrict__ out,
                  int* __restrict__ guard_failures, int nvalid, int N,
                  int band, float clamp, float qcut) {
  constexpr int NB = Dims<D>::NB;
  using S = StagedTile<D, VDIM>;
  __shared__ __align__(16) float stage[NSTAGE][S::FLOATS];
  __shared__ int list[BTB];
  __shared__ int wcount[NWARP];
  __shared__ float wbox[NWARP][2 * D];
  const int nnt = N / BTN;
  const int i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = i * BTB + tid;
  int j0 = 0, nj = nnt;
  if (*ok) {
    j0 = min(max(jlo[i], 0), nnt - band);
    nj = band;
  } else if (i == 0 && tid == 0) {
    *guard_failures += 1;
  }
  float xq[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];

  // 1. the boxes of the warp's and of the block's real queries (+-inf
  //    when none)
  float wlo[D], whi[D], qlo[D], qhi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    wlo[k] = b < nvalid ? xq[k] : INFINITY;
    whi[k] = b < nvalid ? xq[k] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      wlo[k] = fminf(wlo[k], __shfl_xor_sync(0xffffffffu, wlo[k], off));
      whi[k] = fmaxf(whi[k], __shfl_xor_sync(0xffffffffu, whi[k], off));
    }
    if (lane == 0) {
      wbox[warp][k] = wlo[k];
      wbox[warp][D + k] = whi[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < D; ++k) {
    qlo[k] = wbox[0][k];
    qhi[k] = wbox[0][D + k];
    for (int w = 1; w < NWARP; ++w) {
      qlo[k] = fminf(qlo[k], wbox[w][k]);
      qhi[k] = fmaxf(qhi[k], wbox[w][D + k]);
    }
  }

  float acc[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) acc[a] = 0.f;
  const Stager<D, VDIM, BTB> st(muT, ppT, rad, v, N);
  auto pair = [&](const float* s, int n) {
    const float r = s[S::RAD + n];
    float dx[D];
    bool in = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      dx[k] = xq[k] - s[S::MU + k * BTN + n];
      in = in && fabsf(dx[k]) <= r;
    }
    if (!in) return;   // outside the row's dilated box: g < c
    float quad = s[S::PP + NB * BTN + n] + s[S::PP + n] * dx[0] * dx[0];
#pragma unroll
    for (int k = 1; k < D; ++k)
      quad += s[S::PP + k * BTN + n] * dx[k] * dx[k];
#pragma unroll
    for (int c = 0; c < Dims<D>::NOFF; ++c)
      quad += (2.f * s[S::PP + (D + c) * BTN + n]) * dx[pair_i<D>(c)] *
              dx[pair_j<D>(c)];   // 2 P_ij exactly, as the TPU kernel
    if (quad > qcut) return;      // g < c for certain
    const float g = expf(-0.5f * quad);
    if (g >= clamp) {
      const float gc = g - clamp;
#pragma unroll
      for (int a = 0; a < VDIM; ++a) acc[a] += gc * s[S::V + n * VDIM + a];
    }
  };
  // A staged tile: the warp marks the rows whose dilated box meets its
  // queries' box (two rows a lane, a ballot each), then walks only those,
  // ascending: the same for every lane, so the walk does not diverge.
  auto eval = [&](const float* s) {
#pragma unroll
    for (int h = 0; h < BTN / 32; ++h) {
      const int n = h * 32 + lane;
      const float r = s[S::RAD + n];
      bool meet = r >= 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float m = s[S::MU + k * BTN + n];
        meet = meet && wlo[k] <= m + r && whi[k] >= m - r;
      }
      for (unsigned rows = __ballot_sync(0xffffffffu, meet); rows;
           rows &= rows - 1)
        pair(s, h * 32 + __ffs(rows) - 1);
    }
  };

  for (int c0 = 0; c0 < nj; c0 += BTB) {
    // 2. cull BTB window tiles by box, compact the meeting ones in order
    const int j = j0 + c0 + tid;
    bool meet = c0 + tid < nj;
    if (meet) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        meet = meet && tlo[k * nnt + j] <= qhi[k] &&
               thi[k * nnt + j] >= qlo[k];
    }
    const int cnt = compact_block<BTB>(meet, j, list, wcount);
    // 3. walk them, later tiles in flight
    walk_staged<D, VDIM, NSTAGE, BTB>(list, cnt, stage, st, eval);
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) out[VDIM * b + a] = acc[a];
}

struct BandedLaunch {
  const int *jlo, *ok;
  const float *x, *mu, *pp, *rad, *v, *tlo, *thi;
  float* out;
  int* guard_failures;
  int B, nvalid, N, band;
  float clamp, qcut;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    val_banded_kernel<D, VDIM><<<dim3(B / BTB), dim3(BTB), 0, s>>>(
        jlo, ok, x, mu, pp, rad, v, tlo, thi, out, guard_failures, nvalid, N,
        band, clamp, qcut);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// The compiled tile sizes, so the Python side can refuse window starts
// computed for other tiles.
int banded_tile_sizes(int* tb, int* tn) {
  *tb = BTB;
  *tn = BTN;
  return 0;
}

int gsr_value_banded(const void* jlo, const void* ok, const void* x,
                     const void* muT, const void* ppT, const void* rad,
                     const void* v, const void* tlo, const void* thi,
                     void* out, void* guard_failures, int B, int nvalid,
                     int N, int d, int vdim, int band, float clamp,
                     float qcut, void* stream) {
  if (B < 0 || nvalid < 0 || nvalid > B || N < BTN || B % BTB || N % BTN ||
      band < 1 || band > N / BTN || (d != 2 && d != 3) || vdim < 1 ||
      vdim > 3)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const BandedLaunch f{static_cast<const int*>(jlo),
                       static_cast<const int*>(ok),
                       static_cast<const float*>(x),
                       static_cast<const float*>(muT),
                       static_cast<const float*>(ppT),
                       static_cast<const float*>(rad),
                       static_cast<const float*>(v),
                       static_cast<const float*>(tlo),
                       static_cast<const float*>(thi),
                       static_cast<float*>(out),
                       static_cast<int*>(guard_failures),
                       B, nvalid, N, band, clamp, qcut,
                       static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

}  // extern "C"
