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
// The window. Either the caller's (jlo, ok: ok[0] says on the device
// whether every Gaussian tile that can reach a query tile lies inside its
// window; when it does not, every block sweeps the whole Gaussian axis in
// this same launch and block 0 counts the launch in *guard_failures), or,
// where jlo is null, the block's own, by the same rule for its tile alone
// (field.band_window): from its real queries' x range and the tiles' x
// extents (tlo, thi row 0) it finds the first tile that meets the range,
// clips it into [0, N/BTN - band], and sweeps the whole axis only if a
// meeting tile lies past the window; `swept`, where given, takes one flag
// a query tile. Outside the support a pair adds nothing, so the full sweep
// and a sufficient window give bitwise-equal sums: the same nonzero terms,
// added in the same order. The guard is a tile's own, never a host read.
//
// The epilogue (template EPI): VALUE writes the sums; STAGE and SAMPLE are
// stage k of the replay's position-only RK4 (ops/advect.rk4_pos_stages),
// d = vdim = 3, x being that stage's points: STAGE writes the next
// stage's points x0 + coef v into out and total <- total + weight v
// (total <- v at the first stage: v + 2 v1 + 2 v2 so far); SAMPLE (the
// last stage) forms phi = x0 + coef (total + v), clamps it to the domain
// and samples the old density there trilinearly
// (ops/interp.trilinear_interp), into the volume at the chunk's offset.
// Every product, sum and quotient is a round-to-nearest intrinsic, so
// nothing is contracted into an FMA, and the scalars come rounded once
// from the host's doubles, as PyTorch's elementwise operators take them:
// the chunk equals the eager chain (four VALUE launches, the RK4
// arithmetic, clamp, trilinear_interp) bitwise.
//
// Layout: x (B, D); muT (D, N); ppT (NP, N) = rows P_kk, the off-diagonal
// P_ij (i < j, lexicographic), the dead-row bias (+1e9 on dead and padded
// rows); rad (N,) each row's dilated support radius, -1 on dead and
// padded rows; v (N, VDIM); tlo, thi (D, N/BTN) the tiles' boxes; out
// (B, VDIM), (B, 3) or the flat volume.
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
//      nvalid rows of x), and, without a caller's window, its own window
//      from a scan of the N/BTN tiles' x extents (~10 loads a thread);
//   2. tests the window's tiles against it, BTB at a time, one tile a
//      thread, and compacts the meeting tiles, ascending, into a list in
//      shared memory (a ballot per warp, the warps' counts in order);
//   3. walks the list through three staging buffers: the next two tiles'
//      rows (mu, ppT, radius, v: 256-byte slices) fly in by cp.async
//      while the current one is evaluated from shared memory, read there
//      as broadcasts (gsr_tile.cuh walk_staged);
//   4. runs its epilogue, one thread a query.
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
// The replay's chunk is four launches and nothing else: the window, the
// RK4 arithmetic, the clamp and the sample were ~270 small operators of
// the host a chunk, which kept the card idle ~86% of a step.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

constexpr int BTB = 128;   // queries per tile: one thread each
constexpr int BTN = TN;    // Gaussians per tile, staged in shared memory
constexpr int NWARP = BTB / 32;
constexpr int NSTAGE = 3;  // staging buffers: two tiles in flight

enum Epilogue { VALUE = 0, STAGE = 1, SAMPLE = 2 };

// The RK4 stage's and the sample's operands (STAGE, SAMPLE).
struct Rk4 {
  const float* x0;        // (B, 3) the chunk's points
  float* total;           // (B, 3) v + 2 v1 + 2 v2 so far
  const float* density;   // (n0, n1, n2), SAMPLE
  long long offset, nout; // the chunk's first node; the volume's nodes
  float coef, weight;     // next = x0 + coef v; total += weight v
  int first;              // stage 0: total <- v
  int n[3];
  float lo[3], hi[3], step[3];
};

// torch.maximum / torch.minimum of floats: NaN propagates.
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : fminf(a, b);
}

// interp.trilinear_interp at phi (clamped to [lo, hi] first), its
// operators' arithmetic one for one.
__device__ __forceinline__ float sample(const Rk4& r, const float* phi) {
  long long i0[3], i1[3];
  float w[3], om[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = tmin(tmax(phi[k], r.lo[k]), r.hi[k]);
    const float q = __fdiv_rn(__fsub_rn(p, r.lo[k]), r.step[k]);
    const long long f = static_cast<long long>(floorf(q));
    w[k] = __fsub_rn(q, static_cast<float>(f));
    om[k] = __fsub_rn(1.f, w[k]);
    const long long last = r.n[k] - 1;
    i0[k] = min(max(f, 0LL), last);
    i1[k] = min(i0[k] + 1, last);
  }
  auto g = [&](long long a, long long b, long long c) {
    return __ldg(r.density + (a * r.n[1] + b) * r.n[2] + c);
  };
  auto t = [](float v, float a, float b, float c) {
    return __fmul_rn(__fmul_rn(__fmul_rn(v, a), b), c);
  };
  float s = t(g(i0[0], i0[1], i0[2]), om[0], om[1], om[2]);
  s = __fadd_rn(s, t(g(i1[0], i0[1], i0[2]), w[0], om[1], om[2]));
  s = __fadd_rn(s, t(g(i0[0], i1[1], i0[2]), om[0], w[1], om[2]));
  s = __fadd_rn(s, t(g(i1[0], i1[1], i0[2]), w[0], w[1], om[2]));
  s = __fadd_rn(s, t(g(i0[0], i0[1], i1[2]), om[0], om[1], w[2]));
  s = __fadd_rn(s, t(g(i1[0], i0[1], i1[2]), w[0], om[1], w[2]));
  s = __fadd_rn(s, t(g(i0[0], i1[1], i1[2]), om[0], w[1], w[2]));
  return __fadd_rn(s, t(g(i1[0], i1[1], i1[2]), w[0], w[1], w[2]));
}

template <int D, int VDIM, int EPI>
__global__ void __launch_bounds__(BTB)
val_banded_kernel(const int* __restrict__ jlo, const int* __restrict__ ok,
                  const float* __restrict__ x, const float* __restrict__ muT,
                  const float* __restrict__ ppT,
                  const float* __restrict__ rad, const float* __restrict__ v,
                  const float* __restrict__ tlo,
                  const float* __restrict__ thi, float* __restrict__ out,
                  int* __restrict__ guard_failures, int* __restrict__ swept,
                  int nvalid, int N, int band, float clamp, float qcut,
                  Rk4 rk) {
  constexpr int NB = Dims<D>::NB;
  using S = StagedTile<D, VDIM>;
  __shared__ __align__(16) float stage[NSTAGE][S::FLOATS];
  __shared__ int list[BTB];
  __shared__ int wcount[NWARP];
  __shared__ int wspan[NWARP][2];
  __shared__ float wbox[NWARP][2 * D];
  const int nnt = N / BTN;
  const int i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = i * BTB + tid;
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

  //    the window: the caller's, or the tile's own by the same rule
  int j0 = 0, nj = nnt;
  if (jlo != nullptr) {
    if (*ok) {
      j0 = min(max(jlo[i], 0), nnt - band);
      nj = band;
    } else if (i == 0 && tid == 0) {
      *guard_failures += 1;
    }
  } else {
    // the first and the last tile whose x extent meets the queries'
    int first = nnt, last = -1;
#pragma unroll 4
    for (int j = tid; j < nnt; j += BTB)
      if (thi[j] >= qlo[0] && tlo[j] <= qhi[0]) {
        first = min(first, j);
        last = j;
      }
    for (int off = 16; off > 0; off >>= 1) {
      first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    }
    if (lane == 0) {
      wspan[warp][0] = first;
      wspan[warp][1] = last;
    }
    __syncthreads();
    for (int w = 0; w < NWARP; ++w) {
      first = min(first, wspan[w][0]);
      last = max(last, wspan[w][1]);
    }
    const int start = min(max(last >= 0 ? first : 0, 0), nnt - band);
    const bool covered = last < start + band;   // last = -1: none meets
    if (covered) {
      j0 = start;
      nj = band;
    }
    if (swept != nullptr && tid == 0) swept[i] = covered ? 0 : 1;
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

  // 4. the epilogue
  if constexpr (EPI == VALUE) {
#pragma unroll
    for (int a = 0; a < VDIM; ++a) out[VDIM * b + a] = acc[a];
  } else {
    static_assert(D == 3 && VDIM == 3, "the RK4 epilogues are 3D");
    float s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float wv = __fmul_rn(rk.weight, acc[k]);
      s[k] = rk.first ? wv : __fadd_rn(rk.total[3 * b + k], wv);
    }
    if constexpr (EPI == STAGE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rk.total[3 * b + k] = s[k];
        out[3 * b + k] =
            __fadd_rn(rk.x0[3 * b + k], __fmul_rn(rk.coef, acc[k]));
      }
    } else {
      const long long node = rk.offset + b;
      if (node < rk.nout) {
        float phi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          phi[k] = __fadd_rn(rk.x0[3 * b + k], __fmul_rn(rk.coef, s[k]));
        out[node] = sample(rk, phi);
      }
    }
  }
}

template <int EPI>
struct BandedLaunch {
  const int *jlo, *ok;
  const float *x, *mu, *pp, *rad, *v, *tlo, *thi;
  float* out;
  int *guard_failures, *swept;
  int B, nvalid, N, band;
  float clamp, qcut;
  Rk4 rk;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    val_banded_kernel<D, VDIM, EPI><<<dim3(B / BTB), dim3(BTB), 0, s>>>(
        jlo, ok, x, mu, pp, rad, v, tlo, thi, out, guard_failures, swept,
        nvalid, N, band, clamp, qcut, rk);
    return cudaGetLastError();
  }
};

bool bad_shape(int B, int nvalid, int N, int band) {
  return B < 0 || nvalid < 0 || nvalid > B || N < BTN || B % BTB ||
         N % BTN || band < 1 || band > N / BTN;
}

}  // namespace

extern "C" {

// The compiled tile sizes, so the Python side can refuse window starts
// computed for other tiles.
int banded_tile_sizes(int* tb, int* tn) {
  *tb = BTB;
  *tn = BTN;
  return 0;
}

// The sums (VALUE). jlo null: each block finds its own window, and swept
// (one int a query tile, or null) takes the tiles that swept the axis.
int gsr_value_banded(const void* jlo, const void* ok, const void* x,
                     const void* muT, const void* ppT, const void* rad,
                     const void* v, const void* tlo, const void* thi,
                     void* out, void* guard_failures, void* swept, int B,
                     int nvalid, int N, int d, int vdim, int band,
                     float clamp, float qcut, void* stream) {
  if (bad_shape(B, nvalid, N, band) || (d != 2 && d != 3) || vdim < 1 ||
      vdim > 3 || (jlo != nullptr && ok == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const BandedLaunch<VALUE> f{static_cast<const int*>(jlo),
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
                              static_cast<int*>(swept),
                              B, nvalid, N, band, clamp, qcut, Rk4{},
                              static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

// Stage `stage` (0-3) of the position-only RK4 at d = vdim = 3, each block
// on its own window: stages 0-2 write the next stage's points into out
// (B, 3) and the running sum into total (B, 3); stage 3 writes the sampled
// density into the volume out at nodes offset + b < nout. coef: dt/2,
// dt/2, dt, dt/6 in f32; shape (3,) the density's; frame (9,) lo, hi and
// the grid's spacing, in f32.
int gsr_value_banded_rk4(const void* x, const void* muT, const void* ppT,
                         const void* rad, const void* v, const void* tlo,
                         const void* thi, void* out, void* swept,
                         const void* x0, void* total, const void* density,
                         int B, int nvalid, int N, int band, int stage,
                         float clamp, float qcut, float coef,
                         long long offset, long long nout, const int* shape,
                         const float* frame, void* stream) {
  if (bad_shape(B, nvalid, N, band) || stage < 0 || stage > 3 ||
      (stage == 3 && (density == nullptr || offset < 0 ||
                      shape[0] < 1 || shape[1] < 1 || shape[2] < 1)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Rk4 rk{};
  rk.x0 = static_cast<const float*>(x0);
  rk.total = static_cast<float*>(total);
  rk.density = static_cast<const float*>(density);
  rk.offset = offset;
  rk.nout = nout;
  rk.coef = coef;
  rk.weight = stage == 1 || stage == 2 ? 2.f : 1.f;
  rk.first = stage == 0;
  for (int k = 0; k < 3; ++k) {
    rk.n[k] = stage == 3 ? shape[k] : 1;
    rk.lo[k] = frame[k];
    rk.hi[k] = frame[3 + k];
    rk.step[k] = frame[6 + k];
  }
  const int* none = nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float *mu = static_cast<const float*>(muT),
              *pp = static_cast<const float*>(ppT),
              *r = static_cast<const float*>(rad),
              *vv = static_cast<const float*>(v),
              *lo = static_cast<const float*>(tlo),
              *hi = static_cast<const float*>(thi);
  float* o = static_cast<float*>(out);
  int* sw = static_cast<int*>(swept);
  if (stage < 3)
    return BandedLaunch<STAGE>{none, none, xs, mu, pp, r, vv, lo, hi, o,
                               nullptr, sw, B, nvalid, N, band, clamp,
                               qcut, rk, s}.run<3, 3>();
  return BandedLaunch<SAMPLE>{none, none, xs, mu, pp, r, vv, lo, hi, o,
                              nullptr, sw, B, nvalid, N, band, clamp, qcut,
                              rk, s}.run<3, 3>();
}

}  // extern "C"
