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
// _val_tile takes it. Queries and Gaussians are both sorted along x, so
// the rows that can reach a query tile form one contiguous window of
// `band` Gaussian tiles, starting at jlo[i] (clamped into
// [0, N/BTN - band], as the TPU kernel's index maps clamp it).
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
// rows); v (N, VDIM); out (B, VDIM).
//
// What bounds it on an H100. At the production chunk (B = 262,144 grid
// nodes, N = 75,776 rows at Ring-Collide width) a window holds some 10^4
// rows, so a launch evaluates ~3e9 pairs at ~22 f32 operations each for
// the geometry, with a few MB of inputs: it is bound by operations (~1 ms
// at the 67 TFLOP/s f32 peak), not by bytes. The design keeps every pair
// on the CUDA cores with nothing leaving the chip: one thread per query
// (BTB queries a block), the window's Gaussians staged BTN at a time
// through shared memory and read there as broadcasts, the VDIM sums in
// registers, accumulated in ascending row order with no atomics. A pair
// whose quad exceeds qcut skips its exp and accumulation: qcut lies far
// enough above -2 ln c that such a pair has g < c for certain, so the
// skip changes no result.

#include "gsr_tile.cuh"

namespace {

using namespace gsr;

constexpr int BTB = 128;   // queries per tile: one thread each
constexpr int BTN = 64;    // Gaussians staged in shared memory at a time
constexpr int SLOTS = 16;  // floats per staged Gaussian: mu, P, bias | v

// Slot layout of one staged Gaussian: [0, D) mu; [D, 2D) P_kk;
// [2D, D + NB) 2 P_ij; D + NB the bias; [12, 12 + VDIM) v.
constexpr int VSLOT = 12;

template <int D, int VDIM>
__global__ void __launch_bounds__(BTB)
val_banded_kernel(const int* __restrict__ jlo, const int* __restrict__ ok,
                  const float* __restrict__ x, const float* __restrict__ muT,
                  const float* __restrict__ ppT, const float* __restrict__ v,
                  float* __restrict__ out, int* __restrict__ guard_failures,
                  int N, int band, float clamp, float qcut) {
  constexpr int NB = Dims<D>::NB;
  __shared__ float4 tile[BTN][SLOTS / 4];
  float* const flat = reinterpret_cast<float*>(tile);
  const int nnt = N / BTN;
  const int i = blockIdx.x;
  const int b = i * BTB + threadIdx.x;
  int j0 = 0, nj = nnt;
  if (*ok) {
    j0 = min(max(jlo[i], 0), nnt - band);
    nj = band;
  } else if (i == 0 && threadIdx.x == 0) {
    *guard_failures += 1;
  }
  float xq[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[D * b + k];
  float acc[VDIM];
#pragma unroll
  for (int a = 0; a < VDIM; ++a) acc[a] = 0.f;

  for (int j = j0; j < j0 + nj; ++j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BTN * SLOTS; e += BTB) {
      const int f = e / BTN, n = e % BTN, gn = j * BTN + n;
      float val = 0.f;
      if (f < D) {
        val = muT[f * N + gn];
      } else if (f < D + NB) {
        val = ppT[(f - D) * N + gn];
        if (f >= 2 * D) val *= 2.f;  // exact: the TPU kernel's 2 P_ij
      } else if (f == D + NB) {
        val = ppT[NB * N + gn];
      } else if (f >= VSLOT && f < VSLOT + VDIM) {
        val = v[gn * VDIM + f - VSLOT];
      }
      flat[n * SLOTS + f] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BTN; ++n) {
      const float4 t0 = tile[n][0], t1 = tile[n][1], t2 = tile[n][2];
      const float s[12] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y,
                           t1.z, t1.w, t2.x, t2.y, t2.z, t2.w};
      float dx[D];
#pragma unroll
      for (int k = 0; k < D; ++k) dx[k] = xq[k] - s[k];
      float quad = s[D + NB] + s[D] * dx[0] * dx[0];
#pragma unroll
      for (int k = 1; k < D; ++k) quad += s[D + k] * dx[k] * dx[k];
#pragma unroll
      for (int c = 0; c < Dims<D>::NOFF; ++c)
        quad += s[2 * D + c] * dx[pair_i<D>(c)] * dx[pair_j<D>(c)];
      if (quad > qcut) continue;  // g < c for certain
      const float g = expf(-0.5f * quad);
      if (g >= clamp) {
        const float gc = g - clamp;
        const float4 t3 = tile[n][3];
        const float w[3] = {t3.x, t3.y, t3.z};
#pragma unroll
        for (int a = 0; a < VDIM; ++a) acc[a] += gc * w[a];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < VDIM; ++a) out[VDIM * b + a] = acc[a];
}

struct BandedLaunch {
  const int *jlo, *ok;
  const float *x, *mu, *pp, *v;
  float* out;
  int* guard_failures;
  int B, N, band;
  float clamp, qcut;
  cudaStream_t s;
  template <int D, int VDIM>
  int run() const {
    val_banded_kernel<D, VDIM><<<dim3(B / BTB), dim3(BTB), 0, s>>>(
        jlo, ok, x, mu, pp, v, out, guard_failures, N, band, clamp, qcut);
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
                     const void* muT, const void* ppT, const void* v,
                     void* out, void* guard_failures, int B, int N, int d,
                     int vdim, int band, float clamp, float qcut,
                     void* stream) {
  if (B < 0 || N < BTN || B % BTB || N % BTN || band < 1 ||
      band > N / BTN || (d != 2 && d != 3) || vdim < 1 || vdim > 3)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const BandedLaunch f{static_cast<const int*>(jlo),
                       static_cast<const int*>(ok),
                       static_cast<const float*>(x),
                       static_cast<const float*>(muT),
                       static_cast<const float*>(ppT),
                       static_cast<const float*>(v),
                       static_cast<float*>(out),
                       static_cast<int*>(guard_failures),
                       B, N, band, clamp, qcut,
                       static_cast<cudaStream_t>(stream)};
  return dispatch(d, vdim, f);
}

}  // extern "C"
