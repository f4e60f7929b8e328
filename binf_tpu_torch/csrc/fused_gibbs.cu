// Whole-run collapsed Gibbs on the linear-regression posterior, one kernel.
//
// Replaces binf_tpu/ops/pallas/fused_gibbs.py::_kernel
// (fused_linreg_gibbs_run).  The TPU kernel holds a (8, BC) tile of chains
// with every d x d matrix entry a lane vector and walks a sequential grid
// axis of sweep blocks; here each thread owns one chain, keeps c and lambda
// in registers for the whole run and loops over all sweeps itself.  V, y,
// V^T V, V^T y, 1/v0 and mu0 are staged once into shared memory and read by
// every thread at the same address.  Each sweep:
//
//   1. SS = ||V c - y||^2 over the n data points;
//   2. lambda = Gamma(a + n/2, 1) / (b + SS/2), Marsaglia-Tsang over four
//      rounds, the reference's fallback d = shape - 1/3 if none accepts;
//   3. P = lambda V^T V + diag(1/v0), rhs = lambda V^T y + mu0/v0;
//   4. P = L L^T with the diagonal floored at 1e-20, unrolled for d <= 7;
//   5. mean = P^-1 rhs by two triangular solves, c = mean + L^-T z,
//
// in the order of fused_gibbs.py:111-180 (the plain version,
// ops/kernels/fused_gibbs.py, repeats it batched over chains).  Noise comes
// from Philox (philox.cuh::gibbs_noise) keyed by (chain, sweep), so the
// stream does not depend on tiling, or from staged arrays in the JAX
// host-noise layout.
//
// Bound: arithmetic.  A sweep is ~(2 d + 3) n + 25 + d^3/3 + 3 d^2 float
// operations (~450 at d = 4, n = 20), four logs, a sqrt per coefficient
// and ~5 Philox calls; the only device-memory traffic is the draws,
// (steps, C, d+1) float32 written once.  Each block stages a sweep's draws
// in shared memory and writes them as one contiguous run, so the stores
// coalesce.  One thread per chain gives 16,384 threads at the main shape:
// the dependent arithmetic of a chain is not hidden by other warps, so the
// kernel runs below the float32 peak, as K2 does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK5Threads = 128;
constexpr int kGammaRounds = 4;

struct GibbsData {
  const float* V;    // (n, DC) row-major
  const float* y;    // (n,)
  const float* vtv;  // (DC, DC) V^T V
  const float* vty;  // (DC,) V^T y
  const float* ipv;  // (DC,) 1 / prior variance
  const float* pm;   // (DC,) prior mean
  int n;
  float gamma_d;  // Marsaglia-Tsang d = a + n/2 - 1/3
  float gamma_c;  // 1 / sqrt(9 d)
  float rate;     // Gamma rate b
};

// Gamma(d + 1/3, 1) from four rounds of normals z and uniforms u; the
// first accepted round wins (fused_gibbs.py::_gamma_draw)
__device__ __forceinline__ float gamma_rounds(float d, float c, const float (&z)[4],
                                              const float (&u)[4]) {
  float out = d;
  bool done = false;
#pragma unroll
  for (int r = 0; r < kGammaRounds; ++r) {
    const float x = z[r];
    const float t = 1.0f + c * x;
    const float v = t * t * t;
    const float logv = logf(fmaxf(v, 1e-20f));
    const bool accept =
        v > 0.0f && logf(fmaxf(u[r], 1e-30f)) < 0.5f * x * x + d - d * v + d * logv;
    if (accept && !done) out = d * v;
    done = done || accept;
  }
  return out;
}

template <int DC>
__global__ void __launch_bounds__(kK5Threads)
fused_linreg_gibbs_kernel(GibbsData g, const float* __restrict__ q0, int n_chains,
                          int num_steps, uint64_t seed, const float* __restrict__ gz_in,
                          const float* __restrict__ gu_in, const float* __restrict__ cz_in,
                          float* __restrict__ draws) {
  constexpr int D = DC + 1;
  extern __shared__ float smem[];
  float* sV = smem;
  float* sy = sV + g.n * DC;
  float* svtv = sy + g.n;
  float* svty = svtv + DC * DC;
  float* sipv = svty + DC;
  float* spm = sipv + DC;
  float* sout = spm + DC;  // (kK5Threads, D): one sweep's draws of this block
  for (int i = threadIdx.x; i < g.n * DC; i += blockDim.x) sV[i] = g.V[i];
  for (int i = threadIdx.x; i < g.n; i += blockDim.x) sy[i] = g.y[i];
  for (int i = threadIdx.x; i < DC * DC; i += blockDim.x) svtv[i] = g.vtv[i];
  for (int i = threadIdx.x; i < DC; i += blockDim.x) {
    svty[i] = g.vty[i];
    sipv[i] = g.ipv[i];
    spm[i] = g.pm[i];
  }
  __syncthreads();

  const int c0 = blockIdx.x * blockDim.x;
  const int c = c0 + threadIdx.x;
  const bool live = c < n_chains;
  const int block_chains = min((int)blockDim.x, n_chains - c0);
  float coef[DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) coef[k] = live ? q0[(int64_t)c * D + k] : 0.0f;

  for (int s = 0; s < num_steps; ++s) {
    float gz[4], gu[4], cz[DC];
    if (gz_in != nullptr) {
      const int64_t base = (int64_t)s * 8 * n_chains + (live ? c : 0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        gz[r] = gz_in[base + (int64_t)r * n_chains];
        gu[r] = gu_in[base + (int64_t)r * n_chains];
      }
#pragma unroll
      for (int k = 0; k < DC; ++k) cz[k] = cz_in[base + (int64_t)k * n_chains];
    } else {
      gibbs_noise<DC>(seed, (uint32_t)c, (uint32_t)s, gz, gu, cz);
    }

    // 1-2: the precision given the coefficients
    float ss = 0.0f;
    for (int i = 0; i < g.n; ++i) {
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < DC; ++k) r += sV[i * DC + k] * coef[k];
      r -= sy[i];
      ss += r * r;
    }
    const float lam = gamma_rounds(g.gamma_d, g.gamma_c, gz, gu) / (g.rate + 0.5f * ss);

    // 3-4: P = L L^T, lower triangle, row by row
    float L[DC][DC];
#pragma unroll
    for (int i = 0; i < DC; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        float acc = lam * svtv[i * DC + k];
        if (i == k) acc += sipv[i];
#pragma unroll
        for (int m = 0; m < k; ++m) acc -= L[i][m] * L[k][m];
        L[i][k] = (i == k) ? sqrtf(fmaxf(acc, 1e-20f)) : acc / L[k][k];
      }
    }
    // 5: forward solve L w = rhs, back solves L^T mean = w and L^T x = z
    float w[DC];
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      float acc = lam * svty[i] + spm[i] * sipv[i];
#pragma unroll
      for (int m = 0; m < i; ++m) acc -= L[i][m] * w[m];
      w[i] = acc / L[i][i];
    }
    float mean[DC], x[DC];
#pragma unroll
    for (int i = DC - 1; i >= 0; --i) {
      float am = w[i], az = cz[i];
#pragma unroll
      for (int m = i + 1; m < DC; ++m) {
        am -= L[m][i] * mean[m];
        az -= L[m][i] * x[m];
      }
      mean[i] = am / L[i][i];
      x[i] = az / L[i][i];
    }
#pragma unroll
    for (int k = 0; k < DC; ++k) coef[k] = mean[k] + x[k];

    // the block's draws of this sweep are one contiguous run of
    // block_chains * D floats: stage them and store coalesced
#pragma unroll
    for (int k = 0; k < DC; ++k) sout[threadIdx.x * D + k] = coef[k];
    sout[threadIdx.x * D + DC] = lam;
    __syncthreads();
    float* out = draws + ((int64_t)s * n_chains + c0) * D;
    for (int j = threadIdx.x; j < block_chains * D; j += blockDim.x) out[j] = sout[j];
    __syncthreads();
  }
}

template <int DC>
cudaError_t launch(const GibbsData& g, const float* q0, int n_chains, int num_steps,
                   uint64_t seed, const float* gz, const float* gu, const float* cz,
                   float* draws, cudaStream_t stream, int* grid) {
  const size_t smem =
      (g.n * DC + g.n + DC * DC + 3 * DC + kK5Threads * (DC + 1)) * sizeof(float);
  const int blocks = (n_chains + kK5Threads - 1) / kK5Threads;
  grid[0] = blocks;
  grid[1] = kK5Threads;
  fused_linreg_gibbs_kernel<DC><<<blocks, kK5Threads, smem, stream>>>(
      g, q0, n_chains, num_steps, seed, gz, gu, cz, draws);
  return cudaGetLastError();
}

}  // namespace binf

extern "C" int binf_fused_linreg_gibbs(int d, const float* q0, const float* V,
                                       const float* y, const float* vtv, const float* vty,
                                       const float* ipv, const float* pm, int n,
                                       float gamma_d, float gamma_c, float rate,
                                       int n_chains, int num_steps, unsigned long long seed,
                                       const float* gz, const float* gu, const float* cz,
                                       float* draws, void* stream, int* grid) {
  const binf::GibbsData g{V, y, vtv, vty, ipv, pm, n, gamma_d, gamma_c, rate};
  cudaStream_t s = (cudaStream_t)stream;
#define BINF_K5(DC) \
  case DC:          \
    return (int)binf::launch<DC>(g, q0, n_chains, num_steps, seed, gz, gu, cz, draws, s, grid);
  switch (d) {
    BINF_K5(1)
    BINF_K5(2)
    BINF_K5(3)
    BINF_K5(4)
    BINF_K5(5)
    BINF_K5(6)
    BINF_K5(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BINF_K5
}
