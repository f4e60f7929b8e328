// Whole-run fixed-L HMC on the linear-regression posterior, one kernel.
//
// Replaces binf_tpu/ops/pallas/fused_hmc.py::_kernel (fused_linreg_hmc_run).
// The TPU kernel holds a (8, BC) tile of chains in VMEM and walks a
// sequential grid axis of step blocks; here each thread owns one chain,
// keeps q, p and grad U in registers for the whole run, and loops over all
// num_steps itself.  V, y and the prior rows are staged once into shared
// memory (linreg_density.cuh).  Noise comes from Philox (philox.cuh) keyed
// by (chain, step), or from staged arrays in the JAX host-noise layout.
//
// Bound: arithmetic.  Each step is L + 1 density evaluations of
// ~(4 d + 3) n float operations (about 410 at d = 4, n = 20) plus Philox;
// the only device-memory traffic is the draws, (num_steps, C, d+1) float32
// written once.  Those stores are only partly coalesced (each thread writes
// d+1 consecutive floats, a 20-byte stride between neighbours); they take
// far less time than the arithmetic, so that is left as it is.  One thread
// per chain gives 16,384 threads at the main shape, about 6% of the card's
// thread slots: each warp's dependent arithmetic is not hidden by other
// warps, so the kernel runs well below the float32 peak.  Splitting the
// data axis of a chain across threads is the way to fill the card.
//
// Accept rule: log u < E0 - E1 with no divergence guard, as the TPU kernel.
// Per-chain accept counts are written as int32 and summed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"
#include "hmc.cuh"
#include "linreg_density.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK2Threads = 64;

template <int DC>
__global__ void __launch_bounds__(kK2Threads)
fused_linreg_hmc_kernel(LinregDensity<DC> dens, const float* __restrict__ q0,
                        const float* __restrict__ im_in,
                        const float* __restrict__ eps_in, int n_chains,
                        int num_steps, int num_leapfrog, uint64_t seed,
                        const float* __restrict__ mom, const float* __restrict__ unif,
                        float* __restrict__ draws, int* __restrict__ accepts) {
  constexpr int D = DC + 1;
  extern __shared__ float smem[];
  dens.stage(smem);
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;

  const float eps = *eps_in;
  float q[D], im[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    q[k] = q0[(int64_t)c * D + k];
    im[k] = im_in[k];
  }
  int n_acc = 0;
  for (int s = 0; s < num_steps; ++s) {
    float z[D], u;
    if (mom != nullptr)
      staged_noise<D>(mom, unif, 8, n_chains, c, s, z, u);
    else
      step_noise<D>(seed, kTagSample, (uint32_t)c, (uint32_t)s, z, u);
    float q_new[D];
    const float dE = leapfrog_trajectory(dens, q, z, eps, im, num_leapfrog, q_new);
    if (logf(fmaxf(u, 1e-30f)) < dE) {
#pragma unroll
      for (int k = 0; k < D; ++k) q[k] = q_new[k];
      ++n_acc;
    }
    float* out = draws + ((int64_t)s * n_chains + c) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = q[k];
  }
  accepts[c] = n_acc;
}

template <int DC>
cudaError_t launch(const float* q0, const float* V, const float* y, const float* ipv,
                   const float* pm, int n, float half_n_plus_a, float rate,
                   const float* eps, const float* im, int n_chains, int num_steps, int num_leapfrog,
                   uint64_t seed, const float* mom, const float* unif, float* draws,
                   int* accepts, cudaStream_t stream) {
  LinregDensity<DC> dens{V, y, ipv, pm, n, half_n_plus_a, rate};
  const size_t smem = LinregDensity<DC>::smem_floats(n) * sizeof(float);
  const int blocks = (n_chains + kK2Threads - 1) / kK2Threads;
  fused_linreg_hmc_kernel<DC><<<blocks, kK2Threads, smem, stream>>>(
      dens, q0, im, eps, n_chains, num_steps, num_leapfrog, seed, mom, unif, draws,
      accepts);
  return cudaGetLastError();
}

}  // namespace binf

extern "C" int binf_fused_linreg_hmc(int d, const float* q0, const float* V,
                                     const float* y, const float* ipv, const float* pm,
                                     int n, float half_n_plus_a, float rate,
                                     const float* eps, const float* im, int n_chains, int num_steps,
                                     int num_leapfrog, unsigned long long seed,
                                     const float* mom, const float* unif, float* draws,
                                     int* accepts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BINF_K2(DC)                                                                   \
  case DC:                                                                            \
    return (int)binf::launch<DC>(q0, V, y, ipv, pm, n, half_n_plus_a, rate, eps, im, \
                                 n_chains, num_steps, num_leapfrog, seed, mom, unif, \
                                 draws, accepts, s);
  switch (d) {
    BINF_K2(1)
    BINF_K2(2)
    BINF_K2(3)
    BINF_K2(4)
    BINF_K2(5)
    BINF_K2(6)
    BINF_K2(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BINF_K2
}
