// Whole-run HMC for any device density, one kernel: the general sampling
// kernel.
//
// Replaces binf_tpu/ops/pallas/fused_potential.py::_kernel
// (fused_potential_hmc_run), which runs a traced potential on a (D_pad, BC)
// tile over a sequential grid of step blocks.  Here each thread owns one
// chain, keeps q, p and grad U in registers for the whole run and loops over
// all steps; the functor's data (densities.cuh) sits in shared memory.
// What it adds to the linear-regression kernel (fused_hmc.cu):
//
// - per-chain step sizes and a per-chain diagonal metric, or a dense metric
//   shared by all chains (p = W z, velocity M^-1 p; minv and W in shared
//   memory, read as broadcasts);
// - the divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects;
// - thinning (every thin-th state is stored), or per-chain Welford moments
//   over the call's steps instead of draws;
// - ChEES: step t runs ceil(h[t % 256] * 2 T / eps) leapfrog steps, clipped
//   to [1, max_leapfrog], with T and eps those of the first chain of the
//   chain's block_chains tile, so every chain of a tile shares one loop
//   bound (a warp holding one tile does not diverge); lane 0 of a tile may
//   record the counts;
// - resume: the Philox counter's step is step_offset + t, where the caller
//   passes block_offset * steps_per_block, so chained calls replay one
//   uninterrupted call bit for bit.
//
// Bound: arithmetic, (L + 1) density evaluations per chain and step plus
// Philox, as fused_hmc.cu; the draws (num_steps / thin, C, D) are the only
// large device-memory traffic.  One thread per chain leaves most of the
// card's thread slots empty at 16,384 chains, so dependent float32 latency
// is exposed; splitting a chain's data axis across threads is the way to
// fill the card.  Per-chain accept counts are written as int32 and summed
// by the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "c_api.cuh"
#include "densities.cuh"
#include "hmc.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK4Threads = 64;
constexpr int kHaltonLen = 256;

// Everything but the density; binf_tpu_torch/ops/kernels/fused_potential.py
// fills the same struct through ctypes.
struct RunArgs {
  const float* q0;   // (C, D)
  const float* eps;  // (C,)
  const float* im;   // (C, D) diagonal, or (D, D) M^-1 when dense
  const float* W;    // (D, D), dense only
  int n_chains, num_steps, num_leapfrog, thin, moments, dense, chees, bc, max_leapfrog;
  uint32_t step_offset;     // block_offset * steps_per_block
  uint64_t seed;
  const float* T_tile;      // (tiles,), ChEES only
  const float* eps_tile;    // (tiles,), ChEES only
  const float* halton;      // (256,), ChEES only
  const float* mom;         // staged noise (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad;
  float* draws;             // (num_steps / thin, C, D), unless moments
  float* mean;              // (C, D), moments only
  float* m2;                // (C, D), moments only
  float* qf;                // (C, D)
  int* accepts;             // (C,)
  int* leap_out;            // (num_steps, tiles) leapfrog counts, or null
};

template <class Density, bool Dense>
__global__ void __launch_bounds__(kK4Threads)
fused_potential_kernel(Density dens, const RunArgs a) {
  constexpr int D = Density::D;
  using Metric = typename std::conditional<Dense, DenseMetric<D>, DiagMetric<D>>::type;
  extern __shared__ float smem[];
  float* const s_halton = smem + dens.shared_floats();
  float* const s_minv = s_halton + kHaltonLen;
  float* const s_W = s_minv + D * D;
  dens.stage(smem);
  if (a.chees)
    for (int i = threadIdx.x; i < kHaltonLen; i += blockDim.x) s_halton[i] = a.halton[i];
  if (Dense)
    for (int i = threadIdx.x; i < D * D; i += blockDim.x) {
      s_minv[i] = a.im[i];
      s_W[i] = a.W[i];
    }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.n_chains) return;

  Metric metric;
  if constexpr (Dense) {
    metric.minv = s_minv;
    metric.W = s_W;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) metric.im[k] = a.im[(int64_t)c * D + k];
  }
  const float eps = a.eps[c];
  const int tile = c / a.bc;
  const bool records = a.leap_out != nullptr && c % a.bc == 0;
  const int tiles = a.n_chains / a.bc;
  const float T = a.chees ? a.T_tile[tile] : 0.0f;
  const float eps_L = a.chees ? a.eps_tile[tile] : 1.0f;
  float q[D], mean[D], m2[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    q[k] = a.q0[(int64_t)c * D + k];
    mean[k] = 0.0f;
    m2[k] = 0.0f;
  }
  int n_acc = 0;
  for (int t = 0; t < a.num_steps; ++t) {
    float z[D], u;
    if (a.mom != nullptr)
      staged_noise<D>(a.mom, a.unif, a.d_pad, a.n_chains, c, t, z, u);
    else
      step_noise<D>(a.seed, kTagRun, (uint32_t)c, a.step_offset + (uint32_t)t, z, u);
    int n_leap = a.num_leapfrog;
    if (a.chees) {
      n_leap = chees_leapfrog(s_halton[t % kHaltonLen], T, eps_L, a.max_leapfrog);
      if (records) a.leap_out[(int64_t)t * tiles + tile] = n_leap;
    }
    float q_new[D], p_end[D];
    float dE = leapfrog_trajectory(dens, metric, q, z, eps, n_leap, q_new, p_end);
    if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
    if (logf(fmaxf(u, 1e-30f)) < dE) {
#pragma unroll
      for (int k = 0; k < D; ++k) q[k] = q_new[k];
      ++n_acc;
    }
    if (a.moments) {
      // streaming Welford over the call's steps
      const float n = (float)(t + 1);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float delta = q[k] - mean[k];
        mean[k] = mean[k] + delta / n;
        m2[k] = m2[k] + delta * (q[k] - mean[k]);
      }
    } else if (t % a.thin == a.thin - 1) {
      float* out = a.draws + ((int64_t)(t / a.thin) * a.n_chains + c) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) out[k] = q[k];
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    a.qf[(int64_t)c * D + k] = q[k];
    if (a.moments) {
      a.mean[(int64_t)c * D + k] = mean[k];
      a.m2[(int64_t)c * D + k] = m2[k];
    }
  }
  a.accepts[c] = n_acc;
}

template <class Density>
cudaError_t launch(const Density& dens, const RunArgs& a, cudaStream_t stream) {
  constexpr int D = Density::D;
  if (a.bc <= 0 || a.n_chains % a.bc != 0 || a.thin <= 0) return cudaErrorInvalidValue;
  const size_t smem = (dens.shared_floats() + kHaltonLen + 2 * D * D) * sizeof(float);
  const int blocks = (a.n_chains + kK4Threads - 1) / kK4Threads;
  if (a.dense)
    fused_potential_kernel<Density, true><<<blocks, kK4Threads, smem, stream>>>(dens, a);
  else
    fused_potential_kernel<Density, false><<<blocks, kK4Threads, smem, stream>>>(dens, a);
  return cudaGetLastError();
}

}  // namespace binf

extern "C" int binf_fused_potential_hmc(int family, int D, const binf::DensityOperands* ops,
                                        const binf::RunArgs* args, void* stream) {
  return (int)binf::with_density(family, D, *ops, [&](auto dens) {
    return binf::launch(dens, *args, (cudaStream_t)stream);
  });
}
