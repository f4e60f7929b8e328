// Stan-window warmup in one kernel: step-size search, pooled dual
// averaging and a windowed cross-chain diagonal metric.
//
// Replaces binf_tpu/ops/pallas/fused_potential.py::_warmup_kernel
// (fused_warmup_run), fixed-length trajectories with the optional
// init_search.  Statistics pool over the chains of one tile of
// block_chains, as on the TPU, and each step needs three sums over the
// tile: the mean acceptance, the per-coordinate mean and (in slow windows)
// the per-coordinate sum of squared deviations.  One block runs one tile;
// each thread walks the tile's chains in strides of blockDim.x, keeps one
// chain at a time in registers, and the positions stay in the output array
// between steps.  The sums go through shared memory (hmc.cuh::block_sum),
// and every thread then applies the same per-tile update to its own copy
// of the adaptation state, so no thread waits for another to broadcast.
//
// Bound: arithmetic, (L + 1) density evaluations per chain and step as in
// fused_hmc.cu, plus two block-wide barriers per step.  With one block per
// tile, a run that pools all chains in one tile (the main path: 16,384
// chains in one tile) runs on one of the card's 132 SMs, so its time is one
// SM's share of the arithmetic.  A cooperative launch with a grid barrier,
// or a thread-block cluster, would spread one tile over the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"
#include "hmc.cuh"
#include "linreg_density.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK3Threads = 512;
constexpr int kSearchTrials = 20;  // doubling budget of the step-size search
constexpr int kMaxResets = 64;

template <class Density>
struct TileRun {
  static constexpr int D = Density::D;
  const Density& dens;
  const float* q0;
  float* q;  // (C, D) working positions, the kernel's output
  int tile_start, bc, n_chains, num_leapfrog;
  uint64_t seed;
  const float* mom;
  const float* unif;
  int d_pad;
  float* red;

  // noise of one chain: staged (host-noise layout) or Philox
  __device__ void noise(int c, uint32_t tag, int philox_step, int staged_step,
                        float (&z)[D], float& u) const {
    if (mom != nullptr)
      staged_noise<D>(mom, unif, d_pad, n_chains, c, staged_step, z, u);
    else
      step_noise<D>(seed, tag, (uint32_t)c, (uint32_t)philox_step, z, u);
  }

  // Tile-pooled acceptance probability of one trajectory from q0 at the
  // identity metric (positions do not advance): the search's criterion.
  __device__ float pooled_alpha(float log_eps, int trial) const {
    const float eps = expf(log_eps);
    float im[D];
#pragma unroll
    for (int k = 0; k < D; ++k) im[k] = 1.0f;
    float a_sum[1] = {0.0f};
    for (int local = threadIdx.x; local < bc; local += blockDim.x) {
      const int c = tile_start + local;
      float qc[D], z[D], u, q_new[D];
#pragma unroll
      for (int k = 0; k < D; ++k) qc[k] = q0[(int64_t)c * D + k];
      noise(c, kTagSearch, trial, trial, z, u);
      float dE = leapfrog_trajectory(dens, qc, z, eps, im, num_leapfrog, q_new);
      if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
      a_sum[0] += fminf(1.0f, expf(fminf(dE, 0.0f)));
    }
    block_sum<1>(a_sum, red);
    return a_sum[0] / (float)bc;
  }
};

template <class Density>
__global__ void __launch_bounds__(kK3Threads)
fused_warmup_kernel(Density dens, const float* __restrict__ q0, int n_chains, int bc,
                    int num_warmup, int num_leapfrog, float eps0, float target_accept,
                    int init_search, int initial_buffer, int final_buffer,
                    const int* __restrict__ resets, int n_resets, uint64_t seed,
                    const float* __restrict__ mom, const float* __restrict__ unif,
                    int d_pad, float* __restrict__ q, float* __restrict__ eps_out,
                    float* __restrict__ im_out) {
  constexpr int D = Density::D;
  constexpr float kLog10 = 2.30258512f, kLog2 = 0.693147182f;
  __shared__ float red[32 * (D + 1)];
  __shared__ int s_resets[kMaxResets];
  extern __shared__ float smem[];
  dens.stage(smem);
  for (int r = threadIdx.x; r < n_resets; r += blockDim.x) s_resets[r] = resets[r];
  const int tile_start = blockIdx.x * bc;
  for (int i = threadIdx.x; i < bc * D; i += blockDim.x)
    q[(int64_t)tile_start * D + i] = q0[(int64_t)tile_start * D + i];
  __syncthreads();

  const TileRun<Density> run{dens, q0, q, tile_start, bc, n_chains, num_leapfrog,
                             seed, mom, unif, d_pad, red};

  float log_eps0 = logf(eps0);
  if (init_search) {
    // Hoffman & Gelman 2011, Algorithm 4: double or halve eps until the
    // pooled acceptance probability crosses 0.5, within a fixed budget.
    // The branch is uniform over the block (p is a block-wide sum).
    float p = run.pooled_alpha(log_eps0, 0);
    const float direction = p > 0.5f ? 1.0f : -1.0f;
    bool done = false;
    for (int t = 0; t < kSearchTrials; ++t) {
      done = done || direction * (0.5f - p) >= 0.0f;
      if (done) break;
      log_eps0 = log_eps0 + direction * kLog2;
      p = run.pooled_alpha(log_eps0, t + 1);
    }
  }

  // per-tile adaptation state, one identical copy in every thread
  float log_step = log_eps0, log_step_avg = 0.0f, grad_avg = 0.0f, count = 0.0f;
  float mu = kLog10 + log_eps0;
  float wf_n = 0.0f, wf_mean[D], wf_m2[D], im[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    wf_mean[k] = 0.0f;
    wf_m2[k] = 0.0f;
    im[k] = 1.0f;
  }
  const int noise_off = init_search ? kSearchTrials + 1 : 0;
  const float nb = (float)bc;

  for (int t = 0; t < num_warmup; ++t) {
    const float eps = expf(log_step);
    float sums[D + 1];  // sum of q per coordinate, then sum of alpha
#pragma unroll
    for (int k = 0; k <= D; ++k) sums[k] = 0.0f;
    for (int local = threadIdx.x; local < bc; local += blockDim.x) {
      const int c = tile_start + local;
      float qc[D], z[D], u, q_new[D];
#pragma unroll
      for (int k = 0; k < D; ++k) qc[k] = q[(int64_t)c * D + k];
      run.noise(c, kTagWarmup, t, noise_off + t, z, u);
      float dE = leapfrog_trajectory(dens, qc, z, eps, im, num_leapfrog, q_new);
      // divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects
      if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
      if (logf(fmaxf(u, 1e-30f)) < dE) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          qc[k] = q_new[k];
          q[(int64_t)c * D + k] = qc[k];
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) sums[k] += qc[k];
      sums[D] += fminf(1.0f, expf(fminf(dE, 0.0f)));
    }
    block_sum<D + 1>(sums, red);

    // pooled dual averaging (Stan constants)
    const float a_mean = sums[D] / nb;
    count = count + 1.0f;
    const float w = 1.0f / (count + 10.0f);
    grad_avg = (1.0f - w) * grad_avg + w * (target_accept - a_mean);
    log_step = mu - sqrtf(count) / 0.05f * grad_avg;
    const float eta = powf(count, -0.75f);
    log_step_avg = eta * log_step + (1.0f - eta) * log_step_avg;

    // cross-chain Welford fold (Chan combine) during slow windows
    if (t >= initial_buffer && t < num_warmup - final_buffer) {
      float bm[D], bm2[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        bm[k] = sums[k] / nb;
        bm2[k] = 0.0f;
      }
      for (int local = threadIdx.x; local < bc; local += blockDim.x) {
        const int c = tile_start + local;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float dev = q[(int64_t)c * D + k] - bm[k];
          bm2[k] += dev * dev;
        }
      }
      block_sum<D>(bm2, red);
      const float n_new = wf_n + nb;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float delta = bm[k] - wf_mean[k];
        wf_mean[k] = wf_mean[k] + delta * (nb / n_new);
        wf_m2[k] = wf_m2[k] + bm2[k] + delta * delta * (wf_n * nb / n_new);
      }
      wf_n = n_new;
    }

    // window boundary: harvest the regularised variance into the metric,
    // restart Welford and dual averaging at the current step size
    bool is_reset = false;
    for (int r = 0; r < n_resets; ++r) is_reset = is_reset || s_resets[r] == t;
    if (is_reset) {
      const float wv = wf_n / (wf_n + 5.0f);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = wf_m2[k] / fmaxf(wf_n - 1.0f, 1.0f);
        im[k] = wv * v + (1.0f - wv) * 1e-3f;
        wf_mean[k] = 0.0f;
        wf_m2[k] = 0.0f;
      }
      wf_n = 0.0f;
      mu = kLog10 + log_step;
      log_step_avg = 0.0f;
      grad_avg = 0.0f;
      count = 0.0f;
    }
  }

  const float eps_final = expf(log_step_avg);
  for (int local = threadIdx.x; local < bc; local += blockDim.x) {
    const int c = tile_start + local;
    eps_out[c] = eps_final;
#pragma unroll
    for (int k = 0; k < D; ++k) im_out[(int64_t)c * D + k] = im[k];
  }
}

template <int DC>
cudaError_t launch(const float* q0, const float* V, const float* y, const float* ipv,
                   const float* pm, int n, float half_n_plus_a, float rate, int n_chains,
                   int bc, int num_warmup, int num_leapfrog, float eps0,
                   float target_accept, int init_search, int initial_buffer,
                   int final_buffer, const int* resets, int n_resets, uint64_t seed,
                   const float* mom, const float* unif, int d_pad, float* q,
                   float* eps_out, float* im_out, cudaStream_t stream) {
  using Density = LinregDensity<DC>;
  if (n_resets > kMaxResets || n_chains % bc != 0) return cudaErrorInvalidValue;
  Density dens{V, y, ipv, pm, n, half_n_plus_a, rate};
  const size_t smem = Density::smem_floats(n) * sizeof(float);
  const int threads = bc < kK3Threads ? (bc + 31) / 32 * 32 : kK3Threads;
  fused_warmup_kernel<Density><<<n_chains / bc, threads, smem, stream>>>(
      dens, q0, n_chains, bc, num_warmup, num_leapfrog, eps0, target_accept,
      init_search, initial_buffer, final_buffer, resets, n_resets, seed, mom, unif,
      d_pad, q, eps_out, im_out);
  return cudaGetLastError();
}

}  // namespace binf

extern "C" int binf_fused_warmup(int d, const float* q0, const float* V, const float* y,
                                 const float* ipv, const float* pm, int n,
                                 float half_n_plus_a, float rate, int n_chains, int bc,
                                 int num_warmup, int num_leapfrog, float eps0,
                                 float target_accept, int init_search,
                                 int initial_buffer, int final_buffer, const int* resets,
                                 int n_resets, unsigned long long seed, const float* mom,
                                 const float* unif, int d_pad, float* q, float* eps_out,
                                 float* im_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BINF_K3(DC)                                                                     \
  case DC:                                                                              \
    return (int)binf::launch<DC>(q0, V, y, ipv, pm, n, half_n_plus_a, rate, n_chains,  \
                                 bc, num_warmup, num_leapfrog, eps0, target_accept,    \
                                 init_search, initial_buffer, final_buffer, resets,    \
                                 n_resets, seed, mom, unif, d_pad, q, eps_out, im_out, \
                                 s);
  switch (d) {
    BINF_K3(1)
    BINF_K3(2)
    BINF_K3(3)
    BINF_K3(4)
    BINF_K3(5)
    BINF_K3(6)
    BINF_K3(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BINF_K3
}
