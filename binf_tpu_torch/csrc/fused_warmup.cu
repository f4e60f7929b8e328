// Stan-window warmup in one kernel: step-size search, pooled dual
// averaging, a windowed cross-chain diagonal metric and, with ChEES, the
// trajectory length.
//
// Replaces binf_tpu/ops/pallas/fused_potential.py::_warmup_kernel
// (fused_warmup_run): fixed-length trajectories with the optional
// init_search, or ChEES trajectories (:595-649, :716-724) whose mean length
// T is adapted by Adam on the tile-pooled ChEES surrogate gradient.
// Statistics pool over the chains of one tile of block_chains, as on the
// TPU, and each step needs sums over the tile: the mean acceptance, the
// per-coordinate mean and (in slow windows) the per-coordinate sum of
// squared deviations; ChEES adds the means of the start and end positions
// and, in a second pass over the tile, the sum of the per-chain surrogate
// gradients.  One block runs one tile; each thread walks the tile's chains
// in strides of blockDim.x, keeps one chain at a time in registers, and the
// positions stay in the output array between steps (ChEES keeps each
// chain's start, end point, end momentum and acceptance in a scratch array
// between its two passes).  The sums go through shared memory
// (hmc.cuh::block_sum, one fixed order), and every thread then applies the
// same per-tile update to its own copy of the adaptation state, so no
// thread waits for another to broadcast.  Every chain of a tile runs the
// same number of leapfrog steps, so the ChEES loop bound is uniform.
//
// Bound: arithmetic, (L + 1) density evaluations per chain and step as in
// fused_hmc.cu, plus two (ChEES: four) block-wide barriers per step.  With
// one block per tile, a run that pools all chains in one tile (the main
// path: 16,384 chains in one tile) runs on one of the card's 132 SMs, so
// its time is one SM's share of the arithmetic.  A cooperative launch with
// a grid barrier, or a thread-block cluster, would spread one tile over the
// card.
//
// The density is any functor of densities.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"
#include "densities.cuh"
#include "hmc.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK3Threads = 512;
constexpr int kSearchTrials = 20;  // doubling budget of the step-size search
constexpr int kMaxResets = 64;
constexpr int kHaltonLen = 256;  // jitter table of the ChEES trajectories

// Everything but the density; binf_tpu_torch/ops/kernels/fused_potential.py
// fills the same struct through ctypes.
struct WarmupArgs {
  const float* q0;  // (C, D)
  int n_chains, bc, num_warmup, num_leapfrog;
  float eps0, target_accept;
  int init_search, initial_buffer, final_buffer;
  const int* resets;
  int n_resets;
  uint64_t seed;
  const float* mom;  // staged noise (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad;
  int chees, max_leapfrog;
  float log_max_leapfrog;  // float32 log(max_leapfrog), as the reference adds it
  const float* halton;     // (256,), ChEES only
  float* scratch;          // (C, 3 D + 1), ChEES only
  int* leap_out;           // (num_warmup, tiles) leapfrog counts, or null
  float* q;                // outputs: (C, D), (C,), (C, D), (C,) (T, ChEES only)
  float* eps_out;
  float* im_out;
  float* T_out;
};

template <class Density>
struct TileRun {
  static constexpr int D = Density::D;
  const Density& dens;
  const WarmupArgs& a;
  int tile_start;
  float* red;

  // noise of one chain: staged (host-noise layout) or Philox
  __device__ void noise(int c, uint32_t tag, int philox_step, int staged_step,
                        float (&z)[D], float& u) const {
    if (a.mom != nullptr)
      staged_noise<D>(a.mom, a.unif, a.d_pad, a.n_chains, c, staged_step, z, u);
    else
      step_noise<D>(a.seed, tag, (uint32_t)c, (uint32_t)philox_step, z, u);
  }

  // Tile-pooled acceptance probability of one trajectory from q0 at the
  // identity metric (positions do not advance): the search's criterion.
  __device__ float pooled_alpha(float log_eps, int trial) const {
    const float eps = expf(log_eps);
    float im[D];
#pragma unroll
    for (int k = 0; k < D; ++k) im[k] = 1.0f;
    float a_sum[1] = {0.0f};
    for (int local = threadIdx.x; local < a.bc; local += blockDim.x) {
      const int c = tile_start + local;
      float qc[D], z[D], u, q_new[D];
#pragma unroll
      for (int k = 0; k < D; ++k) qc[k] = a.q0[(int64_t)c * D + k];
      noise(c, kTagSearch, trial, trial, z, u);
      float dE = leapfrog_trajectory(dens, qc, z, eps, im, a.num_leapfrog, q_new);
      if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
      a_sum[0] += fminf(1.0f, expf(fminf(dE, 0.0f)));
    }
    block_sum<1>(a_sum, red);
    return a_sum[0] / (float)a.bc;
  }
};

template <class Density>
__global__ void __launch_bounds__(kK3Threads)
fused_warmup_kernel(Density dens, const WarmupArgs a) {
  constexpr int D = Density::D;
  constexpr float kLog10 = 2.30258512f, kLog2 = 0.693147182f;
  __shared__ float red[32 * (2 * D)];
  __shared__ int s_resets[kMaxResets];
  __shared__ float s_halton[kHaltonLen];
  extern __shared__ float smem[];
  dens.stage(smem);
  for (int r = threadIdx.x; r < a.n_resets; r += blockDim.x) s_resets[r] = a.resets[r];
  if (a.chees)
    for (int i = threadIdx.x; i < kHaltonLen; i += blockDim.x) s_halton[i] = a.halton[i];
  const int tile_start = blockIdx.x * a.bc;
  float* const q = a.q;
  for (int i = threadIdx.x; i < a.bc * D; i += blockDim.x)
    q[(int64_t)tile_start * D + i] = a.q0[(int64_t)tile_start * D + i];
  __syncthreads();

  const TileRun<Density> run{dens, a, tile_start, red};

  float log_eps0 = logf(a.eps0);
  if (a.init_search) {
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
  // ChEES state: log T0 = log 10 + log eps0 (the paper's T0 = 10 eps0), Adam
  float log_T = kLog10 + log_eps0, adam_m = 0.0f, adam_v = 0.0f, t_chees = 0.0f;
  const int noise_off = a.init_search ? kSearchTrials + 1 : 0;
  const float nb = (float)a.bc;
  const int64_t C = a.n_chains;
  float* const s_qold = a.scratch;  // ChEES scratch: start, end, end momentum, alpha
  float* const s_qprop = a.scratch + C * D;
  float* const s_pend = a.scratch + 2 * C * D;
  float* const s_alpha = a.scratch + 3 * C * D;

  for (int t = 0; t < a.num_warmup; ++t) {
    const float eps = expf(log_step);
    int n_leap = a.num_leapfrog;
    float h = 1.0f;
    if (a.chees) {
      h = s_halton[t % kHaltonLen];
      n_leap = chees_leapfrog(h, expf(log_T), eps, a.max_leapfrog);
      if (a.leap_out != nullptr && threadIdx.x == 0)
        a.leap_out[(int64_t)t * gridDim.x + blockIdx.x] = n_leap;
    }
    DiagMetric<D> metric;
#pragma unroll
    for (int k = 0; k < D; ++k) metric.im[k] = im[k];

    float sums[D + 1];  // sum of q per coordinate, then sum of alpha
    float ends[2 * D];  // ChEES: sums of the start and the end positions
#pragma unroll
    for (int k = 0; k <= D; ++k) sums[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * D; ++k) ends[k] = 0.0f;
    for (int local = threadIdx.x; local < a.bc; local += blockDim.x) {
      const int c = tile_start + local;
      float qc[D], z[D], u, q_new[D], p_end[D];
#pragma unroll
      for (int k = 0; k < D; ++k) qc[k] = q[(int64_t)c * D + k];
      run.noise(c, kTagWarmup, t, noise_off + t, z, u);
      float dE = leapfrog_trajectory(dens, metric, qc, z, eps, n_leap, q_new, p_end);
      // divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects
      if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
      const float alpha = fminf(1.0f, expf(fminf(dE, 0.0f)));
      if (a.chees) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          s_qold[(int64_t)c * D + k] = qc[k];
          s_qprop[(int64_t)c * D + k] = q_new[k];
          s_pend[(int64_t)c * D + k] = p_end[k];
          ends[k] += qc[k];
          ends[D + k] += q_new[k];
        }
        s_alpha[c] = alpha;
      }
      if (logf(fmaxf(u, 1e-30f)) < dE) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          qc[k] = q_new[k];
          q[(int64_t)c * D + k] = qc[k];
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) sums[k] += qc[k];
      sums[D] += alpha;
    }
    block_sum<D + 1>(sums, red);

    if (a.chees) {
      // ChEES surrogate gradient pooled over the tile's chains:
      // alpha (|q' - mu'|^2 - |q - mu|^2) <q' - mu', M^-1 p'> h per chain,
      // over the tile's sum of alpha
      block_sum<2 * D>(ends, red);
      float mu_old[D], mu_new[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        mu_old[k] = ends[k] / nb;
        mu_new[k] = ends[D + k] / nb;
      }
      float pc[1] = {0.0f};
      for (int local = threadIdx.x; local < a.bc; local += blockDim.x) {
        const int c = tile_start + local;
        float sq_old = 0.0f, sq_new = 0.0f, dots = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float qo = s_qold[(int64_t)c * D + k] - mu_old[k];
          const float qn = s_qprop[(int64_t)c * D + k] - mu_new[k];
          sq_old += qo * qo;
          sq_new += qn * qn;
          dots += qn * (s_pend[(int64_t)c * D + k] * im[k]);
        }
        const float per_chain = s_alpha[c] * (sq_new - sq_old) * dots * h;
        pc[0] += isfinite(per_chain) ? per_chain : 0.0f;
      }
      block_sum<1>(pc, red);
      float g_T = pc[0] / fmaxf(sums[D], 1e-6f);
      g_T = g_T / (fabsf(g_T) + 1e-10f) * tanhf(fabsf(g_T));
      if (!isfinite(g_T)) g_T = 0.0f;
      t_chees = t_chees + 1.0f;
      adam_m = 0.9f * adam_m + 0.1f * g_T;
      adam_v = 0.999f * adam_v + 0.001f * g_T * g_T;
      const float mhat = adam_m / (1.0f - powf(0.9f, t_chees));
      const float vhat = adam_v / (1.0f - powf(0.999f, t_chees));
      log_T = log_T + 0.025f * mhat / (sqrtf(vhat) + 1e-8f);
      // keep T within [eps, max_leapfrog * eps]
      log_T = fminf(fmaxf(log_T, log_step), log_step + a.log_max_leapfrog);
    }

    // pooled dual averaging (Stan constants)
    const float a_mean = sums[D] / nb;
    count = count + 1.0f;
    const float w = 1.0f / (count + 10.0f);
    grad_avg = (1.0f - w) * grad_avg + w * (a.target_accept - a_mean);
    log_step = mu - sqrtf(count) / 0.05f * grad_avg;
    const float eta = powf(count, -0.75f);
    log_step_avg = eta * log_step + (1.0f - eta) * log_step_avg;

    // cross-chain Welford fold (Chan combine) during slow windows
    if (t >= a.initial_buffer && t < a.num_warmup - a.final_buffer) {
      float bm[D], bm2[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        bm[k] = sums[k] / nb;
        bm2[k] = 0.0f;
      }
      for (int local = threadIdx.x; local < a.bc; local += blockDim.x) {
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
    for (int r = 0; r < a.n_resets; ++r) is_reset = is_reset || s_resets[r] == t;
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
  // ChEES: T clamped to the final averaged step size's band
  const float T_final =
      fminf(fmaxf(expf(log_T), eps_final), eps_final * (float)a.max_leapfrog);
  for (int local = threadIdx.x; local < a.bc; local += blockDim.x) {
    const int c = tile_start + local;
    a.eps_out[c] = eps_final;
    if (a.chees) a.T_out[c] = T_final;
#pragma unroll
    for (int k = 0; k < D; ++k) a.im_out[(int64_t)c * D + k] = im[k];
  }
}

template <class Density>
cudaError_t launch(const Density& dens, const WarmupArgs& a, cudaStream_t stream) {
  if (a.n_resets > kMaxResets || a.bc <= 0 || a.n_chains % a.bc != 0)
    return cudaErrorInvalidValue;
  const size_t smem = dens.shared_floats() * sizeof(float);
  const int threads = a.bc < kK3Threads ? (a.bc + 31) / 32 * 32 : kK3Threads;
  fused_warmup_kernel<Density><<<a.n_chains / a.bc, threads, smem, stream>>>(dens, a);
  return cudaGetLastError();
}

}  // namespace binf

extern "C" int binf_fused_warmup(int family, int D, const binf::DensityOperands* ops,
                                 const binf::WarmupArgs* args, void* stream) {
  return (int)binf::with_density(family, D, *ops, [&](auto dens) {
    return binf::launch(dens, *args, (cudaStream_t)stream);
  });
}
