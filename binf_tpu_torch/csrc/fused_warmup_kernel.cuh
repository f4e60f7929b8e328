// The warmup kernel K3 and its launch; fused_warmup.cu describes the
// design.  Included by one translation unit per lane-group width.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "densities.cuh"
#include "fused_warmup.cuh"
#include "fused_wide.cuh"
#include "hmc.cuh"
#include "lanes.cuh"
#include "philox.cuh"

namespace binf {

// One tile's adaptation state and this step's sums over its chains, kept
// by every CTA that holds its chains: in shared memory for a CTA whose
// chains span at most kMaxCtaTiles tiles, else in device memory.
template <int D>
struct TileState {
  float log_step, log_step_avg, grad_avg, count, mu, wf_n;
  float log_T, adam_m, adam_v, t_chees;
  float log_eps0, cand, p, direction;  // step-size search
  int done;
  float eps;   // this step's step size and leapfrog count
  int n_leap;
  float wf_mean[D], wf_m2[D], im[D];
  float tot[4 * D + 2];  // tile sums of the partials; [4 D + 1]: ChEES gradient
};

// All CTAs of the cooperative launch meet here; bar[0] counts arrivals and
// bar[1] holds the generation, gen this CTA's count of barriers passed.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    ++gen;
    __threadfence();
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicExch(&bar[1], gen);
    } else {
      while (*(volatile unsigned*)&bar[1] != gen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Sum of v over the S chains of a slice (lanes xor G, 2G, ... < S G): every
// lane of the slice ends with the same bits.
template <int N>
__device__ __forceinline__ void slice_sum(float* v, int G, int slice_lanes, unsigned mask) {
  for (int off = G; off < slice_lanes; off <<= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(mask, v[k], off);
}

// Stores a slice's sum of one value: v is this warp's share of the slice
// (slice_sum over its lanes).  A slice of wps > 1 warps adds its warps'
// shares in warp order through shared memory (red, one float a warp);
// every thread of the CTA calls this then.
__device__ __forceinline__ void store_slice_sum(float v, float* dst, bool valid, bool head,
                                                int wps, float* red) {
  if (wps == 1) {
    if (valid && head) *dst = v;
    return;
  }
  const int warp = (int)(threadIdx.x >> 5), l32 = (int)(threadIdx.x & 31);
  if (valid && l32 == 0) red[warp] = v;
  __syncthreads();
  if (valid && l32 == 0 && warp % wps == 0) {
    float sum = 0.0f;
    for (int w = 0; w < wps; ++w) sum += red[warp + w];
    *dst = sum;
  }
  __syncthreads();
}

// Values [v0, v0 + N) of one tile's P slice partials (from slice s0),
// summed in one fixed order: thread j takes slices j, j + blockDim.x, ...,
// then block_sum.  Every thread gets the sums.  Reads bypass L1: other
// CTAs wrote the partials.
template <int N>
__device__ __forceinline__ void tile_total(const float* part, int n_slices, int s0, int P,
                                           int v0, float (&out)[N], float* red) {
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = 0.0f;
  for (int s = threadIdx.x; s < P; s += blockDim.x)
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] += __ldcg(part + (int64_t)(v0 + k) * n_slices + s0 + s);
  block_sum<N>(out, red);
}

template <class Density, int G>
__global__ void __launch_bounds__(kK3Threads, (LaneOccupancy<Density, G>::k3))
fused_warmup_kernel(Density dens, const WarmupArgs a) {
  constexpr int D = Density::D;
  constexpr int NV = 4 * D + 1;  // partials: q, alpha, M2, ChEES start and end
  constexpr int kChains = kK3Threads / G;
  constexpr float kLog10 = 2.30258512f, kLog2 = 0.693147182f;
  __shared__ float red[(kK3Threads / 32) * NV];
  __shared__ TileState<D> st_shared[kMaxCtaTiles];
  __shared__ int s_resets[kMaxResets];
  __shared__ float s_halton[kHaltonLen];
  extern __shared__ float smem[];
  dens.stage(smem);
  for (int r = threadIdx.x; r < a.n_resets; r += blockDim.x) s_resets[r] = a.resets[r];
  if (a.chees)
    for (int i = threadIdx.x; i < kHaltonLen; i += blockDim.x) s_halton[i] = a.halton[i];

  // geometry: this CTA's chains [c_lo, c_hi) and the tiles they span
  const int C = a.n_chains, bc = a.bc, S = a.slice, R = a.rounds;
  const bool looped = R > 1;
  const int64_t c_lo = (int64_t)blockIdx.x * R * kChains;
  const int64_t c_hi = c_lo + (int64_t)R * kChains < C ? c_lo + (int64_t)R * kChains : C;
  const int tile_lo = (int)(c_lo / bc);
  const int n_tiles = c_lo < C ? (int)((c_hi - 1) / bc) - tile_lo + 1 : 0;
  const int n_slices = C / S, tile_slices = bc / S;
  const int lane = (int)(threadIdx.x & (G - 1));
  // a slice's lanes within one warp, its chains there, and its warps
  const int slice_lanes = S * G < 32 ? S * G : 32;
  const int Sw = slice_lanes / G, wps = S * G > 32 ? S * G / 32 : 1;
  const int slice_base = (int)(threadIdx.x & 31) & ~(slice_lanes - 1);
  const unsigned smask =
      slice_lanes == 32 ? 0xFFFFFFFFu : ((1u << slice_lanes) - 1u) << slice_base;
  const bool slice_head = (int)(threadIdx.x & 31) == slice_base && lane == 0;
  const float nb = (float)bc;
  const int noise_off = a.init_search ? kSearchTrials + 1 : 0;
  auto chain_of = [&](int r) { return c_lo + (int64_t)r * kChains + threadIdx.x / G; };
  // CTA b's copies of its tiles' states start at state tile_lo + b of
  // a.tile_state: a CTA's first tile may be the last of the one before
  TileState<D>* const st =
      n_tiles <= kMaxCtaTiles
          ? st_shared
          : reinterpret_cast<TileState<D>*>(a.tile_state) + tile_lo + blockIdx.x;

  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    st[i].log_eps0 = logf(a.eps0);
    st[i].done = 0;
  }
  __syncthreads();
  const Lanes<Density, G> lanes(dens);

  auto noise = [&](int64_t c, uint32_t tag, int philox_step, int staged_step, float (&z)[D],
                   float& u) {
    if (a.mom != nullptr)
      staged_noise<D>(a.mom, a.unif, a.d_pad, C, (int)c, staged_step, z, u);
    else
      group_step_noise<D, G>(a.seed, tag, (uint32_t)c, (uint32_t)philox_step, z, u);
  };

  // this thread's chain (rounds == 1) lives in registers across barriers
  float qc[D], qo[D], qp[D], pe[D], al = 0.0f;
  if (!looped) {
    const int64_t c = chain_of(0);
    if (c < C)
#pragma unroll
      for (int k = 0; k < D; ++k) qc[k] = a.q0[c * D + k];
  } else {
    for (int r = 0; r < R; ++r) {
      const int64_t c = chain_of(r);
      if (c < C)
#pragma unroll
        for (int k = 0; k < D; ++k)
          if (k % G == lane) a.q[c * D + k] = a.q0[c * D + k];
    }
  }

  unsigned gen = 0;
  int buf = 0;
  float* part = a.part;
  auto part_at = [&](int b, int v, int64_t c) {
    return part + ((int64_t)b * NV + v) * n_slices + c / S;
  };

  if (a.init_search) {
    // Hoffman & Gelman 2011, Algorithm 4, per tile: double or halve eps
    // until the pooled acceptance probability of one trajectory from q0 at
    // the identity metric crosses 0.5, within a fixed budget.  Every CTA
    // passes all trials' barriers; tiles already done skip the work.
    for (int trial = 0; trial <= kSearchTrials; ++trial) {
      for (int r = 0; r < R; ++r) {
        const int64_t c = chain_of(r);
        // tiles hold whole slices: done is uniform over a slice
        const bool valid = c < C && !st[c / bc - tile_lo].done;
        float v[1] = {0.0f};
        if (valid) {
          const TileState<D>& s = st[c / bc - tile_lo];
          float q0c[D], z[D], u, q_new[D], p_end[D];
          LaneDiagMetric<D> identity;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            q0c[k] = a.q0[c * D + k];
            identity.im[k] = 1.0f;
          }
          noise(c, kTagSearch, trial, trial, z, u);
          float dE = lane_trajectory(lanes, identity, q0c, z,
                                     expf(trial == 0 ? s.log_eps0 : s.cand), a.num_leapfrog,
                                     q_new, p_end);
          if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
          v[0] = fminf(1.0f, expf(fminf(dE, 0.0f)));
          slice_sum<1>(v, G, slice_lanes, smask);
        }
        store_slice_sum(v[0], part_at(buf, 0, valid ? c : 0), valid, slice_head, wps, red);
      }
      grid_barrier(a.bar, gen);
      for (int i = 0; i < n_tiles; ++i) {
        float tv[1];
        tile_total<1>(part + (int64_t)buf * NV * n_slices, n_slices,
                      (tile_lo + i) * tile_slices, tile_slices, 0, tv, red);
        if (threadIdx.x == 0) st[i].tot[0] = tv[0];
      }
      buf ^= 1;
      __syncthreads();
      for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
        TileState<D>& s = st[i];
        const float p = s.tot[0] / nb;
        if (trial == 0) {
          s.p = p;
          s.direction = p > 0.5f ? 1.0f : -1.0f;
        } else if (!s.done) {
          s.log_eps0 = s.cand;
          s.p = p;
        }
        s.done = s.done || s.direction * (0.5f - s.p) >= 0.0f;
        s.cand = s.log_eps0 + s.direction * kLog2;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    TileState<D>& s = st[i];
    s.log_step = s.log_eps0;
    s.log_step_avg = s.grad_avg = s.count = 0.0f;
    s.mu = kLog10 + s.log_eps0;
    s.wf_n = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      s.wf_mean[k] = 0.0f;
      s.wf_m2[k] = 0.0f;
      s.im[k] = 1.0f;
    }
    // ChEES: log T0 = log 10 + log eps0 (the paper's T0 = 10 eps0), Adam
    s.log_T = kLog10 + s.log_eps0;
    s.adam_m = s.adam_v = s.t_chees = 0.0f;
  }

  float* const s_qold = a.scratch;  // rounds > 1, ChEES: start, end, end momentum, alpha
  float* const s_qprop = a.scratch + (int64_t)C * D;
  float* const s_pend = a.scratch + 2 * (int64_t)C * D;
  float* const s_alpha = a.scratch + 3 * (int64_t)C * D;

  for (int t = 0; t < a.num_warmup; ++t) {
    const float h = a.chees ? s_halton[t % kHaltonLen] : 1.0f;
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      TileState<D>& s = st[i];
      s.eps = expf(s.log_step);
      s.n_leap = a.num_leapfrog;
      if (a.chees) {
        s.n_leap = chees_leapfrog(h, expf(s.log_T), s.eps, a.max_leapfrog);
        // the CTA holding a tile's first chain records its count
        const int tile = tile_lo + i;
        if (a.leap_out != nullptr && (int64_t)tile * bc >= c_lo)
          a.leap_out[(int64_t)t * (C / bc) + tile] = s.n_leap;
      }
    }
    __syncthreads();
    const bool slow = t >= a.initial_buffer && t < a.num_warmup - a.final_buffer;

    for (int r = 0; r < R; ++r) {
      const int64_t c = chain_of(r);
      const bool valid = c < C;  // whole slices, whole warps: C divides by S
      float v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = 0.0f;
      if (valid) {
        const TileState<D>& s = st[c / bc - tile_lo];
        if (looped)
#pragma unroll
          for (int k = 0; k < D; ++k) qc[k] = a.q[c * D + k];
        LaneDiagMetric<D> metric;
#pragma unroll
        for (int k = 0; k < D; ++k) metric.im[k] = s.im[k];
        float z[D], u, q_new[D], p_end[D];
        noise(c, kTagWarmup, t, noise_off + t, z, u);
        float dE = lane_trajectory(lanes, metric, qc, z, s.eps, s.n_leap, q_new, p_end);
        // divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects
        if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
        const float alpha = fminf(1.0f, expf(fminf(dE, 0.0f)));
        if (a.chees) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            qo[k] = qc[k];
            qp[k] = q_new[k];
            pe[k] = p_end[k];
            v[2 * D + 1 + k] = qc[k];
            v[3 * D + 1 + k] = q_new[k];
          }
          al = alpha;
          if (looped) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
              if (k % G != lane) continue;
              s_qold[c * D + k] = qo[k];
              s_qprop[c * D + k] = qp[k];
              s_pend[c * D + k] = pe[k];
            }
            if (lane == 0) s_alpha[c] = al;
          }
        }
        if (logf(fmaxf(u, 1e-30f)) < dE)
#pragma unroll
          for (int k = 0; k < D; ++k) qc[k] = q_new[k];
        if (looped)
#pragma unroll
          for (int k = 0; k < D; ++k)
            if (k % G == lane) a.q[c * D + k] = qc[k];
#pragma unroll
        for (int k = 0; k < D; ++k) v[k] = qc[k];
        v[D] = alpha;
        slice_sum<D + 1>(v, G, slice_lanes, smask);
        if (slow) {
          // this warp's share of the slice: its own squared deviations
          // from its own mean
          float m2[D];
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float dev = qc[k] - v[k] / (float)Sw;
            m2[k] = dev * dev;
          }
          slice_sum<D>(m2, G, slice_lanes, smask);
#pragma unroll
          for (int k = 0; k < D; ++k) v[D + 1 + k] = m2[k];
        }
        if (a.chees) slice_sum<2 * D>(v + 2 * D + 1, G, slice_lanes, smask);
      }
      const int nv = a.chees ? NV : 2 * D + 1;
      if (wps == 1) {
        if (valid && slice_head) {
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (k < nv && (slow || k <= D || k > 2 * D)) *part_at(buf, k, c) = v[k];
        }
      } else {
        // the slice's warps in warp order; M2 by Chan's combine of the
        // warps' equal counts: their M2 plus Sw times the squared
        // distances of their means from the slice's
        const int warp = (int)(threadIdx.x >> 5), l32 = (int)(threadIdx.x & 31);
        if (valid && l32 == 0)
#pragma unroll
          for (int k = 0; k < NV; ++k) red[warp * NV + k] = v[k];
        __syncthreads();
        if (valid && warp % wps == 0)
          for (int k = l32; k < nv; k += 32) {
            const bool m2 = k > D && k <= 2 * D;
            if (m2 && !slow) continue;
            float sum = 0.0f;
            for (int w = 0; w < wps; ++w) sum += red[(warp + w) * NV + k];
            if (m2) {
              const int kq = k - D - 1;
              float sq = 0.0f, between = 0.0f;
              for (int w = 0; w < wps; ++w) sq += red[(warp + w) * NV + kq];
              for (int w = 0; w < wps; ++w) {
                const float d = red[(warp + w) * NV + kq] / (float)Sw - sq / (float)S;
                between += d * d;
              }
              sum = sum + (float)Sw * between;
            }
            *part_at(buf, k, c) = sum;
          }
        __syncthreads();
      }
    }
    grid_barrier(a.bar, gen);
    {
      const float* pb = part + (int64_t)buf * NV * n_slices;
      for (int i = 0; i < n_tiles; ++i) {
        const int s0 = (tile_lo + i) * tile_slices;
        float sums[D + 1];
        tile_total<D + 1>(pb, n_slices, s0, tile_slices, 0, sums, red);
        if (threadIdx.x == 0)
#pragma unroll
          for (int k = 0; k <= D; ++k) st[i].tot[k] = sums[k];
        if (slow) {
          // tile M2 = sum of the slices' M2 + S sum over slices of
          // (slice mean - tile mean)^2
          float within[D], between[D];
          tile_total<D>(pb, n_slices, s0, tile_slices, D + 1, within, red);
#pragma unroll
          for (int k = 0; k < D; ++k) between[k] = 0.0f;
          for (int j = threadIdx.x; j < tile_slices; j += blockDim.x)
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const float d = __ldcg(pb + (int64_t)k * n_slices + s0 + j) / (float)S
                              - sums[k] / nb;
              between[k] += d * d;
            }
          block_sum<D>(between, red);
          if (threadIdx.x == 0)
#pragma unroll
            for (int k = 0; k < D; ++k)
              st[i].tot[D + 1 + k] = within[k] + (float)S * between[k];
        }
        if (a.chees) {
          float ends[2 * D];
          tile_total<2 * D>(pb, n_slices, s0, tile_slices, 2 * D + 1, ends, red);
          if (threadIdx.x == 0)
#pragma unroll
            for (int k = 0; k < 2 * D; ++k) st[i].tot[2 * D + 1 + k] = ends[k];
        }
      }
    }
    buf ^= 1;
    __syncthreads();

    if (a.chees) {
      // ChEES surrogate gradient pooled over the tile's chains:
      // alpha (|q' - mu'|^2 - |q - mu|^2) <q' - mu', M^-1 p'> h per chain,
      // over the tile's sum of alpha
      for (int r = 0; r < R; ++r) {
        const int64_t c = chain_of(r);
        const bool valid = c < C;
        float v[1] = {0.0f};
        if (valid) {
          const int i = (int)(c / bc) - tile_lo;
          if (looped) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
              qo[k] = s_qold[c * D + k];
              qp[k] = s_qprop[c * D + k];
              pe[k] = s_pend[c * D + k];
            }
            al = s_alpha[c];
          }
          float sq_old = 0.0f, sq_new = 0.0f, dots = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float q_o = qo[k] - st[i].tot[2 * D + 1 + k] / nb;
            const float q_n = qp[k] - st[i].tot[3 * D + 1 + k] / nb;
            sq_old += q_o * q_o;
            sq_new += q_n * q_n;
            dots += q_n * (pe[k] * st[i].im[k]);
          }
          const float per_chain = al * (sq_new - sq_old) * dots * h;
          v[0] = isfinite(per_chain) ? per_chain : 0.0f;
          slice_sum<1>(v, G, slice_lanes, smask);
        }
        store_slice_sum(v[0], part_at(buf, 0, valid ? c : 0), valid, slice_head, wps, red);
      }
      grid_barrier(a.bar, gen);
      for (int i = 0; i < n_tiles; ++i) {
        float pc[1];
        tile_total<1>(part + (int64_t)buf * NV * n_slices, n_slices,
                      (tile_lo + i) * tile_slices, tile_slices, 0, pc, red);
        if (threadIdx.x == 0) st[i].tot[NV] = pc[0];
      }
      buf ^= 1;
      __syncthreads();
    }

    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      TileState<D>& s = st[i];
      const float* sums = s.tot;
      if (a.chees) {
        float g_T = sums[NV] / fmaxf(sums[D], 1e-6f);
        g_T = g_T / (fabsf(g_T) + 1e-10f) * tanhf(fabsf(g_T));
        if (!isfinite(g_T)) g_T = 0.0f;
        s.t_chees = s.t_chees + 1.0f;
        s.adam_m = 0.9f * s.adam_m + 0.1f * g_T;
        s.adam_v = 0.999f * s.adam_v + 0.001f * g_T * g_T;
        const float mhat = s.adam_m / (1.0f - powf(0.9f, s.t_chees));
        const float vhat = s.adam_v / (1.0f - powf(0.999f, s.t_chees));
        s.log_T = s.log_T + 0.025f * mhat / (sqrtf(vhat) + 1e-8f);
        // keep T within [eps, max_leapfrog * eps]
        s.log_T = fminf(fmaxf(s.log_T, s.log_step), s.log_step + a.log_max_leapfrog);
      }

      // pooled dual averaging (Stan constants)
      const float a_mean = sums[D] / nb;
      s.count = s.count + 1.0f;
      const float w = 1.0f / (s.count + 10.0f);
      s.grad_avg = (1.0f - w) * s.grad_avg + w * (a.target_accept - a_mean);
      s.log_step = s.mu - sqrtf(s.count) / 0.05f * s.grad_avg;
      const float eta = powf(s.count, -0.75f);
      s.log_step_avg = eta * s.log_step + (1.0f - eta) * s.log_step_avg;

      // cross-chain Welford fold (Chan combine) during slow windows
      if (slow) {
        const float n_new = s.wf_n + nb;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float delta = sums[k] / nb - s.wf_mean[k];
          s.wf_mean[k] = s.wf_mean[k] + delta * (nb / n_new);
          s.wf_m2[k] = s.wf_m2[k] + sums[D + 1 + k] + delta * delta * (s.wf_n * nb / n_new);
        }
        s.wf_n = n_new;
      }

      // window boundary: harvest the regularised variance into the metric,
      // restart Welford and dual averaging at the current step size
      bool is_reset = false;
      for (int j = 0; j < a.n_resets; ++j) is_reset = is_reset || s_resets[j] == t;
      if (is_reset) {
        const float wv = s.wf_n / (s.wf_n + 5.0f);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float var = s.wf_m2[k] / fmaxf(s.wf_n - 1.0f, 1.0f);
          s.im[k] = wv * var + (1.0f - wv) * 1e-3f;
          s.wf_mean[k] = 0.0f;
          s.wf_m2[k] = 0.0f;
        }
        s.wf_n = 0.0f;
        s.mu = kLog10 + s.log_step;
        s.log_step_avg = 0.0f;
        s.grad_avg = 0.0f;
        s.count = 0.0f;
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < R; ++r) {
    const int64_t c = chain_of(r);
    if (c >= C) continue;
    const TileState<D>& s = st[c / bc - tile_lo];
    const float eps_final = expf(s.log_step_avg);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k % G != lane) continue;
      if (!looped) a.q[c * D + k] = qc[k];
      a.im_out[c * D + k] = s.im[k];
    }
    if (lane == 0) {
      a.eps_out[c] = eps_final;
      // ChEES: T clamped to the final averaged step size's band
      if (a.chees)
        a.T_out[c] = fminf(fmaxf(expf(s.log_T), eps_final), eps_final * (float)a.max_leapfrog);
    }
  }
}

// -- the wide branch (fused_wide.cuh): a group of W warps a chain -----------------
//
// A traced density past 32 coordinates (its wide form) runs here.  A CTA's
// 8 warps hold 8 / W chains a round, a group of W warps each, their
// trajectory buffers and the groups' partials in dynamic shared memory
// (fused_wide.cuh; past 48 KB by opting in); between rounds and steps the
// chain's position lives in a.q, and with ChEES its start, proposal, end
// momentum and acceptance in a.scratch.  A slice is S of a round's chains
// (8 / W, halved until it divides block_chains): after each round the
// CTA's threads add the slice's chains' values in group order, a (slice,
// value) pair a thread, and write one partial a slice, as the one-lane
// branch does.
// After the grid barrier each thread adds its own coordinates' partials of
// each tile over the tile's slices in one fixed order, so the pooled sums
// are the same bits in every CTA; the tiles' states are every CTA's own
// copies in a.tile_state (WideTile: the scalars of TileState, then seven
// arrays of D floats), updated a tile a thread for the scalars, then a
// coordinate a thread for the Welford fold and the metric's harvest.

// One tile's adaptation state in device memory.
template <int D>
struct WideTile {
  enum : int {
    kLogStep, kLogStepAvg, kGradAvg, kCount, kMu, kWfN, kLogT, kAdamM, kAdamV, kTChees,
    kLogEps0, kCand, kP, kDirection, kDone, kEps, kNLeap, kAlphaSum, kCheesSum, kFoldOld,
    kFoldNew, kReset, kWv, kHead = 24
  };
  static constexpr int kPD = wide_pad(D);
  static constexpr int kFloats = kHead + 7 * kPD;
  float* s;

  __device__ __forceinline__ float& operator[](int i) const { return s[i]; }
  __device__ __forceinline__ float* wf_mean() const { return s + kHead; }
  __device__ __forceinline__ float* wf_m2() const { return s + kHead + kPD; }
  __device__ __forceinline__ float* im() const { return s + kHead + 2 * kPD; }
  __device__ __forceinline__ float* qsum() const { return s + kHead + 3 * kPD; }   // tile sum of q
  __device__ __forceinline__ float* m2sum() const { return s + kHead + 4 * kPD; }  // tile M2
  __device__ __forceinline__ float* mstart() const { return s + kHead + 5 * kPD; } // ChEES means
  __device__ __forceinline__ float* mprop() const { return s + kHead + 6 * kPD; }
};

template <int W>
constexpr int kWideK3Chains = kK3Threads / (32 * W);

template <class F, int W>
__host__ __device__ constexpr int wide_k3_floats() {
  return wide_pad(F::kOperandFloats) + kWideK3Chains<W> * kWideChainFloats<F::D>;
}

template <class F, int W>
__global__ void __launch_bounds__(kK3Threads) wide_warmup_kernel(F f, const WarmupArgs a) {
  constexpr int D = F::D, T = 32 * W, K = WideK<D, W>, NV = 4 * D + 1, CF = kWideChainFloats<D>;
  constexpr int PD = wide_pad(D), kChains = kWideK3Chains<W>;
  constexpr float kLog10 = 2.30258512f, kLog2 = 0.693147182f;
  using Tile = WideTile<D>;
  __shared__ float red[kK3Threads / 32];
  __shared__ float s_alpha[kChains];
  __shared__ int s_resets[kMaxResets];
  __shared__ float s_halton[kHaltonLen];
  extern __shared__ float smem[];
  f.stage(smem);
  for (int r = threadIdx.x; r < a.n_resets; r += blockDim.x) s_resets[r] = a.resets[r];
  if (a.chees)
    for (int i = threadIdx.x; i < kHaltonLen; i += blockDim.x) s_halton[i] = a.halton[i];
  const int slot = (int)threadIdx.x / T;  // the chain's group in the CTA
  float* const bufs = smem + wide_pad(F::kOperandFloats);
  float* const qn = bufs + slot * CF;  // trajectory position, gradient, momentum
  float* const g = qn + PD;
  float* const ps = g + PD;

  const int C = a.n_chains, bc = a.bc, S = a.slice, R = a.rounds;
  const int64_t c_lo = (int64_t)blockIdx.x * R * kChains;
  const int64_t c_hi = c_lo + (int64_t)R * kChains < C ? c_lo + (int64_t)R * kChains : C;
  const int tile_lo = (int)(c_lo / bc);
  const int n_tiles = c_lo < C ? (int)((c_hi - 1) / bc) - tile_lo + 1 : 0;
  const int n_slices = C / S, tile_slices = bc / S, round_slices = kChains / S;
  const float nb = (float)bc;
  const int noise_off = a.init_search ? kSearchTrials + 1 : 0;
  auto chain_of = [&](int r) { return c_lo + (int64_t)r * kChains + slot; };
  // CTA b's copies of its tiles' states start at state tile_lo + b
  float* const states = a.tile_state + (int64_t)(tile_lo + blockIdx.x) * Tile::kFloats;
  auto st = [&](int i) { return Tile{states + (int64_t)i * Tile::kFloats}; };
  const WarpGroup<W> grp = warp_group<W>(ps + PD);
  const int lane = grp.r;
  const WideNoise search_noise{a.seed, kTagSearch, a.mom, a.unif, a.d_pad, C};
  const WideNoise warmup_noise{a.seed, kTagWarmup, a.mom, a.unif, a.d_pad, C};

  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    st(i)[Tile::kLogEps0] = logf(a.eps0);
    st(i)[Tile::kDone] = 0.0f;
  }
  for (int r = 0; r < R; ++r) {
    const int64_t c = chain_of(r);
    if (c < C)
      for (int k = lane; k < D; k += T) a.q[c * D + k] = a.q0[c * D + k];
  }
  __syncthreads();

  unsigned gen = 0;
  int buf = 0;
  float* const part = a.part;
  // partial v of slice j of the round from chain c_base: the slice's
  // chains added in group order; the chains' buffers hold the accepted
  // position (ps), the start (g) and the proposal (qn)
  auto store_round = [&](int64_t c_base, bool full, bool slow, bool chees) {
    const int nv = full ? NV : 1;
    for (int idx = threadIdx.x; idx < round_slices * nv; idx += blockDim.x) {
      const int j = idx / nv, v = idx % nv;
      const int64_t c0 = c_base + (int64_t)j * S;
      if (c0 >= C) continue;
      const float* b0 = bufs + j * S * CF;
      float s = 0.0f;
      if (!full || v == D) {
        for (int w = 0; w < S; ++w) s += s_alpha[j * S + w];
      } else if (v < D) {
        for (int w = 0; w < S; ++w) s += b0[w * CF + 2 * PD + v];
      } else if (v <= 2 * D) {
        if (!slow) continue;
        const int k = v - D - 1;
        float sum = 0.0f;
        for (int w = 0; w < S; ++w) sum += b0[w * CF + 2 * PD + k];
        const float mean = sum / (float)S;
        for (int w = 0; w < S; ++w) {
          const float d = b0[w * CF + 2 * PD + k] - mean;
          s += d * d;
        }
      } else {
        if (!chees) continue;
        const int k = v <= 3 * D ? v - 2 * D - 1 : v - 3 * D - 1;
        const int at = v <= 3 * D ? PD : 0;  // the start in g, the proposal in qn
        for (int w = 0; w < S; ++w) s += b0[w * CF + at + k];
      }
      part[((int64_t)buf * NV + (full ? v : 0)) * n_slices + c0 / S] = s;
    }
  };

  if (a.init_search) {
    // Hoffman & Gelman's doubling search, per tile, as the one-lane branch
    for (int trial = 0; trial <= kSearchTrials; ++trial) {
      for (int r = 0; r < R; ++r) {
        const int64_t c = chain_of(r);
        float alpha = 0.0f;
        if (c < C && st((int)(c / bc) - tile_lo)[Tile::kDone] == 0.0f) {
          const Tile s = st((int)(c / bc) - tile_lo);
          WideMetric<D, false, W> identity;
          float q[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int k = lane + T * j;
            q[j] = k < D ? a.q0[c * D + k] : 0.0f;
            identity.im[j] = 1.0f;
          }
          search_noise.draw<D, W>((int)c, (uint32_t)trial, trial, g, grp);
          float dE = wide_trajectory<F, false, W>(
              f, identity, q, expf(trial == 0 ? s[Tile::kLogEps0] : s[Tile::kCand]),
              a.num_leapfrog, qn, g, ps, grp);
          if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
          alpha = fminf(1.0f, expf(fminf(dE, 0.0f)));
        }
        if (lane == 0) s_alpha[slot] = alpha;
        __syncthreads();
        store_round(c_lo + (int64_t)r * kChains, false, false, false);
        __syncthreads();
      }
      grid_barrier(a.bar, gen);
      for (int i = 0; i < n_tiles; ++i) {
        float tv[1];
        tile_total<1>(part + (int64_t)buf * NV * n_slices, n_slices,
                      (tile_lo + i) * tile_slices, tile_slices, 0, tv, red);
        if (threadIdx.x == 0) st(i)[Tile::kAlphaSum] = tv[0];
      }
      buf ^= 1;
      __syncthreads();
      for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
        const Tile s = st(i);
        const float p = s[Tile::kAlphaSum] / nb;
        if (trial == 0) {
          s[Tile::kP] = p;
          s[Tile::kDirection] = p > 0.5f ? 1.0f : -1.0f;
        } else if (s[Tile::kDone] == 0.0f) {
          s[Tile::kLogEps0] = s[Tile::kCand];
          s[Tile::kP] = p;
        }
        const bool done =
            s[Tile::kDone] != 0.0f || s[Tile::kDirection] * (0.5f - s[Tile::kP]) >= 0.0f;
        s[Tile::kDone] = done ? 1.0f : 0.0f;
        s[Tile::kCand] = s[Tile::kLogEps0] + s[Tile::kDirection] * kLog2;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const Tile s = st(i);
    s[Tile::kLogStep] = s[Tile::kLogEps0];
    s[Tile::kLogStepAvg] = s[Tile::kGradAvg] = s[Tile::kCount] = 0.0f;
    s[Tile::kMu] = kLog10 + s[Tile::kLogEps0];
    s[Tile::kWfN] = 0.0f;
    // ChEES: log T0 = log 10 + log eps0 (the paper's T0 = 10 eps0), Adam
    s[Tile::kLogT] = kLog10 + s[Tile::kLogEps0];
    s[Tile::kAdamM] = s[Tile::kAdamV] = s[Tile::kTChees] = 0.0f;
  }
  for (int i = 0; i < n_tiles; ++i)
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
      st(i).wf_mean()[k] = 0.0f;
      st(i).wf_m2()[k] = 0.0f;
      st(i).im()[k] = 1.0f;
    }
  __syncthreads();

  float* const s_qold = a.scratch;  // ChEES: start, proposal, end momentum, alpha
  float* const s_qprop = a.scratch + (int64_t)C * D;
  float* const s_pend = a.scratch + 2 * (int64_t)C * D;
  float* const s_al = a.scratch + 3 * (int64_t)C * D;

  for (int t = 0; t < a.num_warmup; ++t) {
    const float h = a.chees ? s_halton[t % kHaltonLen] : 1.0f;
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      const Tile s = st(i);
      s[Tile::kEps] = expf(s[Tile::kLogStep]);
      int n_leap = a.num_leapfrog;
      if (a.chees) {
        n_leap = chees_leapfrog(h, expf(s[Tile::kLogT]), s[Tile::kEps], a.max_leapfrog);
        // the CTA holding a tile's first chain records its count
        const int tile = tile_lo + i;
        if (a.leap_out != nullptr && (int64_t)tile * bc >= c_lo)
          a.leap_out[(int64_t)t * (C / bc) + tile] = n_leap;
      }
      s[Tile::kNLeap] = (float)n_leap;
    }
    __syncthreads();
    const bool slow = t >= a.initial_buffer && t < a.num_warmup - a.final_buffer;

    for (int r = 0; r < R; ++r) {
      const int64_t c = chain_of(r);
      float alpha = 0.0f;
      if (c < C) {
        const Tile s = st((int)(c / bc) - tile_lo);
        WideMetric<D, false, W> m;
        float q[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int k = lane + T * j;
          q[j] = k < D ? a.q[c * D + k] : 0.0f;
          m.im[j] = k < D ? s.im()[k] : 1.0f;
        }
        const float u = warmup_noise.draw<D, W>((int)c, (uint32_t)t, noise_off + t, g, grp);
        float dE = wide_trajectory<F, false, W>(f, m, q, s[Tile::kEps], (int)s[Tile::kNLeap],
                                                qn, g, ps, grp);
        // divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects
        if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
        alpha = fminf(1.0f, expf(fminf(dE, 0.0f)));
        const bool accept = logf(fmaxf(u, 1e-30f)) < dE;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int k = lane + T * j;
          if (k >= D) break;
          if (a.chees) {
            s_qold[c * D + k] = q[j];
            s_qprop[c * D + k] = qn[k];
            s_pend[c * D + k] = ps[k];
          }
          const float qa = accept ? qn[k] : q[j];
          a.q[c * D + k] = qa;
          g[k] = q[j];
          ps[k] = qa;
        }
        if (a.chees && lane == 0) s_al[c] = alpha;
      }
      if (lane == 0) s_alpha[slot] = alpha;
      __syncthreads();
      store_round(c_lo + (int64_t)r * kChains, true, slow, a.chees);
      __syncthreads();
    }
    grid_barrier(a.bar, gen);
    {
      const float* pb = part + (int64_t)buf * NV * n_slices;
      for (int i = 0; i < n_tiles; ++i) {
        const Tile s = st(i);
        const int64_t s0 = (int64_t)(tile_lo + i) * tile_slices;
        for (int k = threadIdx.x; k < D; k += blockDim.x) {
          float sum = 0.0f;
          for (int j = 0; j < tile_slices; ++j) sum += __ldcg(pb + (int64_t)k * n_slices + s0 + j);
          s.qsum()[k] = sum;
          if (slow) {
            // tile M2 = the slices' M2 + S sum over slices of (slice mean -
            // tile mean)^2
            float within = 0.0f, between = 0.0f;
            for (int j = 0; j < tile_slices; ++j) {
              within += __ldcg(pb + (int64_t)(D + 1 + k) * n_slices + s0 + j);
              const float d = __ldcg(pb + (int64_t)k * n_slices + s0 + j) / (float)S - sum / nb;
              between += d * d;
            }
            s.m2sum()[k] = within + (float)S * between;
          }
          if (a.chees) {
            float ms = 0.0f, mp = 0.0f;
            for (int j = 0; j < tile_slices; ++j) {
              ms += __ldcg(pb + (int64_t)(2 * D + 1 + k) * n_slices + s0 + j);
              mp += __ldcg(pb + (int64_t)(3 * D + 1 + k) * n_slices + s0 + j);
            }
            s.mstart()[k] = ms / nb;
            s.mprop()[k] = mp / nb;
          }
        }
        float tv[1];
        tile_total<1>(pb, n_slices, (int)s0, tile_slices, D, tv, red);
        if (threadIdx.x == 0) s[Tile::kAlphaSum] = tv[0];
      }
    }
    buf ^= 1;
    __syncthreads();

    if (a.chees) {
      // ChEES surrogate gradient pooled over the tile's chains:
      // alpha (|q' - mu'|^2 - |q - mu|^2) <q' - mu', M^-1 p'> h per chain,
      // over the tile's sum of alpha
      for (int r = 0; r < R; ++r) {
        const int64_t c = chain_of(r);
        float v = 0.0f;
        if (c < C) {
          const Tile s = st((int)(c / bc) - tile_lo);
          float sq_old = 0.0f, sq_new = 0.0f, dots = 0.0f;
          for (int k = lane; k < D; k += T) {
            const float q_o = s_qold[c * D + k] - s.mstart()[k];
            const float q_n = s_qprop[c * D + k] - s.mprop()[k];
            sq_old += q_o * q_o;
            sq_new += q_n * q_n;
            dots += q_n * (s_pend[c * D + k] * s.im()[k]);
          }
          sq_old = grp.sum(sq_old);
          sq_new = grp.sum(sq_new);
          dots = grp.sum(dots);
          const float per_chain = s_al[c] * (sq_new - sq_old) * dots * h;
          v = isfinite(per_chain) ? per_chain : 0.0f;
        }
        if (lane == 0) s_alpha[slot] = v;
        __syncthreads();
        store_round(c_lo + (int64_t)r * kChains, false, false, false);
        __syncthreads();
      }
      grid_barrier(a.bar, gen);
      for (int i = 0; i < n_tiles; ++i) {
        float pc[1];
        tile_total<1>(part + (int64_t)buf * NV * n_slices, n_slices,
                      (tile_lo + i) * tile_slices, tile_slices, 0, pc, red);
        if (threadIdx.x == 0) st(i)[Tile::kCheesSum] = pc[0];
      }
      buf ^= 1;
      __syncthreads();
    }

    // the scalars a tile a thread
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      const Tile s = st(i);
      if (a.chees) {
        float g_T = s[Tile::kCheesSum] / fmaxf(s[Tile::kAlphaSum], 1e-6f);
        g_T = g_T / (fabsf(g_T) + 1e-10f) * tanhf(fabsf(g_T));
        if (!isfinite(g_T)) g_T = 0.0f;
        s[Tile::kTChees] = s[Tile::kTChees] + 1.0f;
        s[Tile::kAdamM] = 0.9f * s[Tile::kAdamM] + 0.1f * g_T;
        s[Tile::kAdamV] = 0.999f * s[Tile::kAdamV] + 0.001f * g_T * g_T;
        const float mhat = s[Tile::kAdamM] / (1.0f - powf(0.9f, s[Tile::kTChees]));
        const float vhat = s[Tile::kAdamV] / (1.0f - powf(0.999f, s[Tile::kTChees]));
        float log_T = s[Tile::kLogT] + 0.025f * mhat / (sqrtf(vhat) + 1e-8f);
        // keep T within [eps, max_leapfrog * eps]
        s[Tile::kLogT] =
            fminf(fmaxf(log_T, s[Tile::kLogStep]), s[Tile::kLogStep] + a.log_max_leapfrog);
      }
      // pooled dual averaging (Stan constants)
      const float a_mean = s[Tile::kAlphaSum] / nb;
      const float count = s[Tile::kCount] + 1.0f;
      s[Tile::kCount] = count;
      const float w = 1.0f / (count + 10.0f);
      const float grad_avg = (1.0f - w) * s[Tile::kGradAvg] + w * (a.target_accept - a_mean);
      s[Tile::kGradAvg] = grad_avg;
      const float log_step = s[Tile::kMu] - sqrtf(count) / 0.05f * grad_avg;
      s[Tile::kLogStep] = log_step;
      const float eta = powf(count, -0.75f);
      s[Tile::kLogStepAvg] = eta * log_step + (1.0f - eta) * s[Tile::kLogStepAvg];
      // the Welford fold's counts (Chan combine in slow windows), then the
      // window boundary: the metric from the regularised variance, Welford
      // and dual averaging restarted at the current step size
      const float n_old = s[Tile::kWfN], n_new = slow ? n_old + nb : n_old;
      bool is_reset = false;
      for (int j = 0; j < a.n_resets; ++j) is_reset = is_reset || s_resets[j] == t;
      s[Tile::kFoldOld] = n_old;
      s[Tile::kFoldNew] = n_new;
      s[Tile::kReset] = is_reset ? 1.0f : 0.0f;
      s[Tile::kWv] = n_new / (n_new + 5.0f);
      s[Tile::kWfN] = is_reset ? 0.0f : n_new;
      if (is_reset) {
        s[Tile::kMu] = kLog10 + log_step;
        s[Tile::kLogStepAvg] = 0.0f;
        s[Tile::kGradAvg] = 0.0f;
        s[Tile::kCount] = 0.0f;
      }
    }
    __syncthreads();
    // the coordinates a thread each
    for (int i = 0; i < n_tiles; ++i) {
      const Tile s = st(i);
      const float n_old = s[Tile::kFoldOld], n_new = s[Tile::kFoldNew];
      const bool is_reset = s[Tile::kReset] != 0.0f;
      for (int k = threadIdx.x; k < D; k += blockDim.x) {
        if (slow) {
          const float delta = s.qsum()[k] / nb - s.wf_mean()[k];
          s.wf_mean()[k] = s.wf_mean()[k] + delta * (nb / n_new);
          s.wf_m2()[k] = s.wf_m2()[k] + s.m2sum()[k] + delta * delta * (n_old * nb / n_new);
        }
        if (is_reset) {
          const float wv = s[Tile::kWv];
          const float var = s.wf_m2()[k] / fmaxf(n_new - 1.0f, 1.0f);
          s.im()[k] = wv * var + (1.0f - wv) * 1e-3f;
          s.wf_mean()[k] = 0.0f;
          s.wf_m2()[k] = 0.0f;
        }
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < R; ++r) {
    const int64_t c = chain_of(r);
    if (c >= C) continue;
    const Tile s = st((int)(c / bc) - tile_lo);
    const float eps_final = expf(s[Tile::kLogStepAvg]);
    for (int k = lane; k < D; k += T) a.im_out[c * D + k] = s.im()[k];
    if (lane == 0) {
      a.eps_out[c] = eps_final;
      // ChEES: T clamped to the final averaged step size's band
      if (a.chees)
        a.T_out[c] = fminf(fmaxf(expf(s[Tile::kLogT]), eps_final), eps_final * (float)a.max_leapfrog);
    }
  }
}

template <class F, int G>
cudaError_t wide_max_ctas(int* out) {
  constexpr int W = wide_warps_of<G>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = wide_k3_floats<F, W>() * sizeof(float);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide_warmup_kernel<F, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide_warmup_kernel<F, W>,
                                                        kK3Threads, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, wide_warmup_kernel<F, W>);
  out[0] = per_sm * sms;
  out[1] = (int)(WideTile<F::D>::kFloats * sizeof(float));
  out[2] = attr.numRegs;
  return err;
}

template <class F, int G>
cudaError_t wide_k3_launch(const F& f, const WarmupArgs& a, cudaStream_t stream, int* grid) {
  constexpr int W = wide_warps_of<G>();
  const int S = a.slice;
  if (a.n_resets > kMaxResets || a.bc <= 0 || a.n_chains % a.bc != 0 || S <= 0
      || S > kWideK3Chains<W> || (S & (S - 1)) != 0 || a.bc % S != 0 || a.ctas <= 0
      || a.rounds <= 0 || (int64_t)a.ctas * a.rounds * kWideK3Chains<W> < a.n_chains
      || a.tile_state == nullptr
      || a.tile_state_bytes < (int64_t)(a.n_chains / a.bc + a.ctas)
                                  * (int64_t)(WideTile<F::D>::kFloats * sizeof(float))
      || (a.chees && a.scratch == nullptr))
    return cudaErrorInvalidValue;
  int fit[3] = {0, 0, 0};
  cudaError_t err = wide_max_ctas<F, G>(fit);
  if (err != cudaSuccess) return err;
  if (a.ctas > fit[0]) return cudaErrorCooperativeLaunchTooLarge;
  const size_t smem = wide_k3_floats<F, W>() * sizeof(float);
  F d = f;
  WarmupArgs args = a;
  void* params[] = {&d, &args};
  err = cudaLaunchCooperativeKernel((void*)wide_warmup_kernel<F, W>, dim3(a.ctas),
                                    dim3(kK3Threads), params, smem, stream);
  if (err == cudaSuccess) {
    grid[0] = a.ctas;
    grid[1] = kK3Threads;
    grid[2] = 1;
  }
  return err;
}

template <class Density, int G>
cudaError_t narrow_max_ctas(const Density& dens, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = dens.shared_floats() * sizeof(float);
  auto kernel = fused_warmup_kernel<Density, G>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kK3Threads, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = per_sm * sms;
  out[1] = (int)sizeof(TileState<Density::D>);
  out[2] = attr.numRegs;
  return err;
}

template <class Density, int G>
cudaError_t narrow_launch(const Density& dens, const WarmupArgs& a, cudaStream_t stream,
                          int* grid) {
  constexpr int kChains = kK3Threads / G;
  const int S = a.slice;
  if (a.n_resets > kMaxResets || a.bc <= 0 || a.n_chains % a.bc != 0 || S <= 0
      || S * G > kK3Threads || (S & (S - 1)) != 0 || a.bc % S != 0 || a.ctas <= 0 || a.rounds <= 0
      || (int64_t)a.ctas * a.rounds * kChains < a.n_chains)
    return cudaErrorInvalidValue;
  // a CTA whose chains span more than kMaxCtaTiles tiles keeps their
  // states in a.tile_state, which then holds C / bc + ctas of them
  const int64_t span = (int64_t)a.rounds * kChains;
  for (int64_t lo = 0; lo < a.n_chains; lo += span) {
    const int64_t hi = (lo + span < a.n_chains ? lo + span : a.n_chains) - 1;
    if (hi / a.bc - lo / a.bc + 1 > kMaxCtaTiles
        && (a.tile_state == nullptr
            || a.tile_state_bytes < (int64_t)(a.n_chains / a.bc + a.ctas)
                                        * (int64_t)sizeof(TileState<Density::D>)))
      return cudaErrorInvalidValue;
  }
  int fit[3] = {0, 0, 0};
  cudaError_t err = narrow_max_ctas<Density, G>(dens, fit);
  if (err != cudaSuccess) return err;
  if (a.ctas > fit[0]) return cudaErrorCooperativeLaunchTooLarge;
  const size_t smem = dens.shared_floats() * sizeof(float);
  Density d = dens;
  WarmupArgs args = a;
  void* params[] = {&d, &args};
  err = cudaLaunchCooperativeKernel((void*)fused_warmup_kernel<Density, G>, dim3(a.ctas),
                                    dim3(kK3Threads), params, smem, stream);
  if (err == cudaSuccess) {
    grid[0] = a.ctas;
    grid[1] = kK3Threads;
    grid[2] = 1;
  }
  return err;
}

// The branch of the functor: the wide one for a wide form, else the
// lane-group one above.
template <class Density, int G>
cudaError_t max_ctas(const Density& dens, int* out) {
  if constexpr (IsWide<Density>::value)
    return wide_max_ctas<Density, G>(out);
  else
    return narrow_max_ctas<Density, G>(dens, out);
}

template <class Density, int G>
cudaError_t launch(const Density& dens, const WarmupArgs& a, cudaStream_t stream, int* grid) {
  if constexpr (IsWide<Density>::value)
    return wide_k3_launch<Density, G>(dens, a, stream, grid);
  else
    return narrow_launch<Density, G>(dens, a, stream, grid);
}

// Explicit instantiations of launch and max_ctas for one functor and width.
#define BINF_K3_INSTANTIATE(DENS, G)                                                     \
  template cudaError_t launch<DENS, G>(const DENS&, const WarmupArgs&, cudaStream_t, int*); \
  template cudaError_t max_ctas<DENS, G>(const DENS&, int*);
#define BINF_K3_LINREG(G)                   \
  BINF_K3_INSTANTIATE(LinregDensity<1>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<2>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<3>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<4>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<5>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<6>, G) \
  BINF_K3_INSTANTIATE(LinregDensity<7>, G)

}  // namespace binf
