// The sampling kernel K4 and its launch; fused_potential.cu describes the
// design.  Included by one translation unit per lane-group width.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "densities.cuh"
#include "density_eval.cuh"
#include "fused_potential.cuh"
#include "fused_wide.cuh"
#include "hmc.cuh"
#include "lanes.cuh"
#include "philox.cuh"

namespace binf {

template <class Density, int G, bool Dense>
__global__ void __launch_bounds__(kK4Threads, (LaneOccupancy<Density, G>::k4))
fused_potential_kernel(Density dens, const RunArgs a) {
  constexpr int D = Density::D;
  using Metric = typename std::conditional<Dense, DenseMetric<D>, LaneDiagMetric<D>>::type;
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
  // a whole group leaves together: the chain index is the group's
  const int c = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G);
  const int lane = (int)(threadIdx.x & (G - 1));
  if (c >= a.n_chains) return;
  const Lanes<Density, G> lanes(dens);

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
  const bool records = a.leap_out != nullptr && c % a.bc == 0 && lane == 0;
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
      group_step_noise<D, G>(a.seed, kTagRun, (uint32_t)c, a.step_offset + (uint32_t)t, z, u);
    int n_leap = a.num_leapfrog;
    if (a.chees) {
      n_leap = chees_leapfrog(s_halton[t % kHaltonLen], T, eps_L, a.max_leapfrog);
      if (records) a.leap_out[(int64_t)t * tiles + tile] = n_leap;
    }
    float q_new[D], p_end[D];
    float dE = lane_trajectory(lanes, metric, q, z, eps, n_leap, q_new, p_end);
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
      for (int k = 0; k < D; ++k)
        if (k % G == lane) out[k] = q[k];
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k % G != lane) continue;
    a.qf[(int64_t)c * D + k] = q[k];
    if (a.moments) {
      a.mean[(int64_t)c * D + k] = mean[k];
      a.m2[(int64_t)c * D + k] = m2[k];
    }
  }
  if (lane == 0) a.accepts[c] = n_acc;
}

template <class Density, int G>
cudaError_t narrow_launch(const Density& dens, const RunArgs& a, cudaStream_t stream, int* grid) {
  constexpr int D = Density::D;
  if (a.bc <= 0 || a.n_chains % a.bc != 0 || a.thin <= 0) return cudaErrorInvalidValue;
  const size_t smem = (dens.shared_floats() + kHaltonLen + 2 * D * D) * sizeof(float);
  const int blocks = (int)(((int64_t)a.n_chains * G + kK4Threads - 1) / kK4Threads);
  if (a.dense)
    fused_potential_kernel<Density, G, true><<<blocks, kK4Threads, smem, stream>>>(dens, a);
  else
    fused_potential_kernel<Density, G, false><<<blocks, kK4Threads, smem, stream>>>(dens, a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = kK4Threads;
    grid[2] = 0;
  }
  return err;
}

// out[0]: CTAs of the kernel an SM holds at once; out[1]: its registers a
// thread.
template <class Density, int G>
cudaError_t narrow_occupancy(const Density& dens, int dense, int* out) {
  constexpr int D = Density::D;
  const size_t smem = (dens.shared_floats() + kHaltonLen + 2 * D * D) * sizeof(float);
  auto kernel = dense ? fused_potential_kernel<Density, G, true>
                      : fused_potential_kernel<Density, G, false>;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kK4Threads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = attr.numRegs;
  return err;
}

// -- K4's wide branch: a group of W warps a chain --------------------------------
//
// A CTA holds kK4Threads threads (at W = 8, one group of 256), chains a CTA
// as many groups as that holds; dynamic shared memory (past 48 KB by
// opting in) holds the operands, the Halton table and each chain's
// buffers and partials.

template <int W>
constexpr int kWideK4Threads = 32 * W > kK4Threads ? 32 * W : kK4Threads;

template <class F, int W>
__host__ __device__ constexpr int wide_k4_floats() {
  return wide_pad(F::kOperandFloats) + kHaltonLen +
         kWideK4Threads<W> / (32 * W) * kWideChainFloats<F::D>;
}

template <class F, bool Dense, int W>
__global__ void __launch_bounds__(kWideK4Threads<W>) wide_potential_kernel(F f, const RunArgs a) {
  constexpr int D = F::D, T = 32 * W, K = WideK<D, W>, kChains = kWideK4Threads<W> / T;
  extern __shared__ float smem[];
  float* const s_halton = smem + wide_pad(F::kOperandFloats);
  const int slot = (int)threadIdx.x / T;
  float* const qn = s_halton + kHaltonLen + slot * kWideChainFloats<D>;
  float* const g = qn + wide_pad(D);
  float* const ps = g + wide_pad(D);
  f.stage(smem);
  if (a.chees)
    for (int i = threadIdx.x; i < kHaltonLen; i += blockDim.x) s_halton[i] = a.halton[i];
  __syncthreads();
  // a whole group leaves together: the chain is the group's
  const int c = (int)blockIdx.x * kChains + slot;
  if (c >= a.n_chains) return;
  const WarpGroup<W> grp = warp_group<W>(ps + wide_pad(D));
  const int r = grp.r;
  WideMetric<D, Dense, W> m;
  m.minv = a.im;
  m.W = a.W;
  float q[K], mean[K], m2[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + T * j;
    q[j] = k < D ? a.q0[(int64_t)c * D + k] : 0.0f;
    m.im[j] = (!Dense && k < D) ? a.im[(int64_t)c * D + k] : 1.0f;
    mean[j] = 0.0f;
    m2[j] = 0.0f;
  }
  const WideNoise noise{a.seed, kTagRun, a.mom, a.unif, a.d_pad, a.n_chains};
  const float eps = a.eps[c];
  const int tile = c / a.bc, tiles = a.n_chains / a.bc;
  const bool records = a.leap_out != nullptr && c % a.bc == 0 && r == 0;
  const float T_traj = a.chees ? a.T_tile[tile] : 0.0f;
  const float eps_L = a.chees ? a.eps_tile[tile] : 1.0f;
  int n_acc = 0;
  for (int t = 0; t < a.num_steps; ++t) {
    const float u = noise.draw<D, W>(c, a.step_offset + (uint32_t)t, t, g, grp);
    int n_leap = a.num_leapfrog;
    if (a.chees) {
      n_leap = chees_leapfrog(s_halton[t % kHaltonLen], T_traj, eps_L, a.max_leapfrog);
      if (records) a.leap_out[(int64_t)t * tiles + tile] = n_leap;
    }
    float dE = wide_trajectory<F, Dense, W>(f, m, q, eps, n_leap, qn, g, ps, grp);
    if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
    const bool accept = logf(fmaxf(u, 1e-30f)) < dE;
    n_acc += accept;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = r + T * j;
      if (k >= D) break;
      if (accept) q[j] = qn[k];
      if (a.moments) {
        // streaming Welford over the call's steps
        const float delta = q[j] - mean[j];
        mean[j] = mean[j] + delta / (float)(t + 1);
        m2[j] = m2[j] + delta * (q[j] - mean[j]);
      } else if (t % a.thin == a.thin - 1) {
        a.draws[((int64_t)(t / a.thin) * a.n_chains + c) * D + k] = q[j];
      }
    }
    grp.sync();  // every thread read qn before the next step writes it
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + T * j;
    if (k >= D) break;
    a.qf[(int64_t)c * D + k] = q[j];
    if (a.moments) {
      a.mean[(int64_t)c * D + k] = mean[j];
      a.m2[(int64_t)c * D + k] = m2[j];
    }
  }
  if (r == 0) a.accepts[c] = n_acc;
}

template <class F, bool Dense, int W>
cudaError_t wide_k4_prepare(size_t smem) {
  return cudaFuncSetAttribute(wide_potential_kernel<F, Dense, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class F, int G>
cudaError_t wide_k4_launch(const F& f, const RunArgs& a, cudaStream_t stream, int* grid) {
  constexpr int W = wide_warps_of<G>(), threads = kWideK4Threads<W>;
  constexpr int chains = threads / (32 * W);
  if (a.bc <= 0 || a.n_chains % a.bc != 0 || a.thin <= 0) return cudaErrorInvalidValue;
  const size_t smem = wide_k4_floats<F, W>() * sizeof(float);
  const int blocks = (a.n_chains + chains - 1) / chains;
  cudaError_t err =
      a.dense ? wide_k4_prepare<F, true, W>(smem) : wide_k4_prepare<F, false, W>(smem);
  if (err != cudaSuccess) return err;
  if (a.dense)
    wide_potential_kernel<F, true, W><<<blocks, threads, smem, stream>>>(f, a);
  else
    wide_potential_kernel<F, false, W><<<blocks, threads, smem, stream>>>(f, a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = threads;
    grid[2] = 0;
  }
  return err;
}

template <class F, int G>
cudaError_t wide_k4_occupancy(int dense, int* out) {
  constexpr int W = wide_warps_of<G>();
  const size_t smem = wide_k4_floats<F, W>() * sizeof(float);
  auto kernel = dense ? wide_potential_kernel<F, true, W> : wide_potential_kernel<F, false, W>;
  cudaError_t err =
      dense ? wide_k4_prepare<F, true, W>(smem) : wide_k4_prepare<F, false, W>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kWideK4Threads<W>, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = attr.numRegs;
  return err;
}

// The branch of the functor: the wide one (fused_wide.cuh) for a wide
// form, else the lane-group one above.
template <class Density, int G>
cudaError_t launch(const Density& dens, const RunArgs& a, cudaStream_t stream, int* grid) {
  if constexpr (IsWide<Density>::value)
    return wide_k4_launch<Density, G>(dens, a, stream, grid);
  else
    return narrow_launch<Density, G>(dens, a, stream, grid);
}

template <class Density, int G>
cudaError_t occupancy(const Density& dens, int dense, int* out) {
  if constexpr (IsWide<Density>::value)
    return wide_k4_occupancy<Density, G>(dense, out);
  else
    return narrow_occupancy<Density, G>(dens, dense, out);
}

// Explicit instantiations of launch, and of the functor check's
// density_eval, for one functor and width.
#define BINF_K4_INSTANTIATE(DENS, G)                                                      \
  template cudaError_t launch<DENS, G>(const DENS&, const RunArgs&, cudaStream_t, int*);   \
  template cudaError_t density_eval<DENS, G>(const DENS&, const float*, int, float*, float*, \
                                             cudaStream_t, int*);                           \
  template cudaError_t occupancy<DENS, G>(const DENS&, int, int*);
#define BINF_K4_LINREG(G)                   \
  BINF_K4_INSTANTIATE(LinregDensity<1>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<2>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<3>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<4>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<5>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<6>, G) \
  BINF_K4_INSTANTIATE(LinregDensity<7>, G)

}  // namespace binf
