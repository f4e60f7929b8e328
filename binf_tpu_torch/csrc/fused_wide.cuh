// What the wide branches of K3 (fused_warmup_kernel.cuh::wide_warmup_kernel)
// and K4 (fused_potential_kernel.cuh::wide_potential_kernel) share, and the
// functor check's wide branch, for a traced density past the one-lane
// functor's 32 coordinates (the wide form that ops/kernels/
// density_compiler.py emits, TracedWide_<key>: kWide).
//
// The one-lane branches keep a chain's q, p, grad U, proposal and metric in
// one thread's registers (lanes.cuh::lane_trajectory), some 7 D floats:
// past D ~ 32 that spills.  Here a warp runs one chain, as a group of
// warps does in K7 (chain_grid_kernel.cuh): the chain's trajectory
// position, gradient and momentum live in three buffers of D floats in
// shared memory, which the wide form reads and writes, and lane r owns the
// coordinates k = r, r + 32, ... (its part of the position, the metric and
// the moments in registers, WideK<D> of them).  Every update of the
// trajectory runs over a lane's own coordinates; the kinetic energy is a
// sum over the warp (traced_density.cuh::LaneGroup, the same bits in every
// lane), so every lane takes the same MH decision.  The rounding is the
// one-lane branch's (lanes.cuh: __fmul_rn, __fadd_rn in the plain
// version's order) but for the order of the sums over coordinates.
//
// The noise is the one-lane branch's stream: Philox slot s gives normals 2 s
// and 2 s + 1 (lane s mod 32 draws it into the gradient buffer, which is
// free at a step's start), the uniform comes from kUniformSlot on lane
// slots mod 32 and is broadcast; or the staged noise of the JAX layout.
//
// A dense metric is not staged: minv and W (D x D) are read from device
// memory, where L2 holds them, a row a coordinate, so 2 D^2 floats never
// count against shared memory (ops/kernels/fused_potential.py::
// _shared_need counts the operands, the Halton table and the chains'
// buffers).  The wide form is one __noinline__ function, so each kernel
// compiles it once whatever its call sites.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hmc.cuh"
#include "philox.cuh"
#include "traced_density.cuh"

namespace binf {

constexpr int kWideLanes = 32;  // a warp a chain

// Whether a functor is a wide form (its kWide member).
template <class T, class = void>
struct IsWide {
  static constexpr bool value = false;
};
template <class T>
struct IsWide<T, std::void_t<decltype(T::kWide)>> {
  static constexpr bool value = T::kWide;
};

__host__ __device__ constexpr int wide_pad(int x) { return (x + 3) & ~3; }
// a lane's coordinates
template <int D>
constexpr int WideK = (D + kWideLanes - 1) / kWideLanes;
// a chain's shared floats: the trajectory position, the gradient (and the
// noise at a step's start), the momentum
template <int D>
constexpr int kWideChainFloats = 3 * wide_pad(D);

using WideGroup = LaneGroup<kWideLanes>;

template <class F>
__device__ __noinline__ float wide_eval(const F& f, const float* qs, float* gs,
                                        const WideGroup& grp) {
  return f.value_and_grad(qs, gs, grp);
}

// One step's noise of chain c into z (shared, D floats) and the uniform,
// in every lane; ends at the warp's barrier.
struct WideNoise {
  uint64_t seed;
  uint32_t tag;
  const float* mom;  // staged (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad, n_chains;

  template <int D>
  __device__ __forceinline__ float draw(int c, uint32_t philox_step, int staged_step, float* z,
                                        const WideGroup& grp) const {
    float u = 0.0f;
    if (mom != nullptr) {
      for (int k = grp.r; k < D; k += kWideLanes)
        z[k] = mom[((int64_t)staged_step * d_pad + k) * n_chains + c];
      u = unif[(int64_t)staged_step * n_chains + c];
    } else {
      const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
      constexpr int kSlots = (D + 1) / 2;
      for (int s = grp.r; s < kSlots; s += kWideLanes) {
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)c, philox_step, (uint32_t)s, tag}, k0, k1);
        z[2 * s] = bits_to_normal(b.x, b.y);
        if (2 * s + 1 < D) z[2 * s + 1] = bits_to_normal(b.z, b.w);
      }
      if (grp.r == kSlots % kWideLanes) {
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)c, philox_step, kUniformSlot, tag}, k0, k1);
        u = bits_to_uniform(b.x);
      }
      u = __shfl_sync(grp.mask, u, kSlots % kWideLanes);
    }
    grp.sync();
    return u;
  }
};

// A chain's metric: this lane's diagonal entries, or the dense minv and W
// in device memory.
template <int D, bool Dense>
struct WideMetric {
  float im[WideK<D>];
  const float* minv;
  const float* W;

  // row k of A times x (shared, all D entries)
  static __device__ __forceinline__ float row(const float* A, int k, const float* x) {
    float s = 0.0f;
    for (int i = 0; i < D; ++i) s += A[(int64_t)k * D + i] * x[i];
    return s;
  }
  // 2 x kinetic energy of p (shared) over the warp; the dense form reads
  // every entry of p, so it follows the warp's barrier
  __device__ __forceinline__ float kinetic2(const float* p, const WideGroup& grp) const {
    float kin = 0.0f;
#pragma unroll
    for (int j = 0; j < WideK<D>; ++j) {
      const int k = grp.r + kWideLanes * j;
      if (k >= D) break;
      if constexpr (Dense)
        kin += p[k] * row(minv, k, p);
      else
        kin = __fadd_rn(kin, __fmul_rn(__fmul_rn(p[k], p[k]), im[j]));
    }
    return grp.sum(kin);
  }
};

// One trajectory of the chain at q (this lane's coordinates) with the
// noise z in g (shared, after the warp's barrier), the plain version's
// (ops/kernels/fused_hmc.py::leapfrog_trajectory): half kick, L x (drift,
// kick), half kick back.  Leaves the endpoint in qn, its gradient in g
// and the end momentum in ps; returns E0 - E1 (unguarded) in every lane.
template <class F, bool Dense>
__device__ __forceinline__ float wide_trajectory(const F& f, const WideMetric<F::D, Dense>& m,
                                                 const float (&q)[WideK<F::D>], float eps,
                                                 int n_leap, float* qn, float* g, float* ps,
                                                 const WideGroup& grp) {
  constexpr int D = F::D, K = WideK<D>;
  const int r = grp.r;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + kWideLanes * j;
    if (k >= D) break;
    if constexpr (Dense)
      ps[k] = m.row(m.W, k, g);
    else
      ps[k] = g[k] / sqrtf(fmaxf(m.im[j], 1e-20f));
    qn[k] = q[j];
  }
  grp.sync();
  const float kin0 = m.kinetic2(ps, grp);
  const float U0 = wide_eval(f, qn, g, grp);
  const float E0 = __fadd_rn(U0, __fmul_rn(0.5f, kin0));
  const float half_eps = 0.5f * eps;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + kWideLanes * j;
    if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(half_eps, g[k]));
  }
  float U1 = U0;
  for (int l = 0; l < n_leap; ++l) {
    if constexpr (Dense) grp.sync();  // the drift reads every entry of p
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = r + kWideLanes * j;
      if (k >= D) break;
      if constexpr (Dense)
        qn[k] = qn[k] + eps * m.row(m.minv, k, ps);
      else
        qn[k] = __fadd_rn(qn[k], __fmul_rn(__fmul_rn(eps, ps[k]), m.im[j]));
    }
    grp.sync();
    U1 = wide_eval(f, qn, g, grp);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = r + kWideLanes * j;
      if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(eps, g[k]));
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + kWideLanes * j;
    if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(-half_eps, g[k]));
  }
  grp.sync();
  const float kin1 = m.kinetic2(ps, grp);
  return __fsub_rn(E0, __fadd_rn(U1, __fmul_rn(0.5f, kin1)));
}

// -- the functor check's wide branch: a warp a point ------------------------------

constexpr int kWideEvalThreads = 128;

template <class F>
__global__ void __launch_bounds__(kWideEvalThreads)
wide_eval_kernel(F f, const float* q, int n_points, float* U, float* g) {
  constexpr int D = F::D;
  extern __shared__ float smem[];
  float* const qs = smem + wide_pad(F::kOperandFloats) +
                    (threadIdx.x / kWideLanes) * 2 * wide_pad(D);
  float* const gs = qs + wide_pad(D);
  f.stage(smem);
  __syncthreads();
  const int i = (int)blockIdx.x * (kWideEvalThreads / kWideLanes) + (int)(threadIdx.x / kWideLanes);
  if (i >= n_points) return;
  const WideGroup grp;
  for (int k = grp.r; k < D; k += kWideLanes) qs[k] = q[(int64_t)i * D + k];
  grp.sync();
  const float u = wide_eval(f, qs, gs, grp);
  for (int k = grp.r; k < D; k += kWideLanes) g[(int64_t)i * D + k] = gs[k];
  if (grp.r == 0) U[i] = u;
}

template <class F>
cudaError_t wide_density_eval(const F& f, const float* q, int n_points, float* U, float* g,
                              cudaStream_t stream, int* grid) {
  constexpr int chains = kWideEvalThreads / kWideLanes;
  const size_t smem =
      (wide_pad(F::kOperandFloats) + chains * 2 * wide_pad(F::D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wide_eval_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_points + chains - 1) / chains;
  wide_eval_kernel<F><<<blocks, kWideEvalThreads, smem, stream>>>(f, q, n_points, U, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = kWideEvalThreads;
  }
  return err;
}

}  // namespace binf
