// What the wide branches of K3 (fused_warmup_kernel.cuh::wide_warmup_kernel)
// and K4 (fused_potential_kernel.cuh::wide_potential_kernel) share, and the
// functor check's wide branch, for a traced density past the one-lane
// functor's 32 coordinates (the wide form that ops/kernels/
// density_compiler.py emits, TracedWide_<key>: kWide).
//
// The one-lane branches keep a chain's q, p, grad U, proposal and metric in
// one thread's registers (lanes.cuh::lane_trajectory), some 7 D floats:
// past D ~ 32 that spills.  Here a group of W warps runs one chain
// (chain_group.cuh::WarpGroup<W>), as a group of warps does in K7
// (chain_grid_kernel.cuh): the chain's trajectory position, gradient and
// momentum live in three buffers of D floats in shared memory, which the
// wide form reads and writes, and thread r of the group's T = 32 W owns the
// coordinates k = r, r + T, ... (its part of the position, the metric and
// the moments in registers, WideK<D, W> of them).  The kernels take W as
// the lane-group width G = 32 W of their shape unit; ops/kernels/
// fused_potential.py::wide_warps picks it from D: one warp up to 256
// coordinates, then the fewest warps that keep a thread's coordinates at
// 8, up to the 8 warps of K3's CTA.  Every update of the
// trajectory runs over a thread's own coordinates; the kinetic energy is a
// sum over the group (the same bits in every thread), so every thread
// takes the same MH decision.  The rounding is the one-lane branch's
// (lanes.cuh: __fmul_rn, __fadd_rn in the plain version's order) but for
// the order of the sums over coordinates.
//
// The noise is the one-lane branch's stream: Philox slot s gives normals 2 s
// and 2 s + 1 (thread s mod T draws it into the gradient buffer, which is
// free at a step's start), the uniform comes from kUniformSlot on thread
// slots mod T and goes to every thread as a group sum (the others add 0);
// or the staged noise of the JAX layout.
//
// A dense metric is not staged: minv and W (D x D) are read from device
// memory, where L2 holds them up to D ~ 2,000, a row a coordinate, so 2 D^2
// floats never count against shared memory (ops/kernels/fused_potential.py::
// _shared_need counts the operands, the Halton table and the chains'
// buffers and partials).  The wide form is one __noinline__ function, so
// each kernel compiles it once whatever its call sites.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "chain_group.cuh"
#include "hmc.cuh"
#include "philox.cuh"
#include "traced_density.cuh"

namespace binf {


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
// a thread's coordinates
template <int D, int W>
constexpr int WideK = (D + 32 * W - 1) / (32 * W);
// a chain's shared floats: the trajectory position, the gradient (and the
// noise at a step's start), the momentum, then the group's partials
template <int D>
constexpr int kWideChainFloats = 3 * wide_pad(D) + kGroupPartials;

// G, the width a unit names, as the warps of a wide branch
template <int G>
constexpr int wide_warps_of() {
  static_assert(G == 32 || G == 64 || G == 128 || G == 256,
                "a wide branch runs a group of 1, 2, 4 or 8 warps a chain (G = 32 W)");
  return G / 32;
}

template <class F, int W>
__device__ __noinline__ float wide_eval(const F& f, const float* qs, float* gs,
                                        const WarpGroup<W>& grp) {
  return f.value_and_grad(qs, gs, grp);
}

// One step's noise of chain c into z (shared, D floats) and the uniform,
// in every thread; ends at the group's barrier.
struct WideNoise {
  uint64_t seed;
  uint32_t tag;
  const float* mom;  // staged (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad, n_chains;

  template <int D, int W>
  __device__ __forceinline__ float draw(int c, uint32_t philox_step, int staged_step, float* z,
                                        const WarpGroup<W>& grp) const {
    constexpr int T = 32 * W;
    float u = 0.0f;
    if (mom != nullptr) {
      for (int k = grp.r; k < D; k += T)
        z[k] = mom[((int64_t)staged_step * d_pad + k) * n_chains + c];
      u = unif[(int64_t)staged_step * n_chains + c];
    } else {
      const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
      constexpr int kSlots = (D + 1) / 2;
      for (int s = grp.r; s < kSlots; s += T) {
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)c, philox_step, (uint32_t)s, tag}, k0, k1);
        z[2 * s] = bits_to_normal(b.x, b.y);
        if (2 * s + 1 < D) z[2 * s + 1] = bits_to_normal(b.z, b.w);
      }
      if (grp.r == kSlots % T) {
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)c, philox_step, kUniformSlot, tag}, k0, k1);
        u = bits_to_uniform(b.x);
      }
      u = grp.sum(u);  // u, exactly: the other threads add 0
    }
    grp.sync();
    return u;
  }
};

// A chain's metric: this thread's diagonal entries, or the dense minv and W
// in device memory.
template <int D, bool Dense, int Warps>
struct WideMetric {
  static constexpr int T = 32 * Warps;
  float im[WideK<D, Warps>];
  const float* minv;
  const float* W;

  // row k of A times x (shared, all D entries)
  static __device__ __forceinline__ float row(const float* A, int k, const float* x) {
    float s = 0.0f;
    for (int i = 0; i < D; ++i) s += A[(int64_t)k * D + i] * x[i];
    return s;
  }
  // 2 x kinetic energy of p (shared) over the group; the dense form reads
  // every entry of p, so it follows the group's barrier
  __device__ __forceinline__ float kinetic2(const float* p, const WarpGroup<Warps>& grp) const {
    float kin = 0.0f;
#pragma unroll
    for (int j = 0; j < WideK<D, Warps>; ++j) {
      const int k = grp.r + T * j;
      if (k >= D) break;
      if constexpr (Dense)
        kin += p[k] * row(minv, k, p);
      else
        kin = __fadd_rn(kin, __fmul_rn(__fmul_rn(p[k], p[k]), im[j]));
    }
    return grp.sum(kin);
  }
};

// One trajectory of the chain at q (this thread's coordinates) with the
// noise z in g (shared, after the group's barrier), the plain version's
// (ops/kernels/fused_hmc.py::leapfrog_trajectory): half kick, L x (drift,
// kick), half kick back.  Leaves the endpoint in qn, its gradient in g
// and the end momentum in ps; returns E0 - E1 (unguarded) in every thread.
template <class F, bool Dense, int W>
__device__ __forceinline__ float wide_trajectory(const F& f, const WideMetric<F::D, Dense, W>& m,
                                                 const float (&q)[WideK<F::D, W>], float eps,
                                                 int n_leap, float* qn, float* g, float* ps,
                                                 const WarpGroup<W>& grp) {
  constexpr int D = F::D, K = WideK<D, W>, T = 32 * W;
  const int r = grp.r;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + T * j;
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
    const int k = r + T * j;
    if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(half_eps, g[k]));
  }
  float U1 = U0;
  for (int l = 0; l < n_leap; ++l) {
    if constexpr (Dense) grp.sync();  // the drift reads every entry of p
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = r + T * j;
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
      const int k = r + T * j;
      if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(eps, g[k]));
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = r + T * j;
    if (k < D) ps[k] = __fsub_rn(ps[k], __fmul_rn(-half_eps, g[k]));
  }
  grp.sync();
  const float kin1 = m.kinetic2(ps, grp);
  return __fsub_rn(E0, __fadd_rn(U1, __fmul_rn(0.5f, kin1)));
}

// -- the functor check's wide branch: a group of W warps a point ------------------

constexpr int kWideEvalThreads = 128;

template <int W>
constexpr int kWideEvalCta = 32 * W > kWideEvalThreads ? 32 * W : kWideEvalThreads;

template <class F, int W>
__global__ void __launch_bounds__(kWideEvalCta<W>)
wide_eval_kernel(F f, const float* q, int n_points, float* U, float* g) {
  constexpr int D = F::D, T = 32 * W, kPoints = kWideEvalCta<W> / T;
  constexpr int kPointFloats = 2 * wide_pad(D) + kGroupPartials;
  extern __shared__ float smem[];
  const int slot = (int)threadIdx.x / T;
  float* const qs = smem + wide_pad(F::kOperandFloats) + slot * kPointFloats;
  float* const gs = qs + wide_pad(D);
  f.stage(smem);
  __syncthreads();
  const int i = (int)blockIdx.x * kPoints + slot;
  if (i >= n_points) return;
  const WarpGroup<W> grp = warp_group<W>(gs + wide_pad(D));
  for (int k = grp.r; k < D; k += T) qs[k] = q[(int64_t)i * D + k];
  grp.sync();
  const float u = wide_eval(f, qs, gs, grp);
  for (int k = grp.r; k < D; k += T) g[(int64_t)i * D + k] = gs[k];
  if (grp.r == 0) U[i] = u;
}

template <class F, int G>
cudaError_t wide_density_eval(const F& f, const float* q, int n_points, float* U, float* g,
                              cudaStream_t stream, int* grid) {
  constexpr int W = wide_warps_of<G>(), threads = kWideEvalCta<W>, points = threads / (32 * W);
  const size_t smem = (wide_pad(F::kOperandFloats) +
                       points * (2 * wide_pad(F::D) + kGroupPartials)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wide_eval_kernel<F, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_points + points - 1) / points;
  wide_eval_kernel<F, W><<<blocks, threads, smem, stream>>>(f, q, n_points, U, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = threads;
  }
  return err;
}

}  // namespace binf
