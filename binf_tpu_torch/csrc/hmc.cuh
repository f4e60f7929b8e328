// One leapfrog trajectory for one chain held in registers, with a diagonal
// or a dense metric, and a block-wide sum.  Shared by the whole-run kernels
// (fused_hmc.cu, fused_warmup.cu, fused_potential.cu); the density is any
// functor with
//     static constexpr int D;  float value_and_grad(const float (&q)[D], float (&g)[D]) const;
//
// The arithmetic follows binf_tpu/ops/pallas/fused_potential.py::_hmc_transition
// (and fused_hmc.py::_kernel.hmc_step): half kick, L x (drift, kick),
// retract half a kick; the carry holds (q, p, U, grad U) so a trajectory
// costs L + 1 evaluations.
#pragma once

namespace binf {

// Diagonal metric: p = z / sqrt(im), velocity p * im, 2 x kinetic sum p^2 im.
template <int D>
struct DiagMetric {
  float im[D];

  __device__ __forceinline__ void momentum(const float (&z)[D], float (&p)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = z[k] / sqrtf(fmaxf(im[k], 1e-20f));
  }
  __device__ __forceinline__ float kinetic2(const float (&p)[D]) const {
    float kin = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) kin += p[k] * p[k] * im[k];
    return kin;
  }
  __device__ __forceinline__ void drift(float (&q)[D], const float (&p)[D], float eps) const {
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = q[k] + eps * p[k] * im[k];
  }
  __device__ __forceinline__ void velocity(const float (&p)[D], float (&v)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = p[k] * im[k];
  }
};

// Dense metric shared by all chains: minv = M^-1 and W with W W^T = M, both
// (D, D) row-major in shared memory (read as broadcasts): p = W z, velocity
// minv p, 2 x kinetic p . minv p.
template <int D>
struct DenseMetric {
  const float* minv;
  const float* W;

  __device__ __forceinline__ static void matvec(const float* A, const float (&x)[D],
                                                float (&y)[D]) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += A[i * D + j] * x[j];
      y[i] = s;
    }
  }
  __device__ __forceinline__ void momentum(const float (&z)[D], float (&p)[D]) const {
    matvec(W, z, p);
  }
  __device__ __forceinline__ void velocity(const float (&p)[D], float (&v)[D]) const {
    matvec(minv, p, v);
  }
  __device__ __forceinline__ float kinetic2(const float (&p)[D]) const {
    float v[D], kin = 0.0f;
    velocity(p, v);
#pragma unroll
    for (int k = 0; k < D; ++k) kin += p[k] * v[k];
    return kin;
  }
  __device__ __forceinline__ void drift(float (&q)[D], const float (&p)[D], float eps) const {
    float v[D];
    velocity(p, v);
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = q[k] + eps * v[k];
  }
};

// Runs the trajectory from q with momentum noise z; writes the endpoint to
// q_new and its momentum (after the last half kick) to p, and returns
// E0 - E1 (no divergence guard: callers apply their own).
template <class Density, class Metric>
__device__ __forceinline__ float leapfrog_trajectory(
    const Density& dens, const Metric& metric, const float (&q)[Density::D],
    const float (&z)[Density::D], float eps, int num_leapfrog,
    float (&q_new)[Density::D], float (&p)[Density::D]) {
  constexpr int D = Density::D;
  float g[D];
  metric.momentum(z, p);
  const float U0 = dens.value_and_grad(q, g);
  const float E0 = U0 + 0.5f * metric.kinetic2(p);

  const float half_eps = 0.5f * eps;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    p[k] = p[k] - half_eps * g[k];
    q_new[k] = q[k];
  }
  float U1 = U0;
  for (int l = 0; l < num_leapfrog; ++l) {
    metric.drift(q_new, p, eps);
    U1 = dens.value_and_grad(q_new, g);
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = p[k] - eps * g[k];
  }
#pragma unroll
  for (int k = 0; k < D; ++k) p[k] = p[k] + half_eps * g[k];
  return E0 - (U1 + 0.5f * metric.kinetic2(p));
}

// The same with a diagonal metric given as an array, for callers that do
// not need the end momentum.
template <class Density>
__device__ __forceinline__ float leapfrog_trajectory(
    const Density& dens, const float (&q)[Density::D], const float (&z)[Density::D],
    float eps, const float (&im)[Density::D], int num_leapfrog,
    float (&q_new)[Density::D]) {
  constexpr int D = Density::D;
  DiagMetric<D> metric;
#pragma unroll
  for (int k = 0; k < D; ++k) metric.im[k] = im[k];
  float p[D];
  return leapfrog_trajectory(dens, metric, q, z, eps, num_leapfrog, q_new, p);
}

// ChEES trajectory length of one step (fused_potential.py:409-417, :600-606):
// ceil(h * 2 * T / eps) clipped to [1, max_leapfrog], in float32 in that
// order with IEEE division.  Clipping in float first sends NaN to 1 and
// infinity to max_leapfrog, as XLA's saturating conversion does.
__device__ __forceinline__ int chees_leapfrog(float h, float T, float eps, int max_leapfrog) {
  const float x = h * 2.0f * T / eps;
  return (int)fminf(fmaxf(ceilf(x), 1.0f), (float)max_leapfrog);
}

// Sum of N values over the whole block; every thread gets the same sums
// (xor butterfly inside warps, then each thread adds the per-warp partials
// in one fixed order).  `red` is shared scratch of 32 * N floats.  All
// threads of the block must call it; blockDim.x is a multiple of 32.
template <int N>
__device__ __forceinline__ void block_sum(float* v, float* red) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += red[w * N + k];
    v[k] = s;
  }
  __syncthreads();
}

}  // namespace binf
