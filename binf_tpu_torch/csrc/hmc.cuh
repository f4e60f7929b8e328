// One leapfrog trajectory with a diagonal metric, for one chain held in
// registers, and a block-wide sum.  Shared by the whole-run kernels
// (fused_hmc.cu, fused_warmup.cu); the density is any functor with
//     static constexpr int D;  float value_and_grad(const float (&q)[D], float (&g)[D]) const;
//
// The arithmetic follows binf_tpu/ops/pallas/fused_potential.py::_hmc_transition
// (and fused_hmc.py::_kernel.hmc_step): half kick, L x (drift, kick),
// retract half a kick; the carry holds (q, p, U, grad U) so a trajectory
// costs L + 1 evaluations.
#pragma once

namespace binf {

// Runs the trajectory from q with momentum noise z; writes the endpoint to
// q_new and returns E0 - E1 (no divergence guard: callers apply their own).
template <class Density>
__device__ __forceinline__ float leapfrog_trajectory(
    const Density& dens, const float (&q)[Density::D], const float (&z)[Density::D],
    float eps, const float (&im)[Density::D], int num_leapfrog,
    float (&q_new)[Density::D]) {
  constexpr int D = Density::D;
  float p[D], g[D];
#pragma unroll
  for (int k = 0; k < D; ++k) p[k] = z[k] / sqrtf(fmaxf(im[k], 1e-20f));
  const float U0 = dens.value_and_grad(q, g);
  float kin = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) kin += p[k] * p[k] * im[k];
  const float E0 = U0 + 0.5f * kin;

  const float half_eps = 0.5f * eps;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    p[k] = p[k] - half_eps * g[k];
    q_new[k] = q[k];
  }
  float U1 = U0;
  for (int l = 0; l < num_leapfrog; ++l) {
#pragma unroll
    for (int k = 0; k < D; ++k) q_new[k] = q_new[k] + eps * p[k] * im[k];
    U1 = dens.value_and_grad(q_new, g);
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = p[k] - eps * g[k];
  }
  kin = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    p[k] = p[k] + half_eps * g[k];
    kin += p[k] * p[k] * im[k];
  }
  return E0 - (U1 + 0.5f * kin);
}

// Sum of N values over the whole block; every thread gets the same sums
// (xor butterfly inside warps, then each thread adds the per-warp partials
// in one fixed order).  `red` is shared scratch of 32 * N floats.  All
// threads of the block must call it; blockDim.x is a multiple of 32.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
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
