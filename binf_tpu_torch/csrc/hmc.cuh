// Pieces the general whole-run kernels share (fused_warmup.cu,
// fused_potential.cu): a dense metric, the ChEES trajectory length of a
// step and a block-wide sum.  The trajectory itself is lanes.cuh's
// lane_trajectory, which follows binf_tpu/ops/pallas/fused_potential.py::
// _hmc_transition: half kick, L x (drift, kick), retract half a kick.
#pragma once

namespace binf {

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
