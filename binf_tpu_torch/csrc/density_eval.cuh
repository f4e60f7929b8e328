// One evaluation of a device density at many points, a group of G lanes a
// point: U and grad U through the functor's Lanes<Density, G>, the
// evaluation K3 and K4 run at that width.  The card's check of a functor
// against its plain version and torch.func runs it
// (ops/kernels/densities.py::density_eval); the whole-run kernels never
// do.  Instantiated beside K4 for every functor and width
// (fused_potential_kernel.cuh::BINF_K4_INSTANTIATE).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_wide.cuh"
#include "lanes.cuh"

namespace binf {

constexpr int kEvalThreads = 128;

template <class Density, int G>
__global__ void __launch_bounds__(kEvalThreads)
density_eval_kernel(Density dens, const float* q, int n_points, float* U, float* g) {
  constexpr int D = Density::D;
  extern __shared__ float smem[];
  dens.stage(smem);
  __syncthreads();
  // a whole group leaves together: the point is the group's
  const int i = (int)(((int64_t)blockIdx.x * kEvalThreads + threadIdx.x) / G);
  const int lane = (int)(threadIdx.x & (G - 1));
  if (i >= n_points) return;
  const Lanes<Density, G> lanes(dens);
  float x[D], gx[D];
#pragma unroll
  for (int k = 0; k < D; ++k) x[k] = q[(int64_t)i * D + k];
  const float u = lanes.value_and_grad(x, gx);
  if (lane == 0) U[i] = u;
#pragma unroll
  for (int k = 0; k < D; ++k)
    if (k % G == lane) g[(int64_t)i * D + k] = gx[k];
}

// grid receives the CTAs and threads launched.
template <class Density, int G>
cudaError_t narrow_density_eval(const Density& dens, const float* q, int n_points, float* U,
                                float* g, cudaStream_t stream, int* grid) {
  const size_t smem = dens.shared_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(density_eval_kernel<Density, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(((int64_t)n_points * G + kEvalThreads - 1) / kEvalThreads);
  density_eval_kernel<Density, G><<<blocks, kEvalThreads, smem, stream>>>(dens, q, n_points, U, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = kEvalThreads;
  }
  return err;
}

// The branch of the functor: a group of G / 32 warps a point for a wide form
// (fused_wide.cuh), else the lane group above.
template <class Density, int G>
cudaError_t density_eval(const Density& dens, const float* q, int n_points, float* U, float* g,
                         cudaStream_t stream, int* grid) {
  if constexpr (IsWide<Density>::value)
    return wide_density_eval<Density, G>(dens, q, n_points, U, g, stream, grid);
  else
    return narrow_density_eval<Density, G>(dens, q, n_points, U, g, stream, grid);
}

}  // namespace binf
