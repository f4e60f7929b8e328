// One evaluation of a device density at many points, a thread a point:
// U and grad U through the functor's one-lane Lanes (what K3 and K4 call
// at G = 1).  The card's check of a functor against its plain version and
// torch.func runs it (ops/kernels/densities.py::density_eval); the
// whole-run kernels never do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace binf {

constexpr int kEvalThreads = 128;

template <class Density>
__global__ void __launch_bounds__(kEvalThreads)
density_eval_kernel(Density dens, const float* q, int n_points, float* U, float* g) {
  constexpr int D = Density::D;
  extern __shared__ float smem[];
  dens.stage(smem);
  __syncthreads();
  const int i = (int)blockIdx.x * kEvalThreads + (int)threadIdx.x;
  if (i >= n_points) return;
  const Lanes<Density, 1> lanes(dens);
  float x[D], gx[D];
#pragma unroll
  for (int k = 0; k < D; ++k) x[k] = q[(int64_t)i * D + k];
  U[i] = lanes.value_and_grad(x, gx);
#pragma unroll
  for (int k = 0; k < D; ++k) g[(int64_t)i * D + k] = gx[k];
}

template <class Density>
cudaError_t density_eval(const Density& dens, const float* q, int n_points, float* U, float* g,
                         cudaStream_t stream, int* grid) {
  const size_t smem = dens.shared_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(density_eval_kernel<Density>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_points + kEvalThreads - 1) / kEvalThreads;
  density_eval_kernel<Density><<<blocks, kEvalThreads, smem, stream>>>(dens, q, n_points, U, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = kEvalThreads;
  }
  return err;
}

}  // namespace binf
