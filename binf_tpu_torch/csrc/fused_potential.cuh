// K4's launch interface, shared by the entry point (fused_potential.cu)
// and the kernel's instantiations (fused_potential.<family or width>.cu,
// one translation unit each, so that nvcc builds them in parallel); the
// kernel is in fused_potential_kernel.cuh, the functor check's evaluation
// in density_eval.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace binf {

constexpr int kK4Threads = 128;
constexpr int kHaltonLen = 256;

// Everything but the density; binf_tpu_torch/ops/kernels/fused_potential.py
// fills the same struct through ctypes.
struct RunArgs {
  const float* q0;   // (C, D)
  const float* eps;  // (C,)
  const float* im;   // (C, D) diagonal, or (D, D) M^-1 when dense
  const float* W;    // (D, D), dense only
  int n_chains, num_steps, num_leapfrog, thin, moments, dense, chees, bc, max_leapfrog;
  uint32_t step_offset;     // block_offset * steps_per_block
  uint64_t seed;
  const float* T_tile;      // (tiles,), ChEES only
  const float* eps_tile;    // (tiles,), ChEES only
  const float* halton;      // (256,), ChEES only
  const float* mom;         // staged noise (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad;
  float* draws;             // (num_steps / thin, C, D), unless moments
  float* mean;              // (C, D), moments only
  float* m2;                // (C, D), moments only
  float* qf;                // (C, D)
  int* accepts;             // (C,)
  int* leap_out;            // (num_steps, tiles) leapfrog counts, or null
};

// grid receives the CTAs and threads launched and 0 (not cooperative).
template <class Density, int G>
cudaError_t launch(const Density& dens, const RunArgs& a, cudaStream_t stream, int* grid);

// out[0]: CTAs of K4 an SM holds at once (diagonal metric, or dense);
// out[1]: its registers a thread.
template <class Density, int G>
cudaError_t occupancy(const Density& dens, int dense, int* out);

// One evaluation at n_points points, G lanes a point (density_eval.cuh);
// grid receives the CTAs and threads launched.
template <class Density, int G>
cudaError_t density_eval(const Density& dens, const float* q, int n_points, float* U, float* g,
                         cudaStream_t stream, int* grid);

}  // namespace binf
