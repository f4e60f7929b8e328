// K3's launch interface, shared by the entry points (fused_warmup.cu)
// and the kernel's instantiations (fused_warmup.<family or width>.cu, one
// translation unit each, so that nvcc builds them in parallel); the
// kernel is in fused_warmup_kernel.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace binf {

constexpr int kK3Threads = 256;
constexpr int kMaxCtaTiles = 32;  // tiles whose state a CTA keeps in shared memory
constexpr int kSearchTrials = 20; // doubling budget of the step-size search
constexpr int kMaxResets = 64;
constexpr int kHaltonLen = 256;   // jitter table of the ChEES trajectories

// Everything but the density; binf_tpu_torch/ops/kernels/fused_potential.py
// fills the same struct through ctypes.
struct WarmupArgs {
  const float* q0;  // (C, D)
  int n_chains, bc, num_warmup, num_leapfrog;
  float eps0, target_accept;
  int init_search, initial_buffer, final_buffer;
  const int* resets;
  int n_resets;
  uint64_t seed;
  const float* mom;  // staged noise (steps, d_pad, C) and (steps, 1, C), or null
  const float* unif;
  int d_pad;
  int chees, max_leapfrog;
  float log_max_leapfrog;  // float32 log(max_leapfrog), as the reference adds it
  const float* halton;     // (256,), ChEES only
  float* scratch;          // (C, 3 D + 1), ChEES with rounds > 1 only
  int* leap_out;           // (num_warmup, tiles) leapfrog counts, or null
  float* q;                // outputs: (C, D), (C,), (C, D), (C,) (T, ChEES only)
  float* eps_out;
  float* im_out;
  float* T_out;
  int slice;               // S, chains of one partial
  int ctas, rounds;        // grid, and rounds of kK3Threads / G chains per CTA
  float* part;             // (2, 4 D + 1, C / S) slice partials
  unsigned* bar;           // (2,) grid barrier: arrivals, generation (zeroed)
  // the tile states of CTAs whose chains span more than kMaxCtaTiles tiles
  // (C / bc + ctas states), or null when none does
  float* tile_state;
  int64_t tile_state_bytes;
};

// Launch the warmup kernel cooperatively (a.ctas CTAs, a.rounds rounds);
// grid receives the CTAs and threads launched and 1 (cooperative).
template <class Density, int G>
cudaError_t launch(const Density& dens, const WarmupArgs& a, cudaStream_t stream, int* grid);
// out[0]: the CTAs of the kernel the current card holds at once; out[1]:
// the bytes of one tile's state in a.tile_state; out[2]: registers a thread.
template <class Density, int G>
cudaError_t max_ctas(const Density& dens, int* out);

}  // namespace binf
