// Whole-run HMC for any device density, one kernel: the general sampling
// kernel (K4).
//
// Replaces binf_tpu/ops/pallas/fused_potential.py::_kernel
// (fused_potential_hmc_run), which runs a traced potential on a (D_pad, BC)
// tile over a sequential grid of step blocks.  Here a group of G lanes of
// a warp owns one chain (lanes.cuh: G from the data rows of the linear
// regression, 2 at n = 20; 1 for the diagonal Gaussian), keeps q, p and
// grad U in every lane's registers for the whole run and loops over all
// steps; the functor's data (densities.cuh) sits in shared memory, each
// lane's rows also in registers.  What it adds to the linear-regression kernel
// (fused_hmc.cu):
//
// - per-chain step sizes and a per-chain diagonal metric, or a dense metric
//   shared by all chains (p = W z, velocity M^-1 p; minv and W in shared
//   memory, read as broadcasts);
// - the divergence guard of _hmc_transition: NaN or |dE| > 1000 rejects;
// - thinning (every thin-th state is stored), or per-chain Welford moments
//   over the call's steps instead of draws;
// - ChEES: step t runs ceil(h[t % 256] * 2 T / eps) leapfrog steps, clipped
//   to [1, max_leapfrog], with T and eps those of the first chain of the
//   chain's block_chains tile, so every chain of a tile shares one loop
//   bound; lane 0 of a tile's first group may record the counts;
// - resume: the Philox counter's step is step_offset + t, where the caller
//   passes block_offset * steps_per_block, so chained calls replay one
//   uninterrupted call bit for bit.
//
// Bound: arithmetic, (L + 1) density evaluations per chain and step plus
// Philox; the draws (num_steps / thin, C, D) are the only large
// device-memory traffic.  One thread a chain left an SM with about four
// warps at 16,384 chains, each evaluation a chain of dependent FMAs over
// the data rows with its latency exposed; G lanes a chain give G times the
// warps, each lane a G-th of the rows, for log2 G shuffles of D values an
// evaluation, while the closed form after the row sums, the trajectory's
// updates and the accept test are done G times over.  So G is the
// narrowest group whose lanes hold all rows in registers, where the
// unrolled row loop needs no test (lanes.cuh): G = 2 at the model path's
// shape (n = 20, D = 5).  What bounds the kernel now is the work every
// lane of a group repeats; splitting the closed form, the updates and the
// accept test over the lanes is the next step (PERF.md).  The logistic,
// AR(1) and mixture branches take the width scripts/family_lanes.py's sweep chose
// (fused_potential.py::FAMILY_LANES; their rows are chains of accurate
// transcendentals, so the floor is the issue of those instructions), with
// the registers capped for 4 CTAs an SM (lanes.cuh::LaneOccupancy).  The
// lanes store the coordinates k with k % G == lane, so a warp's stores of
// a step are contiguous.  Per-chain accept counts are written as int32
// and summed by the caller.  Chains never wait for one another here (a
// ChEES tile's T and eps are inputs), so the kernel needs neither a grid
// barrier nor a thread-block cluster; its CTAs are independent.
//
// This file holds the C entry points; the kernel is
// fused_potential_kernel.cuh, instantiated for the linear regression at
// each lane-group width in fused_potential.g{1,2,4,8}.cu, for the diagonal
// Gaussian in fused_potential.diag.cu, and for the logistic regression,
// the AR(1) and the mixture densities at one lane in
// fused_potential.{logistic,ar1,mixture}.cu and at the chosen width in
// fused_potential.{logistic,mixture}.g8.cu and fused_potential.ar1.g4.cu
// (one nvcc process each).
// A traced density past 32 coordinates takes the wide branch
// (fused_wide.cuh: a group of W warps a chain, W = G / 32, its trajectory
// in shared memory, a dense metric read from device memory) in its unit
// of one shape (fused_potential_shape.cu); launch dispatches on the
// functor.
// binf_density_eval evaluates a functor at many points
// (density_eval.cuh), for the card's functor checks.

#include <cuda_runtime.h>

#include "c_api.cuh"
#include "densities.cuh"
#include "fused_potential.cuh"

// grid (3 ints) receives what was launched: CTAs, threads, 0 (not
// cooperative: the kernel has no grid barrier).
extern "C" int binf_fused_potential_hmc(int family, int D, int G,
                                        const binf::DensityOperands* ops,
                                        const binf::RunArgs* args, void* stream, int* grid) {
  return (int)binf::with_density(family, D, G, *ops, [&](auto dens, auto lanes) {
    return binf::launch<decltype(dens), decltype(lanes)::value>(dens, *args,
                                                                (cudaStream_t)stream, grid);
  });
}

// out (2 ints): CTAs of K4 an SM holds at once for this density, width
// and metric (dense or diagonal), and its registers a thread.
extern "C" int binf_fused_potential_occupancy(int family, int D, int G,
                                              const binf::DensityOperands* ops, int dense,
                                              int* out) {
  out[0] = out[1] = 0;
  return (int)binf::with_density(family, D, G, *ops, [&](auto dens, auto lanes) {
    return binf::occupancy<decltype(dens), decltype(lanes)::value>(dens, dense, out);
  });
}

// U (n,) and grad U (n, D) of the functor of (family, D) at q (n, D), G
// lanes a point; grid (2 ints) receives the CTAs and threads launched.
extern "C" int binf_density_eval(int family, int D, int G, const binf::DensityOperands* ops,
                                 const float* q, int n, float* U, float* g, void* stream,
                                 int* grid) {
  return (int)binf::with_density(family, D, G, *ops, [&](auto dens, auto lanes) {
    return binf::density_eval<decltype(dens), decltype(lanes)::value>(dens, q, n, U, g,
                                                                      (cudaStream_t)stream, grid);
  });
}
