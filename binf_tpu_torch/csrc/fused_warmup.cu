// Stan-window warmup in one kernel (K3): step-size search, pooled dual
// averaging, a windowed cross-chain diagonal metric and, with ChEES, the
// trajectory length.
//
// Replaces binf_tpu/ops/pallas/fused_potential.py::_warmup_kernel
// (fused_warmup_run): fixed-length trajectories with the optional
// init_search, or ChEES trajectories (:595-649, :716-724) whose mean length
// T is adapted by Adam on the tile-pooled ChEES surrogate gradient.
// Statistics pool over the chains of one tile of block_chains, as on the
// TPU, and each step needs sums over the tile: the mean acceptance, the
// per-coordinate mean and (in slow windows) the per-coordinate sum of
// squared deviations; ChEES adds the means of the start and end positions
// and then the sum of the per-chain surrogate gradients.
//
// The whole card runs one tile.  The kernel is launched cooperatively
// with as many CTAs as the card holds at once (occupancy x SMs), so a grid
// barrier is safe, and a group of G lanes owns one chain for the whole
// warmup (lanes.cuh).  Each CTA takes a contiguous run of chains; when
// C x G exceeds what the card holds, its CTAs loop over rounds of
// kK3Threads / G chains, and a chain's position (and, with ChEES, its
// start, end, end momentum and acceptance between the two barriers of a
// step) goes to device memory between rounds; otherwise it stays in
// registers.  Tile sums are built from partials of fixed slices of S
// chains (S = kK3Threads / G, a CTA round's chains, halved until it
// divides block_chains): a warp's lanes add its share by a fixed xor
// butterfly, the slice's warps are added in warp order through shared
// memory, and one partial per slice goes, indexed by slice, to a
// double-buffered array.  After the grid barrier every CTA adds its tiles'
// partials in one fixed order (thread j takes slices j, j + kK3Threads,
// ..., then a block-wide sum) and applies the per-tile update to its copy
// of the tile's state: in shared memory, or in device memory for a CTA
// whose chains span more than kMaxCtaTiles tiles (small tiles, or more
// chains than the card holds at once), so that any block_chains dividing
// C runs.  The bits therefore depend on (C, block_chains, G) and never on
// the grid size or the card's SM count.
// The slow window's second moment is each share's own sum of squared
// deviations, combined by Chan's rule for equal counts (plus the share
// size times the squared distances of the share means from the slice
// mean, then the same for slices in the tile), so a fixed step needs one
// grid barrier; ChEES needs two (the tile means, then the surrogate
// gradient), each search trial one.  The barrier is a generation counter
// on a global word (atomicAdd, fence, spin), as cooperative groups' grid
// sync, so the build needs no -rdc.  A thread-block cluster (at most 16
// SMs sharing their shared memory) is not enough: the main path pools all
// 16,384 chains in one tile, which needs the whole card.
//
// Bound: arithmetic, (L + 1) density evaluations per chain and step as in
// fused_hmc.cu; what holds it is the step's serial part.  At the main
// shape (G = 2: 128 CTAs, one an SM, so that a lane may hold its 10 rows
// in registers) chip_smoke.py times a fixed warmup at L = 10 and at L = 1
// (PERF.md): the grid barrier, the block-wide sums after it and the one
// thread per tile that updates the adaptation take most of a step, the
// trajectories the rest.
//
// The density is any functor of densities.cuh.  The logistic, AR(1) and
// mixture branches at G > 1 cap their registers for 2 CTAs an SM
// (lanes.cuh::LaneOccupancy), so that the card holds 8,192 chains' groups
// of 8 in one round.  This file holds the C entry points; the kernel is
// fused_warmup_kernel.cuh, instantiated for the linear regression at each
// lane-group width in fused_warmup.g{1,2,4,8}.cu, for the diagonal
// Gaussian in fused_warmup.diag.cu, and for the logistic, AR(1) and
// mixture densities in fused_warmup.{logistic,ar1,mixture}.cu (one lane)
// and at the chosen width in fused_warmup.{logistic,mixture}.g8.cu and
// fused_warmup.ar1.g4.cu (one nvcc process each).
// A traced density past 32 coordinates takes the wide branch
// (fused_wide.cuh, fused_warmup_kernel.cuh: a group of W warps a chain,
// W = G / 32, its trajectory in shared memory, the tiles' states in device
// memory) in its
// unit of one shape (fused_warmup_shape.cu); launch dispatches on the
// functor.

#include <cuda_runtime.h>

#include "c_api.cuh"
#include "densities.cuh"
#include "fused_warmup.cuh"

// grid (3 ints) receives what was launched: CTAs, threads, 1 (cooperative).
extern "C" int binf_fused_warmup(int family, int D, int G, const binf::DensityOperands* ops,
                                 const binf::WarmupArgs* args, void* stream, int* grid) {
  return (int)binf::with_density(family, D, G, *ops, [&](auto dens, auto lanes) {
    return binf::launch<decltype(dens), decltype(lanes)::value>(dens, *args,
                                                                (cudaStream_t)stream, grid);
  });
}

// out[0]: CTAs of the warmup kernel the current card holds at once
// (occupancy x SMs) for this density and lane-group width, the most a
// cooperative launch may take; out[1]: bytes of one tile's state in
// WarmupArgs::tile_state; out[2]: the kernel's registers a thread.
extern "C" int binf_fused_warmup_max_ctas(int family, int D, int G,
                                          const binf::DensityOperands* ops, int* out) {
  out[0] = out[1] = out[2] = 0;
  return (int)binf::with_density(family, D, G, *ops, [&](auto dens, auto lanes) {
    return binf::max_ctas<decltype(dens), decltype(lanes)::value>(dens, out);
  });
}
