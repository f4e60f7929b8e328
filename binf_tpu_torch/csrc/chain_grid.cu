// Whole-run HMC with one chain per group of warps: the chain-grid kernel (K7).
//
// Replaces binf_tpu/ops/pallas/chain_grid.py::_cg_kernel (chain_grid_hmc_run).
// The TPU kernel puts S chains on each step of a sequential grid and runs a
// traced density at each chain's natural shapes, with the data axis in the
// vector lanes.  Here a group of G warps owns one chain for the whole run
// and a CTA of up to 8 warps holds 8 / G chains, which share one staged
// copy of the density's operands (chain_grid_kernel.cuh).  This unit runs
// the Gram chromatin density, a group functor (gram_density.cuh) in which
// a thread owns beads and walks all their pairs, over W, logD and their
// transposes; chain_grid_shape.cu runs the group form of any density the
// density compiler lowers, one unit a density.  A chain's flat position q
// (D = sum of the variables' sizes, sorted names), the trajectory's end
// point, momentum, gradients and its (x, |x|^2) scratch live in shared
// memory; all num_steps x L evaluations run inside one launch.
//
// Per step, as _cg_kernel.hmc_step: D normals and one uniform from Philox
// (counter: chain, absolute step = step_offset + t, slot, kTagChainGrid; two
// normals a slot) or from staged noise; p = z / sqrt(max(im, 1e-20)); half
// kick, L x (drift, kick), retract half a kick; accept log(max(u, 1e-30)) <
// E0 - E1, with NaN or |E0 - E1| > 1000 rejected; then draws (every thin-th
// step) or Welford moments counted from the call's first step, stored with
// consecutive threads on consecutive coordinates.  U and grad U of the
// current state are carried from step to step (the endpoint's on
// acceptance), so a trajectory costs L evaluations, with the same bits.
// Kinetic energies and the density's sums are warp butterflies and partials
// added in warp order, so two calls, or two chained calls and one, give the
// same bits, whichever CTA a chain lands on.  The order does depend on the
// warps a chain G and on whether the matrices are staged (one staged warp
// takes each unordered pair once, more warps or unstaged matrices walk the
// ordered pairs), and cg_geometry picks both from the chain count, the bead
// count and the card's SM count: a chain's bits are fixed for one chain
// count on one card, not across chain counts that change G.
//
// Bound: operations, counted as the least work: each unordered pair once,
// ~38 float operations and one log (N(N-1)/2 of them).  The previous design
// gave each chain a CTA of 256 threads: a 64-bead chain's matrices (64 KB,
// the same for every chain) held an SM to 3 chains, so 2,048 chains ran in
// 6 rounds, and every evaluation paid CTA barriers, shuffle trees per row
// and a tail on one warp (36% of an evaluation's cycles on an H100;
// PERF.md).  Here the chains of a CTA share the staged matrices and meet no
// CTA barrier after staging: at 2,048 chains and 64 beads a chain is one
// warp, a CTA of 8 chains takes ~100 KB, 2 CTAs an SM, one round.  Fewer
// chains get more warps each (G up to 8, at their own named barrier), so
// 256 chains still fill the card.  Matrices that do not fit shared memory
// (N > ~110 beside the state) are read from device memory, where the 50 MB
// L2 holds them, a warp's 32 lanes reading one line.

#include <cuda_runtime.h>

#include "c_api.cuh"
#include "chain_grid_kernel.cuh"

extern "C" int binf_chain_grid_hmc(const binf::GramOperands* ops, const binf::CgArgs* args,
                                   void* stream, int* grid) {
  using namespace binf;
  const CgArgs& a = *args;
  if (a.D != 1 + 3 * ops->n || a.thin <= 0 || a.n_chains <= 0 || a.num_leapfrog < 0)
    return cudaErrorInvalidValue;
  return (int)cg_run<GramChain>(*ops, a, cg_geometry(a.n_chains, cg_sms()),
                                (cudaStream_t)stream, grid);
}

// The functor alone at n_pos positions: warps a position (1, 2, 4 or 8),
// or 0 for the run's geometry (as chain_grid_shape.cu's binf_group_eval).
extern "C" int binf_group_eval(const binf::GramOperands* ops, const float* qs, int n_pos, int D,
                               float* U, float* grads, int warps, void* stream, int* grid) {
  using namespace binf;
  if (D != 1 + 3 * ops->n || n_pos <= 0 || !cg_warps_valid(warps)) return cudaErrorInvalidValue;
  return (int)cg_eval<GramChain>(*ops, qs, n_pos, D, U, grads,
                                 cg_geometry(n_pos, cg_sms(), INT_MAX, warps),
                                 (cudaStream_t)stream, grid);
}
