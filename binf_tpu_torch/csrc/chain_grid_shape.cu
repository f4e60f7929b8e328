// The chain-grid kernel (K7, chain_grid_kernel.cuh) on the group form of
// one traced density: the header ops/kernels/density_compiler.py emits is
// force-included (-include) and BINF_TRACED_TYPE names its group form
// (binf::TracedGroup_<key>).  Built at first use into its own library by
// ops/kernels/_build.py::chain_grid_library, keyed by the header's key.
// An entry point called with another D returns cudaErrorInvalidValue.
#include <cuda_runtime.h>

#include "c_api.cuh"
#include "chain_grid_kernel.cuh"

#ifndef BINF_TRACED_TYPE
#error "chain_grid_shape.cu needs -DBINF_TRACED_TYPE and the emitted header (-include)"
#endif

namespace {
using TracedK7 = binf::TracedChain<BINF_TRACED_TYPE>;
constexpr int kTracedD = BINF_TRACED_TYPE::D;
constexpr int kTracedRows = BINF_TRACED_TYPE::kGroupRows;
}  // namespace

// The whole run on the traced density whose constants are c (device
// memory); the geometry gives a chain no more warps than its rows use.
extern "C" int binf_chain_grid_traced_hmc(const float* c, const binf::CgArgs* args, void* stream,
                                          int* grid) {
  using namespace binf;
  const CgArgs& a = *args;
  if (a.D != kTracedD || a.thin <= 0 || a.n_chains <= 0 || a.num_leapfrog < 0)
    return cudaErrorInvalidValue;
  return (int)cg_run<TracedK7>(TracedOperands{c, 0}, a,
                               cg_geometry(a.n_chains, cg_sms(), kTracedRows),
                               (cudaStream_t)stream, grid);
}

// The group form alone at n_pos positions: warps a position (1, 2, 4 or
// 8), or 0 for the run's geometry.
extern "C" int binf_group_eval(const float* c, const float* qs, int n_pos, int D, float* U,
                               float* grads, int warps, void* stream, int* grid) {
  using namespace binf;
  if (D != kTracedD || n_pos <= 0 || !cg_warps_valid(warps)) return cudaErrorInvalidValue;
  return (int)cg_eval<TracedK7>(TracedOperands{c, 0}, qs, n_pos, D, U, grads,
                                cg_geometry(n_pos, cg_sms(), kTracedRows, warps),
                                (cudaStream_t)stream, grid);
}
