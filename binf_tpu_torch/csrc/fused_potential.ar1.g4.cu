// K4 for the AR(1) posterior, lane groups of 4 (lanes.cuh,
// fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(AR1Density, 4)

}  // namespace binf
