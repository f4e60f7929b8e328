// K4 for the three-component mixture, lane groups of 8 (lanes.cuh,
// fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(MixtureDensity<3>, 8)

}  // namespace binf
