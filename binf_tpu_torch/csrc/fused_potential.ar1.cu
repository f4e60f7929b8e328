// K4 for the AR(1) trajectory posterior, one lane a chain (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(AR1Density, 1)

}  // namespace binf
