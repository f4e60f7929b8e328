// K4 for the three-component mixture, one lane a chain (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(MixtureDensity<3>, 1)

}  // namespace binf
