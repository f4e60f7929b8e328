// K3 for the three-component mixture, lane groups of 8 (lanes.cuh,
// fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(MixtureDensity<3>, 8)

}  // namespace binf
