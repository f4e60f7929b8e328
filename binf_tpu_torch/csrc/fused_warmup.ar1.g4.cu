// K3 for the AR(1) posterior, lane groups of 4 (lanes.cuh,
// fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(AR1Density, 4)

}  // namespace binf
