// K3 for the AR(1) trajectory posterior, one lane a chain (fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(AR1Density, 1)

}  // namespace binf
