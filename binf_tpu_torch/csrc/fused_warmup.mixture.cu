// K3 for the three-component mixture, one lane a chain (fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(MixtureDensity<3>, 1)

}  // namespace binf
