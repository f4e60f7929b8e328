// K3 for the logistic regression, lane groups of 8 (lanes.cuh,
// fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(LogisticDensity<1>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<2>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<3>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<4>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<5>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<6>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<7>, 8)
BINF_K3_INSTANTIATE(LogisticDensity<8>, 8)

}  // namespace binf
