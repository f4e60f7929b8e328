// K4 for the logistic regression, one lane a chain (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(LogisticDensity<1>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<2>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<3>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<4>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<5>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<6>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<7>, 1)
BINF_K4_INSTANTIATE(LogisticDensity<8>, 1)

}  // namespace binf
