// K4 for the diagonal Gaussian, one lane a chain (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(DiagGaussianDensity<1>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<2>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<3>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<4>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<5>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<6>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<7>, 1)
BINF_K4_INSTANTIATE(DiagGaussianDensity<8>, 1)

}  // namespace binf
