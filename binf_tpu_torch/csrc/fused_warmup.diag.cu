// K3 for the diagonal Gaussian, one lane a chain (fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(DiagGaussianDensity<1>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<2>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<3>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<4>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<5>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<6>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<7>, 1)
BINF_K3_INSTANTIATE(DiagGaussianDensity<8>, 1)

}  // namespace binf
