// K4 for lane groups of 8: the linear regression (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_LINREG(8)

}  // namespace binf
