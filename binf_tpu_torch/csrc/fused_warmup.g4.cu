// K3 for lane groups of 4: the linear regression (fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_LINREG(4)

}  // namespace binf
