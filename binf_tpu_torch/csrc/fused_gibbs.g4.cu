// K5 for lane groups of 4 (fused_gibbs_kernel.cuh), d = 1..7.
#include "fused_gibbs_kernel.cuh"

namespace binf {

BINF_K5(4)

}  // namespace binf
