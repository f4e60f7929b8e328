// K3 for the hierarchical posterior of 8 groups (D = 21), one lane a
// chain (fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(HierarchicalDensity<8>, 1)

}  // namespace binf
