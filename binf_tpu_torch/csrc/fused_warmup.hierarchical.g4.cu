// K3 for the hierarchical posterior of 8 groups (D = 21), lane groups of
// 4, each lane two groups (lanes.cuh, fused_warmup_kernel.cuh).
#include "fused_warmup_kernel.cuh"

namespace binf {

BINF_K3_INSTANTIATE(HierarchicalDensity<8>, 4)

}  // namespace binf
