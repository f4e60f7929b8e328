// K4 for the hierarchical posterior of 8 groups (D = 21), lane groups of
// 4, each lane two groups (lanes.cuh, fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(HierarchicalDensity<8>, 4)

}  // namespace binf
