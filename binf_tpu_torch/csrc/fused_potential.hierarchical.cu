// K4 for the hierarchical posterior of 8 groups (D = 21), one lane a
// chain (fused_potential_kernel.cuh).
#include "fused_potential_kernel.cuh"

namespace binf {

BINF_K4_INSTANTIATE(HierarchicalDensity<8>, 1)

}  // namespace binf
