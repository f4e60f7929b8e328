// The functor and lane-group width of a unit of one shape, one that no
// unit of this directory instantiates (fused_warmup_shape.cu,
// fused_potential_shape.cu).  ops/kernels/_build.py::shape_libraries
// compiles such a unit at first use with the shape as macros:
// BINF_SHAPE_FAMILY (densities.cuh's family code), BINF_SHAPE_D and
// BINF_SHAPE_G.  The mixture's K and the hierarchical posterior's NG follow
// from D (2 K + 1, 2 NG + 5), the linear regression's coefficients too (D -
// 1).  A traced density (family 6) is the functor BINF_TRACED_TYPE of the
// header the build force-includes (traced_density.cuh), at G = 1, or its
// wide form past 32 coordinates at G = 32 W, a group of W warps a chain
// (fused_wide.cuh).
#pragma once

#include "densities.cuh"
#include "fused_wide.cuh"

#if !defined(BINF_SHAPE_FAMILY) || !defined(BINF_SHAPE_D) || !defined(BINF_SHAPE_G)
#error "a shape unit is compiled with BINF_SHAPE_FAMILY, BINF_SHAPE_D and BINF_SHAPE_G"
#endif

namespace binf {

#if BINF_SHAPE_FAMILY == 0
using ShapeDensity = LinregDensity<BINF_SHAPE_D - 1>;
#elif BINF_SHAPE_FAMILY == 1
using ShapeDensity = DiagGaussianDensity<BINF_SHAPE_D>;
#elif BINF_SHAPE_FAMILY == 2
using ShapeDensity = LogisticDensity<BINF_SHAPE_D>;
#elif BINF_SHAPE_FAMILY == 3
using ShapeDensity = AR1Density;
#elif BINF_SHAPE_FAMILY == 4
using ShapeDensity = MixtureDensity<(BINF_SHAPE_D - 1) / 2>;
#elif BINF_SHAPE_FAMILY == 5
using ShapeDensity = HierarchicalDensity<(BINF_SHAPE_D - 5) / 2>;
#elif BINF_SHAPE_FAMILY == 6
using ShapeDensity = BINF_TRACED_TYPE;
#else
#error "BINF_SHAPE_FAMILY is not a family code of densities.cuh"
#endif
static_assert(ShapeDensity::D == BINF_SHAPE_D, "BINF_SHAPE_D is not a dimension of the family");
constexpr int kShapeG = BINF_SHAPE_G;
static_assert(kShapeG >= 1 && (kShapeG & (kShapeG - 1)) == 0 &&
                  kShapeG <= (IsWide<ShapeDensity>::value ? 256 : 32),
              "a lane group is a power of two up to 32 lanes (a wide form's: 1 to 8 warps)");

}  // namespace binf
