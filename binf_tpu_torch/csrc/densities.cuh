// The device densities the general kernels (fused_warmup.cu,
// fused_potential.cu) are instantiated with, and the dispatch from a
// family code, a dimension and a lane-group width to a functor.  DensityOperands carries a
// functor's operands across the C interface; each family fixes their
// meaning (binf_tpu_torch/ops/kernels/densities.py builds them):
//
//   family 0, LinregDensity<D - 1>:  p0 V (n, D-1), p1 y (n,), p2 1/prior
//             variance, p3 prior mean; n; f0 n/2 + Gamma shape, f1 rate
//   family 1, DiagGaussianDensity<D>: p0 means, p1 standard deviations
//   family 2, LogisticDensity<D>:     p0 X (n, D), p1 y (n,), p2 1/prior
//             variance, p3 prior mean; n; f0 the constant C
//   family 3, AR1Density (D = 4):     p0 y (T,), p1 1/prior variance (3,),
//             p2 prior mean (3,), p3 (T/2 + a, b, C); n = T
//   family 4, MixtureDensity (D = 7): p0 y (n,), p1 1/prior variance (7,),
//             p2 prior mean (7,); n; f0 the constant C
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ar1_density.cuh"
#include "diag_gaussian_density.cuh"
#include "lanes.cuh"
#include "linreg_density.cuh"
#include "logistic_density.cuh"
#include "mixture_density.cuh"

namespace binf {

struct DensityOperands {
  const float* p0;
  const float* p1;
  const float* p2;
  const float* p3;
  int n;
  float f0;
  float f1;
};

constexpr int kFamilyLinreg = 0;
constexpr int kFamilyDiagGaussian = 1;
constexpr int kFamilyLogistic = 2;
constexpr int kFamilyAR1 = 3;
constexpr int kFamilyMixture = 4;
constexpr int kMaxD = 8;

// The lane-group widths of the logistic, AR(1) and mixture branches: one
// lane, and the width ops/kernels/fused_potential.py::FAMILY_LANES picks
// (fused_{warmup,potential}.<family>.cu and .<family>.g<G>.cu).
// scripts/family_lanes.py defines BINF_FAMILY_SWEEP and adds the units of
// the other widths of its sweep.
#ifndef BINF_FAMILY_SWEEP
#define BINF_LOGISTIC_G(X) X(1) X(8)
#define BINF_AR1_G(X) X(1) X(4)
#define BINF_MIXTURE_G(X) X(1) X(8)
#else
#define BINF_LOGISTIC_G(X) X(1) X(4) X(8) X(16) X(32)
#define BINF_AR1_G(X) X(1) X(4) X(8) X(16) X(32)
#define BINF_MIXTURE_G(X) X(1) X(4) X(8) X(16) X(32)
#endif

// Calls f(functor, std::integral_constant<int, G>{}) with the functor of
// (family, D) and the lane-group width G (lanes.cuh): 1 <= D <= 8 (linear
// regression needs D >= 2, AR(1) is D = 4, the mixture D = 7), G in 1, 2,
// 4, 8 for linear regression, the widths above for the logistic
// regression, AR(1) and the mixture, and 1 for the diagonal Gaussian;
// cudaErrorInvalidValue for anything else (a width nobody instantiated).
template <class F>
cudaError_t with_density(int family, int D, int G, const DensityOperands& o, F&& f) {
#define BINF_LINREG_G(DD, GG)                                                      \
  case GG:                                                                          \
    return f(LinregDensity<DD - 1>{o.p0, o.p1, o.p2, o.p3, o.n, o.f0, o.f1},       \
             std::integral_constant<int, GG>{});
#define BINF_LINREG(DD)    \
  case DD:                 \
    switch (G) {           \
      BINF_LINREG_G(DD, 1) \
      BINF_LINREG_G(DD, 2) \
      BINF_LINREG_G(DD, 4) \
      BINF_LINREG_G(DD, 8) \
      default:             \
        break;             \
    }                      \
    break;
#define BINF_DIAG(DD)                                                                \
  case DD:                                                                           \
    if (G == 1) return f(DiagGaussianDensity<DD>{o.p0, o.p1}, std::integral_constant<int, 1>{}); \
    break;
#define BINF_CASE(GG) \
  case GG:            \
    return f(dens, std::integral_constant<int, GG>{});
#define BINF_LOGISTIC(DD)                                                        \
  case DD: {                                                                     \
    const LogisticDensity<DD> dens{o.p0, o.p1, o.p2, o.p3, o.n, o.f0};           \
    switch (G) {                                                                 \
      BINF_LOGISTIC_G(BINF_CASE)                                                 \
      default:                                                                   \
        break;                                                                   \
    }                                                                            \
    break;                                                                       \
  }
  if (family == kFamilyLinreg) {
    switch (D) {
      BINF_LINREG(2)
      BINF_LINREG(3)
      BINF_LINREG(4)
      BINF_LINREG(5)
      BINF_LINREG(6)
      BINF_LINREG(7)
      BINF_LINREG(8)
      default:
        break;
    }
  } else if (family == kFamilyDiagGaussian) {
    switch (D) {
      BINF_DIAG(1)
      BINF_DIAG(2)
      BINF_DIAG(3)
      BINF_DIAG(4)
      BINF_DIAG(5)
      BINF_DIAG(6)
      BINF_DIAG(7)
      BINF_DIAG(8)
      default:
        break;
    }
  } else if (family == kFamilyLogistic) {
    switch (D) {
      BINF_LOGISTIC(1)
      BINF_LOGISTIC(2)
      BINF_LOGISTIC(3)
      BINF_LOGISTIC(4)
      BINF_LOGISTIC(5)
      BINF_LOGISTIC(6)
      BINF_LOGISTIC(7)
      BINF_LOGISTIC(8)
      default:
        break;
    }
  } else if (family == kFamilyAR1 && D == AR1Density::D) {
    const AR1Density dens{o.p0, o.p1, o.p2, o.p3, o.n};
    switch (G) {
      BINF_AR1_G(BINF_CASE)
      default:
        break;
    }
  } else if (family == kFamilyMixture && D == MixtureDensity::D) {
    const MixtureDensity dens{o.p0, o.p1, o.p2, o.n, o.f0};
    switch (G) {
      BINF_MIXTURE_G(BINF_CASE)
      default:
        break;
    }
  }
#undef BINF_LINREG_G
#undef BINF_LINREG
#undef BINF_DIAG
#undef BINF_LOGISTIC
#undef BINF_CASE
  return cudaErrorInvalidValue;
}

}  // namespace binf
