// The device densities the general kernels (fused_warmup.cu,
// fused_potential.cu) are instantiated with, and the dispatch from a
// family code, a dimension and a lane-group width to a functor: with_density
// for the units of this directory, with_shape for a unit of one shape built
// at first use (fused_{warmup,potential}_shape.cu).  DensityOperands carries a
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
//   family 4, MixtureDensity<K> (D = 2 K + 1): p0 y (n,), p1 1/prior
//             variance (D,), p2 prior mean (D,); n; f0 the constant C
//   family 5, HierarchicalDensity<NG> (D = 2 NG + 5): p0 x (n,), p1 y
//             (NG n,), p2 counts (NG,), p3 (offset, N/2 + a, b, C); n points
//             a group
//   family 6, a traced density (traced_density.cuh): p0 the constant
//             buffer of the functor ops/kernels/density_compiler.py emits;
//             only units of one shape take it (shape.cuh), at one lane up
//             to 32 coordinates, its wide form at a group of warps past
//             them (fused_wide.cuh)
//
// with_density takes each family at the D its units instantiate: linear
// regression 2..8, the diagonal Gaussian and the logistic regression 1..8,
// AR(1) 4, the mixture at K = 3 (D = 7) and the hierarchical posterior at
// NG = 8 (D = 21).  K3 and K4 keep a chain's state in registers, so a D is
// a template argument and every one is a unit's instantiation; another D
// (ops/kernels/densities.py::KERNEL_DIMS: linear regression up to 16
// coefficients, the diagonal Gaussian and the logistic regression up to
// 32, the mixture at K = 2..8, the hierarchical posterior at NG = 2..16)
// gets a unit of its own, compiled at first use with BINF_SHAPE_FAMILY,
// BINF_SHAPE_D and BINF_SHAPE_G defined (shape.cuh).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ar1_density.cuh"
#include "diag_gaussian_density.cuh"
#include "hierarchical_density.cuh"
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
constexpr int kFamilyHierarchical = 5;
constexpr int kFamilyTraced = 6;
constexpr int kHierGroups = 8;  // the CLI's hierarchical model (binf_tpu/cli.py:43-62)

// The lane-group widths of the logistic, AR(1), mixture and hierarchical
// branches: one lane, and the width ops/kernels/fused_potential.py::
// FAMILY_LANES picks (fused_{warmup,potential}.<family>.cu and
// .<family>.g<G>.cu).
// scripts/family_lanes.py defines BINF_FAMILY_SWEEP and adds the units of
// the other widths of its sweep.
#ifndef BINF_FAMILY_SWEEP
#define BINF_LOGISTIC_G(X) X(1) X(8)
#define BINF_AR1_G(X) X(1) X(4)
#define BINF_MIXTURE_G(X) X(1) X(8)
#define BINF_HIER_G(X) X(1) X(4)
#else
#define BINF_LOGISTIC_G(X) X(1) X(4) X(8) X(16) X(32)
#define BINF_AR1_G(X) X(1) X(4) X(8) X(16) X(32)
#define BINF_MIXTURE_G(X) X(1) X(4) X(8) X(16) X(32)
#define BINF_HIER_G(X) X(1) X(2) X(4) X(8)
#endif

// A functor from its operands (the layouts above), and its family code.
template <class Density>
struct FromOperands;
template <int DC>
struct FromOperands<LinregDensity<DC>> {
  static constexpr int family = kFamilyLinreg;
  static LinregDensity<DC> make(const DensityOperands& o) {
    return {o.p0, o.p1, o.p2, o.p3, o.n, o.f0, o.f1};
  }
};
template <int DD>
struct FromOperands<DiagGaussianDensity<DD>> {
  static constexpr int family = kFamilyDiagGaussian;
  static DiagGaussianDensity<DD> make(const DensityOperands& o) { return {o.p0, o.p1}; }
};
template <int DD>
struct FromOperands<LogisticDensity<DD>> {
  static constexpr int family = kFamilyLogistic;
  static LogisticDensity<DD> make(const DensityOperands& o) {
    return {o.p0, o.p1, o.p2, o.p3, o.n, o.f0};
  }
};
template <int K>
struct FromOperands<MixtureDensity<K>> {
  static constexpr int family = kFamilyMixture;
  static MixtureDensity<K> make(const DensityOperands& o) { return {o.p0, o.p1, o.p2, o.n, o.f0}; }
};
template <>
struct FromOperands<AR1Density> {
  static constexpr int family = kFamilyAR1;
  static AR1Density make(const DensityOperands& o) { return {o.p0, o.p1, o.p2, o.p3, o.n}; }
};
template <int NG>
struct FromOperands<HierarchicalDensity<NG>> {
  static constexpr int family = kFamilyHierarchical;
  static HierarchicalDensity<NG> make(const DensityOperands& o) {
    return {o.p0, o.p1, o.p2, o.p3, o.n};
  }
};

// Calls f(functor, std::integral_constant<int, G>{}) with the functor of
// (family, D) and the lane-group width G (lanes.cuh): the D each family
// checks (above), G in 1, 2, 4, 8 for linear regression, the widths above
// for the logistic regression, AR(1), the mixture and the hierarchical
// posterior, and 1 for the diagonal Gaussian; cudaErrorInvalidValue for
// anything else (a D or a width nobody instantiated).
template <class F>
cudaError_t with_density(int family, int D, int G, const DensityOperands& o, F&& f) {
#define BINF_LINREG_G(DD, GG)                                                      \
  case GG:                                                                          \
    return f(FromOperands<LinregDensity<DD - 1>>::make(o),                         \
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
    if (G == 1)                                                                      \
      return f(FromOperands<DiagGaussianDensity<DD>>::make(o), std::integral_constant<int, 1>{}); \
    break;
#define BINF_CASE(GG) \
  case GG:            \
    return f(dens, std::integral_constant<int, GG>{});
#define BINF_LOGISTIC(DD)                                                        \
  case DD: {                                                                     \
    const auto dens = FromOperands<LogisticDensity<DD>>::make(o);                \
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
    const auto dens = FromOperands<AR1Density>::make(o);
    switch (G) {
      BINF_AR1_G(BINF_CASE)
      default:
        break;
    }
  } else if (family == kFamilyMixture && D == MixtureDensity<3>::D) {
    const auto dens = FromOperands<MixtureDensity<3>>::make(o);
    switch (G) {
      BINF_MIXTURE_G(BINF_CASE)
      default:
        break;
    }
  } else if (family == kFamilyHierarchical && D == HierarchicalDensity<kHierGroups>::D) {
    const auto dens = FromOperands<HierarchicalDensity<kHierGroups>>::make(o);
    switch (G) {
      BINF_HIER_G(BINF_CASE)
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

// with_density for a unit of one shape: calls f(functor, G) when (family,
// D, G) are the shape's, else returns cudaErrorInvalidValue.
template <class Density, int kG, class F>
cudaError_t with_shape(int family, int D, int G, const DensityOperands& o, F&& f) {
  if (family != FromOperands<Density>::family || D != Density::D || G != kG)
    return cudaErrorInvalidValue;
  return f(FromOperands<Density>::make(o), std::integral_constant<int, kG>{});
}

}  // namespace binf
