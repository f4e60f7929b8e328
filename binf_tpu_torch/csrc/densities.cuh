// The device densities the general kernels (fused_warmup.cu,
// fused_potential.cu) are instantiated with, and the dispatch from a
// family code and a dimension to a functor.  DensityOperands carries a
// functor's operands across the C interface; each family fixes their
// meaning (binf_tpu_torch/ops/kernels/densities.py builds them):
//
//   family 0, LinregDensity<D - 1>:  p0 V (n, D-1), p1 y (n,), p2 1/prior
//             variance, p3 prior mean; n; f0 n/2 + Gamma shape, f1 rate
//   family 1, DiagGaussianDensity<D>: p0 means, p1 standard deviations
#pragma once

#include <cuda_runtime.h>

#include "diag_gaussian_density.cuh"
#include "linreg_density.cuh"

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
constexpr int kMaxD = 8;

// Calls f(functor) with the functor of (family, D), 1 <= D <= 8 (linear
// regression needs D >= 2); cudaErrorInvalidValue for anything else.
template <class F>
cudaError_t with_density(int family, int D, const DensityOperands& o, F&& f) {
#define BINF_LINREG(DD) \
  case DD:              \
    return f(LinregDensity<DD - 1>{o.p0, o.p1, o.p2, o.p3, o.n, o.f0, o.f1});
#define BINF_DIAG(DD) \
  case DD:            \
    return f(DiagGaussianDensity<DD>{o.p0, o.p1});
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
  }
#undef BINF_LINREG
#undef BINF_DIAG
  return cudaErrorInvalidValue;
}

}  // namespace binf
