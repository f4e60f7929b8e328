// The runtime of a traced density: the functor base every header that
// ops/kernels/density_compiler.py emits derives from, and the helpers the
// emitted code calls.  The compiler lowers the aten graph of a log density's
// value and gradient (make_fx of torch.func.grad_and_value) to C++ over a
// chain's per-thread values; the result is a functor with the interface of
// diag_gaussian_density.cuh (shared_floats, stage, value_and_grad), so K3
// (fused_warmup_kernel.cuh) and K4 (fused_potential_kernel.cuh) take it as
// they take the hand-written ones, at one lane a chain.  Family code 6
// (densities.cuh::kFamilyTraced) names it; a unit of one traced density is
// fused_{warmup,potential}_shape.cu with the emitted header force-included
// (ops/kernels/_build.py::shape_libraries).
//
// The operands are one float buffer: every tensor constant of the graph,
// integers as their bit patterns, at offsets the emitted code names.  K3 and
// K4 stage it in shared memory (NF floats).  No fast math: the emitted code
// keeps IEEE inf and NaN, which K4's divergence guard reads.
//
// The same header holds the group form, TracedGroup_<key> (deriving from
// the one-lane functor): value_and_grad(qs, gs, grp), called by every
// thread of a group that runs one chain, its row loops strided over the
// group (chain_grid_kernel.cuh::TracedChain runs it in K7; Group is
// chain_group.cuh's ChainGroup there, host_compat.h's BinfHostGroup on the
// host).  Past 32 coordinates the header holds the wide form alone,
// TracedWide_<key> (kWide; deriving from a base functor that only holds the
// operands): the same interface, the position read from qs where it is
// used and the gradient strided over the group; K3's and K4's wide
// branches (fused_wide.cuh) run it on a group of W warps a chain
// (chain_group.cuh's WarpGroup<W>, W from D), K7 on its group of warps a
// chain (BINF_TRACED_WIDE names it for the shape units).
//
// host_compat.h lets the same text compile as host C++.
#pragma once

#include "host_compat.h"

#ifdef __CUDACC__
#include "chain_group.cuh"
#include "densities.cuh"
#endif

#include <math.h>
#include <stdint.h>

namespace binf {

template <int DD, int NF>
struct TracedDensity {
  static constexpr int D = DD;
  static constexpr int kOperandFloats = NF;

  const float* c;  // (NF,) the graph's constants, device memory, then shared

  __host__ __device__ int shared_floats() const { return NF; }

  // Copy the constants into shared memory and point at them there.  Every
  // thread of the block calls this; the caller synchronises before the
  // first use.
  __device__ void stage(float* smem) {
    for (int i = threadIdx.x; i < NF; i += blockDim.x) smem[i] = c[i];
    c = smem;
  }
};

namespace traced {

// an integer constant of the operand buffer, stored as its bit pattern
__host__ __device__ __forceinline__ int bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  memcpy(&i, &x, sizeof i);
  return i;
#endif
}

// torch.maximum / torch.minimum: NaN in either operand gives NaN
template <class T>
__host__ __device__ __forceinline__ T maximum(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <class T>
__host__ __device__ __forceinline__ T minimum(T a, T b) {
  return (a != a || a < b) ? a : b;
}

__host__ __device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// torch.sign: 0 and NaN pass through
__host__ __device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
__host__ __device__ __forceinline__ int sign(int x) { return (x > 0) - (x < 0); }

// Python's floor division and modulo on integers, torch.remainder on floats
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__host__ __device__ __forceinline__ int remainder(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__host__ __device__ __forceinline__ float remainder(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r += b;
  return r;
}

// a negative index counts from the end, as aten's indexing does
__host__ __device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

// argmax / argmin: the first extreme wins, NaN counts as the extreme
template <class T>
__host__ __device__ __forceinline__ bool above(T v, T a) {
  return v > a || (v != v && a == a);
}
template <class T>
__host__ __device__ __forceinline__ bool below(T v, T a) {
  return v < a || (v != v && a == a);
}

// aten's cummax / cummin step (cummax_cummin_helper): the new value takes
// the running extreme's place when it is NaN, or the extreme is not and
// the new value is at least (cummax) or at most (cummin) as extreme
template <class T>
__host__ __device__ __forceinline__ bool cum_takes(T v, T out, bool max) {
  return v != v || (out == out && (max ? v >= out : v <= out));
}

// aten's logcumsumexp step (_log_add_exp_helper)
__host__ __device__ __forceinline__ float log_add_exp(float x, float y) {
  const float lo = minimum(x, y), hi = maximum(x, y);
  if (lo != hi || isfinite(lo)) return hi + log1pf(expf(lo - hi));
  return x;
}

// aten's logsumexp shift: the maximum, or 0 where it is infinite
__host__ __device__ __forceinline__ float lse_shift(float m) { return isinf(m) ? 0.0f : m; }

// Whether (a, ia) sorts after (b, ib) in a stable sort: NaN is the
// largest value, equal values keep their original order.
template <class T>
__host__ __device__ __forceinline__ bool sort_after(T a, int ia, T b, int ib, bool desc) {
  const bool an = a != a, bn = b != b;
  if (an || bn) {
    if (an && bn) return ia > ib;
    return desc ? bn : an;
  }
  if (a == b) return ia > ib;
  return desc ? a < b : a > b;
}
template <class T>
__host__ __device__ __forceinline__ void cswap(T& a, int& ia, T& b, int& ib, bool desc) {
  if (sort_after(a, ia, b, ib, desc)) {
    const T t = a;
    a = b;
    b = t;
    const int it = ia;
    ia = ib;
    ib = it;
  }
}

// The digamma function in float32, aten's calc_digamma (CUDA has none):
// the recurrence up to 10, then the asymptotic series; the reflection
// below 0.
__host__ __device__ __forceinline__ float digamma_pos(float x) {
  float result = 0.0f;
  while (x < 10.0f) {
    result -= 1.0f / x;
    x += 1.0f;
  }
  if (x == 10.0f) return result + 2.25175258906672110764f;
  float y = 0.0f;
  if (x < 1.0e17f) {
    const float z = 1.0f / (x * x);
    float p = 8.33333333333333333333E-2f;
    p = p * z - 2.10927960927960927961E-2f;
    p = p * z + 7.57575757575757575758E-3f;
    p = p * z - 4.16666666666666666667E-3f;
    p = p * z + 3.96825396825396825397E-3f;
    p = p * z - 8.33333333333333333333E-3f;
    p = p * z + 8.33333333333333333333E-2f;
    y = z * p;
  }
  return result + logf(x) - (0.5f / x) - y;
}
__host__ __device__ __forceinline__ float digamma(float x) {
  if (x == 0.0f) return copysignf(INFINITY, -x);
  if (x < 0.0f) {
    if (x == truncf(x)) return NAN;
    const double r = (double)x - trunc((double)x);
    const float pi_over_tan = (float)(3.14159265358979323846 / tan(3.14159265358979323846 * r));
    return digamma_pos(1.0f - x) - pi_over_tan;
  }
  return digamma_pos(x);
}

// The trigamma function (polygamma of order 1, digamma's derivative),
// aten's calc_trigamma
__host__ __device__ __forceinline__ float trigamma(float x) {
  float sign = 1.0f, result = 0.0f;
  if (x < 0.5f) {
    sign = -1.0f;
    const float s = sinf(3.14159265358979323846f * x);
    result -= (3.14159265358979323846f * 3.14159265358979323846f) / (s * s);
    x = 1.0f - x;
  }
  for (int i = 0; i < 6; ++i) {
    result += 1.0f / (x * x);
    x += 1.0f;
  }
  const float ixx = 1.0f / (x * x);
  result += (1.0f + 1.0f / (2.0f * x) +
             ixx * (1.0f / 6.0f - ixx * (1.0f / 30.0f - ixx * (1.0f / 42.0f)))) / x;
  return sign * result;
}

}  // namespace traced
}  // namespace binf

// The specialisations K3 and K4 look a functor up by: its operands from the
// C interface (p0, the constant buffer) and its evaluation at one lane a
// chain.  The emitted header names its functor with this macro.
#ifdef __CUDACC__
#define BINF_TRACED_DEVICE(T)                                        \
  template <>                                                        \
  struct FromOperands<T> {                                           \
    static constexpr int family = kFamilyTraced;                     \
    static T make(const DensityOperands& o) {                        \
      T t;                                                           \
      t.c = o.p0;                                                    \
      return t;                                                      \
    }                                                                \
  };                                                                 \
  template <>                                                        \
  struct Lanes<T, 1> : OneLane<T> {                                  \
    using OneLane<T>::OneLane;                                       \
  };
// A wide form (a position past the one-lane functor's coordinates) has
// no Lanes: K3's and K4's launches take their wide branches for it
// (fused_wide.cuh).
#define BINF_TRACED_WIDE(T)                                          \
  template <>                                                        \
  struct FromOperands<T> {                                           \
    static constexpr int family = kFamilyTraced;                     \
    static T make(const DensityOperands& o) {                        \
      T t;                                                           \
      t.c = o.p0;                                                    \
      return t;                                                      \
    }                                                                \
  };
#else
#define BINF_TRACED_DEVICE(T)
#define BINF_TRACED_WIDE(T)
#endif
