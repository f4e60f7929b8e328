// The few CUDA spellings a traced density's functor (traced_density.cuh and
// the header ops/kernels/density_compiler.py emits) uses, for a host C++
// compiler: the same text then compiles with g++ into a shared library, so
// that the emitted arithmetic can be checked on a machine with no card
// (tests/test_torch_density_compiler.py).  Under nvcc this header adds
// nothing.
#pragma once

#ifndef __CUDACC__
#include <math.h>
#include <stdint.h>
#include <string.h>

#define __host__
#define __device__
#define __forceinline__ inline

// one thread of a one-thread block: stage() copies every operand itself
struct BinfHostDim3 {
  unsigned x, y, z;
};
static const BinfHostDim3 threadIdx = {0, 0, 0};
static const BinfHostDim3 blockDim = {1, 1, 1};
#endif
