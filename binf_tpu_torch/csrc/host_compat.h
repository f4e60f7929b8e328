// The few CUDA spellings a traced density's functor (traced_density.cuh and
// the header ops/kernels/density_compiler.py emits) uses, for a host C++
// compiler: the same text then compiles with g++ into a shared library, so
// that the emitted arithmetic can be checked on a machine with no card
// (tests/test_torch_density_compiler.py), the group form on a group of
// host threads (tests/test_torch_chain_grid_traced.py).  Under nvcc this
// header adds nothing.
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

#include <condition_variable>
#include <mutex>
#include <vector>

// What the T host threads of a group share: a barrier (a generation count
// under a mutex) and one partial a thread.
struct BinfHostGroupShared {
  explicit BinfHostGroupShared(int T) : T(T), red(T) {}
  int T;
  std::mutex m;
  std::condition_variable cv;
  int waiting = 0;
  long generation = 0;
  std::vector<float> red;

  void barrier() {
    std::unique_lock<std::mutex> lock(m);
    const long gen = generation;
    if (++waiting == T) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != gen; });
    }
  }
};

// Rank r of a group of T host threads (T a power of two or a multiple of
// 32), the counterpart of the chain-grid kernel's group of warps
// (chain_group.cuh::WarpGroup) for the group form of a traced functor.
// sum, max and min combine as the card does: an xor butterfly within each
// warp of min(T, 32) threads, the pair's lower rank first, then (past one
// warp) the warps' partials in warp order; every thread returns the same
// bits.
struct BinfHostGroup {
  int r, T;
  BinfHostGroupShared* s;

  void sync() const { s->barrier(); }

  // the warps' partials from 0 (sums, as WarpGroup::sum) or from the
  // first warp's (max, min)
  template <class Op>
  float reduce(float v, bool from_zero, Op op) const {
    s->red[r] = v;
    sync();
    const int W = T < 32 ? T : 32;
    std::vector<float> x(W), y(W);
    float out = 0.0f;
    for (int w = 0; w < T / W; ++w) {
      for (int i = 0; i < W; ++i) x[i] = s->red[w * W + i];
      for (int off = W / 2; off > 0; off >>= 1) {
        for (int i = 0; i < W; ++i) y[i] = (i & off) ? op(x[i ^ off], x[i]) : op(x[i], x[i ^ off]);
        x.swap(y);
      }
      out = (T == W || (w == 0 && !from_zero)) ? x[0] : op(out, x[0]);
    }
    sync();
    return out;
  }
  float sum(float v) const {
    return reduce(v, true, [](float a, float b) { return a + b; });
  }
  float max(float v) const {
    return reduce(v, false, [](float a, float b) { return (a != a || a > b) ? a : b; });
  }
  float min(float v) const {
    return reduce(v, false, [](float a, float b) { return (a != a || a < b) ? a : b; });
  }
};
#endif
