// The group of warps that runs one chain, shared by K7 (chain_grid_kernel.cuh,
// on the Gram density of gram_density.cuh and the group form of a traced
// density) and by K3's and K4's wide branches (fused_wide.cuh, on the wide
// form of a traced density).  A group is W warps, T = 32 W threads: fixed
// at compile time (WarpGroup<W>, the wide branches, whose W follows from D),
// or set at run time (ChainGroup = WarpGroup<0>, K7, whose warps a chain
// follow the chain count).
//
// Thread r of the group owns coordinates r, r + T, ...; a group of one warp
// synchronises with __syncwarp, a larger one at its own named barrier id (1
// + the group's index in its CTA; 0 is __syncthreads).  sum, max and min
// give the same bits in every thread: an xor butterfly in each warp, the
// pair's lower lane first (NaN wins max and min, as torch.maximum), then
// the warps' partials (red, W floats of shared memory, reused between
// calls) in warp order, from 0 for sums and from the first warp's for max
// and min; host_compat.h::BinfHostGroup does the same on host threads.
#pragma once

#include <cuda_runtime.h>

namespace binf {

constexpr int kGroupPartials = 8;  // a group's partials: one a warp of the widest group

// T of a group: 32 W threads, or (W = 0) set at run time
template <int W>
struct GroupSize {
  static constexpr int T = 32 * W;
  __device__ __forceinline__ explicit GroupSize(int) {}
};
template <>
struct GroupSize<0> {
  int T;
  __device__ __forceinline__ explicit GroupSize(int t) : T(t) {}
};

template <int W>
struct WarpGroup : GroupSize<W> {
  using GroupSize<W>::T;
  int r, id;
  float* red;

  __device__ __forceinline__ WarpGroup(int r, int T, int id, float* red)
      : GroupSize<W>(T), r(r), id(id), red(red) {}

  __device__ __forceinline__ void sync() const {
    if (T == 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(T) : "memory");
  }

  template <bool Max>
  static __device__ __forceinline__ float pick(float a, float b) {
    return (a != a || (Max ? a > b : a < b)) ? a : b;
  }

  // Op 0: sum; 1: max; 2: min, partials in part
  template <int Op>
  __device__ __forceinline__ float reduce(float v, float* part) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float w = __shfl_xor_sync(0xFFFFFFFFu, v, off);
      if constexpr (Op == 0)
        v += w;
      else
        v = (lane & off) ? pick<Op == 1>(w, v) : pick<Op == 1>(v, w);
    }
    if (T == 32) return v;
    if (lane == 0) part[r / 32] = v;
    sync();
    float s = Op == 0 ? 0.0f : part[0];
    for (int w = Op == 0 ? 0 : 1; w < T / 32; ++w) {
      if constexpr (Op == 0)
        s += part[w];
      else
        s = pick<Op == 1>(s, part[w]);
    }
    sync();
    return s;
  }

  __device__ __forceinline__ float sum(float v, float* part) const { return reduce<0>(v, part); }
  __device__ __forceinline__ float sum(float v) const { return reduce<0>(v, red); }
  __device__ __forceinline__ float max(float v) const { return reduce<1>(v, red); }
  __device__ __forceinline__ float min(float v) const { return reduce<2>(v, red); }
};

using ChainGroup = WarpGroup<0>;

// The group of thread threadIdx.x in a CTA of groups of W warps (W > 0),
// with its partials at red
template <int W>
__device__ __forceinline__ WarpGroup<W> warp_group(float* red) {
  constexpr int T = 32 * W;
  const int g = (int)threadIdx.x / T;
  return WarpGroup<W>((int)threadIdx.x - T * g, T, 1 + g, red);
}

}  // namespace binf
