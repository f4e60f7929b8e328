// The chain-grid kernel (K7) on any density with a group form: a group of G
// warps runs one chain for the whole run, and a CTA of up to 8 warps holds
// 8 / G chains, which share one staged copy of the density's operands.
// chain_grid.cu instantiates it on the Gram chromatin density
// (gram_density.cuh, GramChain); chain_grid_shape.cu on the group form of a
// traced density (the header ops/kernels/density_compiler.py emits,
// TracedChain), past 32 coordinates its wide form, which reads the
// position from the chain's shared q where it uses it.  The arithmetic of a step is chain_grid.cu's (its header
// comment); a density enters it through
//
//   Operands                      what the C entry passes (by value); the
//                                 launch sets its resident flag
//   kStreamedKernel               whether operands that do not fit shared
//                                 memory take a kernel of their own
//                                 (Resident false); else the one kernel
//                                 (Resident true) serves both and the
//                                 density reads ops.resident
//   staged_floats(ops, resident)  floats the CTA stages, at shared offset 0
//   scratch_floats(ops)           a chain's scratch, ending in kGroupPartials
//                                 floats of group partials
//   stage(ops, smem)              every thread of the CTA, then __syncthreads
//   value_and_grad<Resident>(q, g, scratch, grp)
//                                 every thread of the chain's group, q and g
//                                 in shared memory; returns U in every
//                                 thread and ends at the group's barrier
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "gram_density.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kCgMaxWarps = 8;
constexpr int64_t kCgSmemLimit = 232448;  // 227 KB a block

// Filled through ctypes by binf_tpu_torch/ops/kernels/chain_grid.py.
struct CgArgs {
  const float* q0;   // (C, D)
  const float* eps;  // (C,)
  const float* im;   // (D,)
  int n_chains, D, num_steps, num_leapfrog, thin, moments;
  uint32_t step_offset;  // block_offset * steps_per_block
  uint64_t seed;
  const float* mom;   // staged normals (num_steps, C, D), or null
  const float* unif;  // staged uniforms (num_steps, C)
  float* draws;       // (num_steps / thin, C, D), unless moments
  float* mean;        // (C, D), moments only
  float* m2;          // (C, D), moments only
  float* qf;          // (C, D)
  int* accepts;       // (C,)
};

__host__ __device__ inline int64_t pad4(int64_t x) { return (x + 3) & ~(int64_t)3; }

// The Gram chromatin density (gram_density.cuh): the matrices staged when
// resident, a chain's (x, |x|^2) a bead, then the partials.
struct GramChain {
  using Operands = GramOperands;
  static constexpr bool kStreamedKernel = true;
  GramDensity dens;

  static __host__ __device__ int64_t staged_floats(const Operands& o, int resident) {
    return GramDensity::matrix_floats(o.n, resident);
  }
  static __host__ __device__ int64_t scratch_floats(const Operands& o) {
    return GramDensity::scratch_floats(o.n);
  }
  __device__ void stage(const Operands& o, float* smem) { dens.stage(o, smem); }
  template <bool Resident>
  __device__ __forceinline__ float value_and_grad(const float* q, float* g, float* scratch,
                                                  const ChainGroup& grp) const {
    return dens.value_and_grad<Resident>(q, g, reinterpret_cast<float4*>(scratch), grp);
  }
};

// The operands of a traced density (TracedChain): its constant buffer.
struct TracedOperands {
  const float* c;  // (F::kOperandFloats,) device memory
  int resident;    // staged in shared memory (set by the launch)
};

// The group form of a traced functor F (density_compiler.py's
// TracedGroup_<key>): the constants staged once a CTA when they fit beside
// its chains' state, else read from device memory (the functor reads them
// through f.c either way); a chain's scratch is the partials alone.  The
// evaluation is one function, not inlined at its three call sites (K7's
// two and the functor check's), and one kernel serves staged and streamed
// constants (ops.resident, not Resident): a functor of thousands of lines
// (an unrolled recursion) compiles once, not six times.
template <class F>
struct TracedChain {
  using Operands = TracedOperands;
  static constexpr bool kStreamedKernel = false;
  F f;

  static __host__ __device__ int64_t staged_floats(const Operands& o, int) {
    return o.resident ? pad4(F::kOperandFloats) : 0;
  }
  static __host__ __device__ int64_t scratch_floats(const Operands&) { return kGroupPartials; }
  __device__ void stage(const Operands& o, float* smem) {
    f.c = o.c;
    if (o.resident) f.stage(smem);
  }
  template <bool Resident>
  __device__ __noinline__ float value_and_grad(const float* q, float* g, float* scratch,
                                               const ChainGroup& grp) const {
    return f.value_and_grad(q, g, ChainGroup(grp.r, grp.T, grp.id, scratch));
  }
};

// a chain's shared floats: the density's scratch, then q, qn, p, g, gq
// and, with moments, mean and m2
template <class Dens>
__host__ __device__ inline int64_t cg_chain_floats(const typename Dens::Operands& ops, int D,
                                                   int moments) {
  return Dens::scratch_floats(ops) + pad4((int64_t)(moments ? 7 : 5) * D);
}

// a CTA's: the staged operands, the metric, then its chains'
template <class Dens>
inline int64_t cg_smem_bytes(const typename Dens::Operands& ops, int D, int moments,
                             int chains) {
  return (Dens::staged_floats(ops, ops.resident) + pad4(D) +
          chains * cg_chain_floats<Dens>(ops, D, moments)) * (int64_t)sizeof(float);
}

__device__ __forceinline__ float group_kinetic(const float* p, const float* im, int D,
                                               const ChainGroup& grp, float* red) {
  float ke = 0.0f;
  for (int k = grp.r; k < D; k += grp.T) ke += p[k] * p[k] * im[k];
  return grp.sum(ke, red);
}

// The chain's group of a CTA of CPC groups of G warps: rank, size and
// named barrier (1 + the group's index in the CTA; 0 is __syncthreads);
// the kernels pass each sum its partials
__device__ __forceinline__ ChainGroup chain_group(int G) {
  const int g = (threadIdx.x >> 5) / G;
  return ChainGroup((int)threadIdx.x - 32 * G * g, 32 * G, 1 + g, nullptr);
}

template <class Dens, bool Resident>
__global__ void __launch_bounds__(32 * kCgMaxWarps)
chain_grid_kernel(const typename Dens::Operands ops, const CgArgs a, int G) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const ChainGroup grp = chain_group(G);
  const int cpc = (blockDim.x >> 5) / G, slot = (threadIdx.x >> 5) / G;
  Dens dens;
  dens.stage(ops, smem);
  float* im = smem + Dens::staged_floats(ops, Resident);
  for (int k = threadIdx.x; k < D; k += blockDim.x) im[k] = a.im[k];
  float* mine = im + pad4(D) + slot * cg_chain_floats<Dens>(ops, D, a.moments);
  float* q = mine + Dens::scratch_floats(ops);
  float* red = q - kGroupPartials;  // the group's partials, reused between its sums
  float* qn = q + D;
  float* p = qn + D;
  float* g = p + D;
  float* gq = g + D;
  float* mean = gq + D;
  float* m2 = mean + D;
  __syncthreads();
  const int c = blockIdx.x * cpc + slot;
  if (c >= a.n_chains) return;  // a whole group; no CTA barrier follows
  for (int k = grp.r; k < D; k += grp.T) {
    q[k] = a.q0[(int64_t)c * D + k];
    if (a.moments) {
      mean[k] = 0.0f;
      m2[k] = 0.0f;
    }
  }
  grp.sync();
  const float eps = a.eps[c], half_eps = 0.5f * eps;
  const uint32_t k0 = (uint32_t)a.seed, k1 = (uint32_t)(a.seed >> 32);
  const int slots = (D + 1) / 2;
  float U = dens.template value_and_grad<Resident>(q, gq, mine, grp);
  int n_acc = 0;
  for (int t = 0; t < a.num_steps; ++t) {
    float u_mh;
    if (a.mom != nullptr) {
      const float* z = a.mom + ((int64_t)t * a.n_chains + c) * D;
      for (int k = grp.r; k < D; k += grp.T) p[k] = z[k];
      u_mh = a.unif[(int64_t)t * a.n_chains + c];
    } else {
      const uint32_t step = a.step_offset + (uint32_t)t;
      for (int s = grp.r; s < slots; s += grp.T) {
        const Philox4 b =
            philox4x32_10(Philox4{(uint32_t)c, step, (uint32_t)s, kTagChainGrid}, k0, k1);
        p[2 * s] = bits_to_normal(b.x, b.y);
        if (2 * s + 1 < D) p[2 * s + 1] = bits_to_normal(b.z, b.w);
      }
      // the uniform on the thread after the last slot's, to every thread
      float u = 0.0f;
      if (grp.r == slots % grp.T) {
        const Philox4 b =
            philox4x32_10(Philox4{(uint32_t)c, step, kUniformSlot, kTagChainGrid}, k0, k1);
        u = bits_to_uniform(b.x);
      }
      u_mh = grp.sum(u, red);
    }
    grp.sync();
    for (int k = grp.r; k < D; k += grp.T) p[k] = p[k] / sqrtf(fmaxf(im[k], 1e-20f));
    const float E0 = U + 0.5f * group_kinetic(p, im, D, grp, red);
    for (int k = grp.r; k < D; k += grp.T) {
      p[k] = p[k] - half_eps * gq[k];
      qn[k] = q[k];
    }
    float U1 = U;
    const float* gl = gq;  // the gradient at the trajectory's end point
    for (int l = 0; l < a.num_leapfrog; ++l) {
      for (int k = grp.r; k < D; k += grp.T) qn[k] = qn[k] + eps * p[k] * im[k];
      grp.sync();
      U1 = dens.template value_and_grad<Resident>(qn, g, mine, grp);
      gl = g;
      for (int k = grp.r; k < D; k += grp.T) p[k] = p[k] - eps * g[k];
    }
    for (int k = grp.r; k < D; k += grp.T) p[k] = p[k] + half_eps * gl[k];
    float dE = E0 - (U1 + 0.5f * group_kinetic(p, im, D, grp, red));
    if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
    const bool accept = logf(fmaxf(u_mh, 1e-30f)) < dE;
    n_acc += accept;
    if (accept) {
      for (int k = grp.r; k < D; k += grp.T) {
        q[k] = qn[k];
        gq[k] = gl[k];
      }
      U = U1;
    }
    if (a.moments) {
      const float cnt = (float)(t + 1);
      for (int k = grp.r; k < D; k += grp.T) {
        const float delta = q[k] - mean[k];
        mean[k] = mean[k] + delta / cnt;
        m2[k] = m2[k] + delta * (q[k] - mean[k]);
      }
    } else if (t % a.thin == a.thin - 1) {
      float* out = a.draws + ((int64_t)(t / a.thin) * a.n_chains + c) * D;
      for (int k = grp.r; k < D; k += grp.T) out[k] = q[k];
    }
    grp.sync();
  }
  for (int k = grp.r; k < D; k += grp.T) {
    a.qf[(int64_t)c * D + k] = q[k];
    if (a.moments) {
      a.mean[(int64_t)c * D + k] = mean[k];
      a.m2[(int64_t)c * D + k] = m2[k];
    }
  }
  if (grp.r == 0) a.accepts[c] = n_acc;
}

// The functor alone: (U, grad U) of each of B positions, one group each.
template <class Dens, bool Resident>
__global__ void __launch_bounds__(32 * kCgMaxWarps)
group_eval_kernel(const typename Dens::Operands ops, const float* qs, int n_pos, int D,
                  float* U, float* grads, int G) {
  extern __shared__ __align__(16) float smem[];
  const ChainGroup grp = chain_group(G);
  const int cpc = (blockDim.x >> 5) / G, slot = (threadIdx.x >> 5) / G;
  Dens dens;
  dens.stage(ops, smem);
  float* mine = smem + Dens::staged_floats(ops, Resident) +
                slot * (Dens::scratch_floats(ops) + pad4(2 * D));
  float* q = mine + Dens::scratch_floats(ops);
  float* g = q + D;
  __syncthreads();
  const int b = blockIdx.x * cpc + slot;
  if (b >= n_pos) return;
  for (int k = grp.r; k < D; k += grp.T) q[k] = qs[(int64_t)b * D + k];
  grp.sync();
  const float u = dens.template value_and_grad<Resident>(q, g, mine, grp);
  for (int k = grp.r; k < D; k += grp.T) grads[(int64_t)b * D + k] = g[k];
  if (grp.r == 0) U[b] = u;
}

inline int cg_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Warps a chain, G: one while the chains fill 16 warps an SM (the card's
// schedulers 4 deep), more, up to 8, for fewer chains, so that a small run
// still fills the card; but no more than the density's rows (the largest
// loop its functor strides over the group; 0 for none) can use, and
// ``warps`` if it is given.  Chains a CTA: as many groups as 8 warps hold,
// at most the chains spread over every SM.
struct CgGeometry {
  int G, cpc;
};
inline bool cg_warps_valid(int warps) {
  return warps == 0 || warps == 1 || warps == 2 || warps == 4 || warps == 8;
}
inline CgGeometry cg_geometry(int n_items, int sms, int rows = INT_MAX, int warps = 0) {
  int G = (16 * sms) / (n_items > 0 ? n_items : 1);
  G = G < 1 ? 1 : (G >= 8 ? 8 : (G >= 4 ? 4 : (G >= 2 ? 2 : 1)));
  while (G > 1 && 32 * (G / 2) >= rows) G /= 2;
  if (warps > 0) G = warps;
  int cpc = (n_items + sms - 1) / sms;
  const int most = kCgMaxWarps / G;
  cpc = cpc < 1 ? 1 : (cpc > most ? most : cpc);
  return CgGeometry{G, cpc};
}

template <class K>
cudaError_t cg_prepare(K kernel, int threads, size_t smem, int blocks, int* rounds) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int sms = cg_sms();
  *rounds = (blocks + per_sm * sms - 1) / (per_sm * sms);
  return cudaSuccess;
}

// Launches launch(ops, geo, blocks, smem, rounds) over n_items chain groups
// of geometry geo: the operands staged when a CTA's shared memory
// (bytes(ops, cpc)) holds them beside its chains, else read from device
// memory; where the chains alone pass it (a wide position), fewer chains a
// CTA, the operands staged if they fit beside those.  grid (5 ints)
// receives CTAs, threads a CTA, whether the operands were resident, the
// rounds of CTAs the card runs, and the warps a chain.
template <class Ops, class Bytes, class Launch>
cudaError_t cg_launch(Ops ops, int n_items, CgGeometry geo, Bytes&& bytes, int* grid,
                      Launch&& launch) {
  ops.resident = 1;
  if (bytes(ops, geo.cpc) > kCgSmemLimit) ops.resident = 0;
  if (bytes(ops, geo.cpc) > kCgSmemLimit) {
    ops.resident = 1;
    while (geo.cpc > 1 && bytes(ops, geo.cpc) > kCgSmemLimit) --geo.cpc;
    if (bytes(ops, geo.cpc) > kCgSmemLimit) ops.resident = 0;
  }
  const int64_t smem = bytes(ops, geo.cpc);
  if (smem > kCgSmemLimit) return cudaErrorInvalidValue;
  const int blocks = (n_items + geo.cpc - 1) / geo.cpc;
  int rounds = 0;
  const cudaError_t err = launch(ops, geo, blocks, (size_t)smem, &rounds);
  if (err != cudaSuccess) return err;
  grid[0] = blocks;
  grid[1] = 32 * geo.G * geo.cpc;
  grid[2] = ops.resident;
  grid[3] = rounds;
  grid[4] = geo.G;
  return cudaSuccess;
}

// The whole run of CgArgs on density Dens.
template <class Dens>
cudaError_t cg_run(const typename Dens::Operands& ops, const CgArgs& a, CgGeometry geo,
                   cudaStream_t s, int* grid) {
  using Ops = typename Dens::Operands;
  return cg_launch(
      ops, a.n_chains, geo,
      [&](const Ops& o, int cpc) { return cg_smem_bytes<Dens>(o, a.D, a.moments, cpc); }, grid,
      [&](const Ops& o, CgGeometry geo, int blocks, size_t smem, int* rounds) {
        const int threads = 32 * geo.G * geo.cpc;
        cudaError_t e;
        if constexpr (Dens::kStreamedKernel) {
          if (!o.resident) {
            e = cg_prepare(chain_grid_kernel<Dens, false>, threads, smem, blocks, rounds);
            if (e != cudaSuccess) return e;
            chain_grid_kernel<Dens, false><<<blocks, threads, smem, s>>>(o, a, geo.G);
            return cudaGetLastError();
          }
        }
        e = cg_prepare(chain_grid_kernel<Dens, true>, threads, smem, blocks, rounds);
        if (e != cudaSuccess) return e;
        chain_grid_kernel<Dens, true><<<blocks, threads, smem, s>>>(o, a, geo.G);
        return cudaGetLastError();
      });
}

// The functor alone at n_pos positions qs (n_pos, D).
template <class Dens>
cudaError_t cg_eval(const typename Dens::Operands& ops, const float* qs, int n_pos, int D,
                    float* U, float* grads, CgGeometry geo, cudaStream_t s, int* grid) {
  using Ops = typename Dens::Operands;
  return cg_launch(
      ops, n_pos, geo,
      [&](const Ops& o, int cpc) {
        return (Dens::staged_floats(o, o.resident) +
                cpc * (Dens::scratch_floats(o) + pad4(2 * (int64_t)D))) *
               (int64_t)sizeof(float);
      },
      grid, [&](const Ops& o, CgGeometry geo, int blocks, size_t smem, int* rounds) {
        const int threads = 32 * geo.G * geo.cpc;
        cudaError_t e;
        if constexpr (Dens::kStreamedKernel) {
          if (!o.resident) {
            e = cg_prepare(group_eval_kernel<Dens, false>, threads, smem, blocks, rounds);
            if (e != cudaSuccess) return e;
            group_eval_kernel<Dens, false><<<blocks, threads, smem, s>>>(o, qs, n_pos, D, U,
                                                                         grads, geo.G);
            return cudaGetLastError();
          }
        }
        e = cg_prepare(group_eval_kernel<Dens, true>, threads, smem, blocks, rounds);
        if (e != cudaSuccess) return e;
        group_eval_kernel<Dens, true><<<blocks, threads, smem, s>>>(o, qs, n_pos, D, U, grads,
                                                                    geo.G);
        return cudaGetLastError();
      });
}

}  // namespace binf
