// Whole-run HMC with one chain per group of warps: the chain-grid kernel (K7).
//
// Replaces binf_tpu/ops/pallas/chain_grid.py::_cg_kernel (chain_grid_hmc_run).
// The TPU kernel puts S chains on each step of a sequential grid and runs a
// traced density at each chain's natural shapes, with the data axis in the
// vector lanes.  Here a group of G warps owns one chain for the whole run
// and a CTA of up to 8 warps holds 8 / G chains, which share one staged
// copy of W, logD and their transposes; the density is a group functor
// (gram_density.cuh) in which a thread owns beads and walks all their
// pairs.  A chain's flat position q (D = sum of the variables' sizes,
// sorted names), the trajectory's end point, momentum, gradients and its
// (x, |x|^2) scratch live in shared memory; all num_steps x L evaluations
// run inside one launch.
//
// Per step, as _cg_kernel.hmc_step: D normals and one uniform from Philox
// (counter: chain, absolute step = step_offset + t, slot, kTagChainGrid; two
// normals a slot) or from staged noise; p = z / sqrt(max(im, 1e-20)); half
// kick, L x (drift, kick), retract half a kick; accept log(max(u, 1e-30)) <
// E0 - E1, with NaN or |E0 - E1| > 1000 rejected; then draws (every thin-th
// step) or Welford moments counted from the call's first step, stored with
// consecutive threads on consecutive coordinates.  U and grad U of the
// current state are carried from step to step (the endpoint's on
// acceptance), so a trajectory costs L evaluations, with the same bits.
// Kinetic energies and the density's sums are warp butterflies and partials
// added in warp order, so two calls, or two chained calls and one, give the
// same bits, whichever CTA a chain lands on.  The order does depend on the
// warps a chain G and on whether the matrices are staged (one staged warp
// takes each unordered pair once, more warps or unstaged matrices walk the
// ordered pairs), and cg_geometry picks both from the chain count, the bead
// count and the card's SM count: a chain's bits are fixed for one chain
// count on one card, not across chain counts that change G.
//
// Bound: operations, counted as the least work: each unordered pair once,
// ~38 float operations and one log (N(N-1)/2 of them).  The previous design
// gave each chain a CTA of 256 threads: a 64-bead chain's matrices (64 KB,
// the same for every chain) held an SM to 3 chains, so 2,048 chains ran in
// 6 rounds, and every evaluation paid CTA barriers, shuffle trees per row
// and a tail on one warp (36% of an evaluation's cycles on an H100;
// PERF.md).  Here the chains of a CTA share the staged matrices and meet no
// CTA barrier after staging: at 2,048 chains and 64 beads a chain is one
// warp, a CTA of 8 chains takes ~100 KB, 2 CTAs an SM, one round.  Fewer
// chains get more warps each (G up to 8, at their own named barrier), so
// 256 chains still fill the card.  Matrices that do not fit shared memory
// (N > ~110 beside the state) are read from device memory, where the 50 MB
// L2 holds them, a warp's 32 lanes reading one line.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"
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

// a chain's shared floats: the functor's scratch, then q, qn, p, g, gq
// and, with moments, mean and m2
__host__ __device__ inline int64_t cg_chain_floats(int D, int n, int moments) {
  return GramDensity::scratch_floats(n) + pad4((int64_t)(moments ? 7 : 5) * D);
}

// a CTA's: the staged matrices, the metric, then its chains'
inline int64_t cg_smem_bytes(int D, int n, int moments, int resident, int chains) {
  return (GramDensity::matrix_floats(n, resident) + pad4(D) +
          chains * cg_chain_floats(D, n, moments)) * (int64_t)sizeof(float);
}

__device__ __forceinline__ float group_kinetic(const float* p, const float* im, int D,
                                               const ChainGroup& grp, float* red) {
  float ke = 0.0f;
  for (int k = grp.r; k < D; k += grp.T) ke += p[k] * p[k] * im[k];
  return grp.sum(ke, red);
}

// The chain's group of a CTA of CPC groups of G warps: rank, size and
// named barrier (1 + the group's index in the CTA; 0 is __syncthreads)
__device__ __forceinline__ ChainGroup chain_group(int G) {
  const int g = (threadIdx.x >> 5) / G;
  return ChainGroup{(int)threadIdx.x - 32 * G * g, 32 * G, 1 + g};
}

template <bool Resident>
__global__ void __launch_bounds__(32 * kCgMaxWarps)
chain_grid_kernel(const GramOperands ops, const CgArgs a, int G) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, n = ops.n;
  const ChainGroup grp = chain_group(G);
  const int cpc = (blockDim.x >> 5) / G, slot = (threadIdx.x >> 5) / G;
  GramDensity dens;
  dens.stage(ops, smem);
  float* im = smem + GramDensity::matrix_floats(n, Resident);
  for (int k = threadIdx.x; k < D; k += blockDim.x) im[k] = a.im[k];
  float* mine = im + pad4(D) + slot * cg_chain_floats(D, n, a.moments);
  float4* X = reinterpret_cast<float4*>(mine);
  float* red = mine + 4 * n;  // the functor's group partials, reused between its calls
  float* q = mine + GramDensity::scratch_floats(n);
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
  float U = dens.value_and_grad<Resident>(q, gq, X, grp);
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
      U1 = dens.value_and_grad<Resident>(qn, g, X, grp);
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
template <bool Resident>
__global__ void __launch_bounds__(32 * kCgMaxWarps)
gram_eval_kernel(const GramOperands ops, const float* qs, int n_pos, int D, float* U,
                 float* grads, int G) {
  extern __shared__ __align__(16) float smem[];
  const int n = ops.n;
  const ChainGroup grp = chain_group(G);
  const int cpc = (blockDim.x >> 5) / G, slot = (threadIdx.x >> 5) / G;
  GramDensity dens;
  dens.stage(ops, smem);
  float* mine = smem + GramDensity::matrix_floats(n, Resident) +
                slot * (GramDensity::scratch_floats(n) + pad4(2 * D));
  float4* X = reinterpret_cast<float4*>(mine);
  float* q = mine + GramDensity::scratch_floats(n);
  float* g = q + D;
  __syncthreads();
  const int b = blockIdx.x * cpc + slot;
  if (b >= n_pos) return;
  for (int k = grp.r; k < D; k += grp.T) q[k] = qs[(int64_t)b * D + k];
  grp.sync();
  const float u = dens.value_and_grad<Resident>(q, g, X, grp);
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
// still fills the card.  Chains a CTA: as many groups as 8 warps hold, at
// most the chains spread over every SM.
struct CgGeometry {
  int G, cpc;
};
inline CgGeometry cg_geometry(int n_items, int sms) {
  int G = (16 * sms) / (n_items > 0 ? n_items : 1);
  G = G < 1 ? 1 : (G >= 8 ? 8 : (G >= 4 ? 4 : (G >= 2 ? 2 : 1)));
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

// Launches launch(ops, geometry, blocks, smem, rounds) over n_items chain
// groups: the matrices staged when a CTA's shared memory (bytes(cpc, ops))
// holds them, else read from device memory.  grid (5 ints) receives CTAs,
// threads a CTA, whether the matrices were resident, the rounds of CTAs the
// card runs, and the warps a chain.
template <class Bytes, class Launch>
cudaError_t cg_launch(GramOperands ops, int n_items, Bytes&& bytes, int* grid,
                      Launch&& launch) {
  const CgGeometry geo = cg_geometry(n_items, cg_sms());
  ops.resident = 1;
  if (bytes(geo.cpc, ops) > kCgSmemLimit) ops.resident = 0;
  const int64_t smem = bytes(geo.cpc, ops);
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

}  // namespace binf

extern "C" int binf_chain_grid_hmc(const binf::GramOperands* ops, const binf::CgArgs* args,
                                   void* stream, int* grid) {
  using namespace binf;
  const CgArgs& a = *args;
  if (a.D != 1 + 3 * ops->n || a.thin <= 0 || a.n_chains <= 0 || a.num_leapfrog < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)cg_launch(
      *ops, a.n_chains,
      [&](int cpc, const GramOperands& o) {
        return cg_smem_bytes(a.D, o.n, a.moments, o.resident, cpc);
      },
      grid, [&](const GramOperands& o, CgGeometry geo, int blocks, size_t smem, int* rounds) {
        const int threads = 32 * geo.G * geo.cpc;
        cudaError_t e;
        if (o.resident) {
          e = cg_prepare(chain_grid_kernel<true>, threads, smem, blocks, rounds);
          if (e != cudaSuccess) return e;
          chain_grid_kernel<true><<<blocks, threads, smem, s>>>(o, a, geo.G);
        } else {
          e = cg_prepare(chain_grid_kernel<false>, threads, smem, blocks, rounds);
          if (e != cudaSuccess) return e;
          chain_grid_kernel<false><<<blocks, threads, smem, s>>>(o, a, geo.G);
        }
        return cudaGetLastError();
      });
}

extern "C" int binf_gram_eval(const binf::GramOperands* ops, const float* qs, int n_pos, int D,
                              float* U, float* grads, void* stream, int* grid) {
  using namespace binf;
  if (D != 1 + 3 * ops->n || n_pos <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)cg_launch(
      *ops, n_pos,
      [&](int cpc, const GramOperands& o) {
        return (GramDensity::matrix_floats(o.n, o.resident) +
                cpc * (GramDensity::scratch_floats(o.n) + pad4(2 * (int64_t)D))) *
               (int64_t)sizeof(float);
      },
      grid, [&](const GramOperands& o, CgGeometry geo, int blocks, size_t smem, int* rounds) {
        const int threads = 32 * geo.G * geo.cpc;
        cudaError_t e;
        if (o.resident) {
          e = cg_prepare(gram_eval_kernel<true>, threads, smem, blocks, rounds);
          if (e != cudaSuccess) return e;
          gram_eval_kernel<true><<<blocks, threads, smem, s>>>(o, qs, n_pos, D, U, grads, geo.G);
        } else {
          e = cg_prepare(gram_eval_kernel<false>, threads, smem, blocks, rounds);
          if (e != cudaSuccess) return e;
          gram_eval_kernel<false><<<blocks, threads, smem, s>>>(o, qs, n_pos, D, U, grads, geo.G);
        }
        return cudaGetLastError();
      });
}
