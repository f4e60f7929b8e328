// Whole-run HMC with one chain per CTA: the chain-grid kernel (K7).
//
// Replaces binf_tpu/ops/pallas/chain_grid.py::_cg_kernel (chain_grid_hmc_run).
// The TPU kernel puts S chains on each step of a sequential grid and runs a
// traced density at each chain's natural shapes, with the data axis in the
// vector lanes.  Here each CTA of 256 threads owns one chain for the whole
// run: its flat position q (D = sum of the variables' sizes, sorted names),
// the trajectory's end point, momentum, gradient and the shared inverse mass
// live in shared memory, and the density is a CTA-cooperative functor
// (gram_density.cuh) that spreads the O(N^2) pair field over the threads.
// All num_steps x (L + 1) evaluations run inside one launch.
//
// Per step, as _cg_kernel.hmc_step: D normals and one uniform from Philox
// (counter: chain, absolute step = step_offset + t, slot, kTagChainGrid; two
// normals a slot) or from staged noise; p = z / sqrt(max(im, 1e-20)); half
// kick, L x (drift, kick), retract half a kick; accept log(max(u, 1e-30)) <
// E0 - E1, with NaN or |E0 - E1| > 1000 rejected; then draws (every thin-th
// step) or Welford moments counted from the call's first step, stored with
// consecutive threads on consecutive coordinates.  Kinetic energies and the
// density's sums are reduced in a fixed order, so two calls, or two chained
// calls and one, give the same bits.
//
// Bound: operations.  An evaluation is ~40 float operations and one log per
// ordered pair (N^2 of them); W, logD and their transposes (16 N^2 bytes)
// sit in shared memory while they fit (N <= ~110 beside the state) and are
// read from device memory, where the 50 MB L2 holds them, otherwise.  One
// CTA per chain keeps a chain's state on one SM for the whole run, at the
// price of a __syncthreads() between the phases of every evaluation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"
#include "gram_density.cuh"
#include "hmc.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kCgThreads = 32 * kGramWarps;
// block_sum scratch, then the accept uniform
constexpr int kCgRed = 33;

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

inline int64_t cg_shared_floats(int D, int n, int moments, int resident) {
  return (int64_t)(moments ? 7 : 5) * D + kCgRed + GramDensity::shared_floats(n, resident);
}

__device__ __forceinline__ float cg_kinetic(const float* p, const float* im, int D,
                                            float* red) {
  float ke = 0.0f;
  for (int k = threadIdx.x; k < D; k += blockDim.x) ke += p[k] * p[k] * im[k];
  block_sum<1>(&ke, red);
  return ke;
}

__global__ void __launch_bounds__(kCgThreads)
chain_grid_kernel(const GramOperands ops, const CgArgs a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, D = a.D, tid = threadIdx.x;
  float* q = smem;
  float* qn = q + D;
  float* p = qn + D;
  float* g = p + D;
  float* im = g + D;
  float* mean = im + D;
  float* m2 = mean + D;
  float* red = smem + (a.moments ? 7 : 5) * D;
  GramDensity dens;
  dens.stage(ops, red + kCgRed);
  for (int k = tid; k < D; k += blockDim.x) {
    q[k] = a.q0[(int64_t)c * D + k];
    im[k] = a.im[k];
    if (a.moments) {
      mean[k] = 0.0f;
      m2[k] = 0.0f;
    }
  }
  __syncthreads();
  const float eps = a.eps[c];
  const uint32_t k0 = (uint32_t)a.seed, k1 = (uint32_t)(a.seed >> 32);
  int n_acc = 0;
  for (int t = 0; t < a.num_steps; ++t) {
    if (a.mom != nullptr) {
      const float* z = a.mom + ((int64_t)t * a.n_chains + c) * D;
      for (int k = tid; k < D; k += blockDim.x) p[k] = z[k];
      if (tid == 0) red[32] = a.unif[(int64_t)t * a.n_chains + c];
    } else {
      const uint32_t step = a.step_offset + (uint32_t)t;
      for (int s = tid; s < (D + 1) / 2; s += blockDim.x) {
        const Philox4 b =
            philox4x32_10(Philox4{(uint32_t)c, step, (uint32_t)s, kTagChainGrid}, k0, k1);
        p[2 * s] = bits_to_normal(b.x, b.y);
        if (2 * s + 1 < D) p[2 * s + 1] = bits_to_normal(b.z, b.w);
      }
      if (tid == 0) {
        const Philox4 b =
            philox4x32_10(Philox4{(uint32_t)c, step, kUniformSlot, kTagChainGrid}, k0, k1);
        red[32] = bits_to_uniform(b.x);
      }
    }
    __syncthreads();
    const float u_mh = red[32];
    for (int k = tid; k < D; k += blockDim.x) p[k] = p[k] / sqrtf(fmaxf(im[k], 1e-20f));
    const float ke0 = cg_kinetic(p, im, D, red);
    const float U0 = dens.value_and_grad(q, g);
    const float E0 = U0 + 0.5f * ke0;
    const float half_eps = 0.5f * eps;
    for (int k = tid; k < D; k += blockDim.x) {
      p[k] = p[k] - half_eps * g[k];
      qn[k] = q[k];
    }
    float U1 = U0;
    for (int l = 0; l < a.num_leapfrog; ++l) {
      for (int k = tid; k < D; k += blockDim.x) qn[k] = qn[k] + eps * p[k] * im[k];
      __syncthreads();
      U1 = dens.value_and_grad(qn, g);
      for (int k = tid; k < D; k += blockDim.x) p[k] = p[k] - eps * g[k];
    }
    for (int k = tid; k < D; k += blockDim.x) p[k] = p[k] + half_eps * g[k];
    const float ke1 = cg_kinetic(p, im, D, red);
    float dE = E0 - (U1 + 0.5f * ke1);
    if (isnan(dE) || fabsf(dE) > 1000.0f) dE = -INFINITY;
    const bool accept = logf(fmaxf(u_mh, 1e-30f)) < dE;
    n_acc += accept;
    if (accept)
      for (int k = tid; k < D; k += blockDim.x) q[k] = qn[k];
    if (a.moments) {
      const float cnt = (float)(t + 1);
      for (int k = tid; k < D; k += blockDim.x) {
        const float delta = q[k] - mean[k];
        mean[k] = mean[k] + delta / cnt;
        m2[k] = m2[k] + delta * (q[k] - mean[k]);
      }
    } else if (t % a.thin == a.thin - 1) {
      float* out = a.draws + ((int64_t)(t / a.thin) * a.n_chains + c) * D;
      for (int k = tid; k < D; k += blockDim.x) out[k] = q[k];
    }
    __syncthreads();
  }
  for (int k = tid; k < D; k += blockDim.x) {
    a.qf[(int64_t)c * D + k] = q[k];
    if (a.moments) {
      a.mean[(int64_t)c * D + k] = mean[k];
      a.m2[(int64_t)c * D + k] = m2[k];
    }
  }
  if (tid == 0) a.accepts[c] = n_acc;
}

// The functor alone: (U, grad U) of each of B positions, one CTA each.
__global__ void __launch_bounds__(kCgThreads)
gram_eval_kernel(const GramOperands ops, const float* qs, int D, float* U, float* grads) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* q = smem;
  float* g = q + D;
  GramDensity dens;
  dens.stage(ops, g + D);
  for (int k = threadIdx.x; k < D; k += blockDim.x) q[k] = qs[(int64_t)b * D + k];
  __syncthreads();
  const float u = dens.value_and_grad(q, g);
  for (int k = threadIdx.x; k < D; k += blockDim.x) grads[(int64_t)b * D + k] = g[k];
  if (threadIdx.x == 0) U[b] = u;
}

inline cudaError_t set_smem(const void* kernel, int64_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

}  // namespace binf

// Dynamic shared memory a launch takes, for the wrapper's checks.
extern "C" int64_t binf_chain_grid_smem_bytes(int D, int n, int moments, int resident) {
  return binf::cg_shared_floats(D, n, moments, resident) * (int64_t)sizeof(float);
}

extern "C" int64_t binf_gram_eval_smem_bytes(int D, int n, int resident) {
  return (2 * (int64_t)D + binf::GramDensity::shared_floats(n, resident)) *
         (int64_t)sizeof(float);
}

extern "C" int binf_chain_grid_hmc(const binf::GramOperands* ops, const binf::CgArgs* args,
                                   void* stream) {
  const binf::CgArgs& a = *args;
  if (a.D != 1 + 3 * ops->n || a.thin <= 0 || a.n_chains <= 0) return cudaErrorInvalidValue;
  const int64_t bytes = binf_chain_grid_smem_bytes(a.D, ops->n, a.moments, ops->resident);
  cudaError_t err = binf::set_smem((const void*)binf::chain_grid_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  binf::chain_grid_kernel<<<a.n_chains, binf::kCgThreads, (size_t)bytes,
                            (cudaStream_t)stream>>>(*ops, a);
  return (int)cudaGetLastError();
}

extern "C" int binf_gram_eval(const binf::GramOperands* ops, const float* qs, int n_pos, int D,
                              float* U, float* grads, void* stream) {
  if (D != 1 + 3 * ops->n || n_pos <= 0) return cudaErrorInvalidValue;
  const int64_t bytes = binf_gram_eval_smem_bytes(D, ops->n, ops->resident);
  cudaError_t err = binf::set_smem((const void*)binf::gram_eval_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  binf::gram_eval_kernel<<<n_pos, binf::kCgThreads, (size_t)bytes, (cudaStream_t)stream>>>(
      *ops, qs, D, U, grads);
  return (int)cudaGetLastError();
}
