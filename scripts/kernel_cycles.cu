// Cycle probes of the evaluations inside the whole-run kernels K2, K4, K5
// and K7, for scripts/kernel_cycles.py (built there with nvcc, loaded with
// ctypes).  Each probe runs a loop of evaluations in which every
// evaluation depends on the one before (the position takes a tiny step
// along the gradient), between two clock64() reads, so cycles / reps is
// the critical path of one evaluation and its update.  A launch of one
// warp shows that path alone; a launch at full width shows what the card's
// schedulers make of it with every chain resident.  Every probe calls a
// functor the kernels run:
//
// - one thread a chain, the rows read from shared memory in a loop over a
//   run-time n (linreg_density.cuh's LinregDensity::value_and_grad, the
//   evaluation of K2's previous design and of K3/K4 at G = 1);
// - K4's lane functor at G = 2 (lanes.cuh);
// - K2's register form (fused_hmc.cu's RegLinreg): the rows unrolled at a
//   compile-time n, V and y in registers;
// - (one step's Philox noise is probed by the philox unit itself:
//   csrc/philox.cu::philox_step_cycles_kernel, in the kernels' form and the
//   previous logf/cosf/sqrtf one);
// - K5's sweep phases (fused_gibbs_kernel.cuh, lanes.cuh::GroupGibbsNoise)
//   on lane groups of 4 and 8;
// - K7's functor (gram_density.cuh) with one warp a chain, the warps of a
//   CTA sharing the staged matrices.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"
#include "fused_gibbs_kernel.cuh"
#include "fused_hmc.cu"
#include "gram_density.cuh"
#include "lanes.cuh"
#include "linreg_density.cuh"
#include "philox.cuh"

namespace probe {
using binf::LinregDensity;

constexpr int kD = 5;  // polynomial regression: 4 coefficients and log precision

__device__ __forceinline__ void nudge(float (&q)[kD], const float (&g)[kD]) {
#pragma unroll
  for (int k = 0; k < kD; ++k) q[k] = fmaf(-1e-7f, g[k], q[k]);
}

// one thread a chain, rows from shared memory
__global__ void k2_shared_rows_eval(LinregDensity<4> dens, const float* q0, int n_chains, int reps,
                            float* sink, long long* cycles) {
  extern __shared__ float smem[];
  dens.stage(smem);
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  float q[kD], g[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) q[k] = q0[(int64_t)c * kD + k];
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    acc += dens.value_and_grad(q, g);
    nudge(q, g);
  }
  const long long t1 = clock64();
  sink[c] = acc + q[0] + q[4];
  cycles[c] = t1 - t0;
}

// K4's lane functor, G lanes a chain
template <int G>
__global__ void lanes_eval(LinregDensity<4> dens, const float* q0, int n_chains, int reps,
                           float* sink, long long* cycles) {
  extern __shared__ float smem[];
  dens.stage(smem);
  __syncthreads();
  const int c = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= n_chains) return;
  const binf::Lanes<LinregDensity<4>, G> lanes(dens);
  float q[kD], g[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) q[k] = q0[(int64_t)c * kD + k];
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    acc += lanes.value_and_grad(q, g);
    nudge(q, g);
  }
  const long long t1 = clock64();
  if ((threadIdx.x & (G - 1)) == 0) {
    sink[c] = acc + q[0] + q[4];
    cycles[c] = t1 - t0;
  }
}

__global__ void reg_eval(LinregDensity<4> dens, const float* q0, int n_chains, int reps,
                         float* sink, long long* cycles) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  const binf::RegLinreg<4, 20> rows(dens);
  float q[kD], g[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) q[k] = q0[(int64_t)c * kD + k];
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    acc += rows.value_and_grad(q, g);
    nudge(q, g);
  }
  const long long t1 = clock64();
  sink[c] = acc + q[0] + q[4];
  cycles[c] = t1 - t0;
}

// K7's warp functor: reps evaluations of one chain a warp
template <bool Resident>
__global__ void __launch_bounds__(256)
k7_warp_eval(binf::GramOperands op, const float* q0, int n_chains, int reps, float* sink,
             long long* cycles) {
  extern __shared__ __align__(16) float smem[];
  const int n = op.n, D = 1 + 3 * n, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int scratch = (int)binf::GramDensity::scratch_floats(n);
  const int per_chain = scratch + ((2 * D + 3) & ~3);
  const binf::ChainGroup grp{lane, 32, 1 + warp};
  binf::GramDensity dens;
  dens.stage(op, smem);
  float* mine = smem + binf::GramDensity::matrix_floats(n, Resident) + warp * per_chain;
  float4* X = reinterpret_cast<float4*>(mine);
  float* q = mine + scratch;
  float* g = q + D;
  __syncthreads();
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= n_chains) return;
  for (int k = lane; k < D; k += 32) q[k] = q0[(int64_t)c * D + k];
  __syncwarp();
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    acc += dens.value_and_grad<Resident>(q, g, X, grp);
    for (int k = lane; k < D; k += 32) q[k] = fmaf(-1e-9f, g[k], q[k]);
    __syncwarp();
  }
  const long long t1 = clock64();
  if (lane == 0) {
    sink[c] = acc + q[1];
    cycles[c] = t1 - t0;
  }
}

// K5's sweep phases apart (fused_gibbs_kernel.cuh), each in a loop of
// dependent repetitions on a group of G lanes a chain: 0 a sweep's noise
// (GroupGibbsNoise), 1 the residual sum of squares (GibbsRows), 2 the
// Gamma draw (round 0, later rounds when it rejects), 3 the Cholesky
// factor and solves, 4 the draw store.
template <int Which, int G>
__global__ void __launch_bounds__(binf::kK5Threads)
k5_phase(binf::GibbsArgs a, int reps, float* sink, long long* cycles) {
  constexpr int DC = 4, D = 5;
  extern __shared__ float smem[];
  float* sV = smem;
  float* sy = sV + a.n * DC;
  float* svtv = sy + a.n;
  float* svty = svtv + DC * DC;
  float* sipv = svty + DC;
  float* spm = sipv + DC;
  for (int i = threadIdx.x; i < a.n * DC; i += blockDim.x) sV[i] = a.V[i];
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) sy[i] = a.y[i];
  for (int i = threadIdx.x; i < DC * DC; i += blockDim.x) svtv[i] = a.vtv[i];
  for (int i = threadIdx.x; i < DC; i += blockDim.x) {
    svty[i] = a.vty[i];
    sipv[i] = a.ipv[i];
    spm[i] = a.pm[i];
  }
  __syncthreads();
  const int c = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= a.n_chains) return;
  const int lane = (int)(threadIdx.x & (G - 1));
  const unsigned mask = binf::group_mask<G>();
  const binf::GibbsRows<DC, G> rows(sV, sy, a.n, lane);
  binf::GroupGibbsNoise<DC, G> noise(a, c, mask);
  binf::SweepNoise<DC> sn;
  float coef[DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) coef[k] = a.q0[(int64_t)c * D + k];
  noise.draw(a.seed, 0u);
  noise.values(sn);
  float acc = 0.0f, lam = 2.5f, x = sn.gz0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    if (Which == 0) {
      noise.chain = (uint32_t)c + (acc > 1e30f);
      noise.draw(a.seed, (uint32_t)r);
      noise.values(sn);
      acc += sn.gz0 + sn.gu0 + sn.cz[0] + sn.cz[1] + sn.cz[2] + sn.cz[3];
    } else if (Which == 1) {
      const float ss = rows.ss(coef, mask);
      coef[0] = fmaf(1e-9f, ss, coef[0]);
      acc += ss;
    } else if (Which == 2) {
      float g;
      if (!binf::gamma_round(a.gamma_d, a.gamma_c, x, sn.gu0, g))
        g = binf::later_rounds(noise, a.seed, a.gamma_d, a.gamma_c);
      x = fmaf(1e-9f, g, x);
      acc += g;
    } else if (Which == 3) {
      binf::coefficient_draw<DC>(lam, svtv, svty, sipv, spm, sn.cz, coef);
      lam = fmaf(1e-9f, coef[0], 2.5f);
      acc += coef[1];
    } else {
      coef[0] += 1.0f;
      binf::store_draw<DC, G>(a.draws + ((int64_t)r * a.n_chains + c) * D, lane, coef, lam);
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    sink[c] = acc + coef[0];
    cycles[c] = t1 - t0;
  }
}

template <class K>
cudaError_t launch_probe(K kernel, int blocks, int threads, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace probe

// which: 0 one thread a chain, rows from shared memory, 1 lanes G = 2, 2 the
// register form.  V (n, 4) etc. on the card.
extern "C" int probe_linreg(int which, const float* V, const float* y, const float* ipv,
                            const float* pm, int n, float hna, float rate, const float* q0,
                            int n_chains, int threads, int reps, float* sink,
                            long long* cycles, void* stream) {
  using namespace probe;
  cudaStream_t s = (cudaStream_t)stream;
  LinregDensity<4> dens{V, y, ipv, pm, n, hna, rate};
  const size_t smem = LinregDensity<4>::smem_floats(n) * sizeof(float);
  const int per_chain = which == 1 ? 2 : 1;
  const int blocks = (n_chains * per_chain + threads - 1) / threads;
  switch (which) {
    case 0:
      k2_shared_rows_eval<<<blocks, threads, smem, s>>>(dens, q0, n_chains, reps, sink, cycles);
      break;
    case 1:
      lanes_eval<2><<<blocks, threads, smem, s>>>(dens, q0, n_chains, reps, sink, cycles);
      break;
    case 2:
      if (n != 20) return cudaErrorInvalidValue;
      reg_eval<<<blocks, threads, 0, s>>>(dens, q0, n_chains, reps, sink, cycles);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// n_chains chains, warps of them a CTA; the matrices staged when they fit
// (*resident receives which)
extern "C" int probe_k7_warp(const float* W, const float* logD, const float* Wt,
                             const float* logDt, int n, const float* q0, int n_chains, int warps,
                             int reps, float* sink, long long* cycles, int* resident,
                             void* stream) {
  using namespace probe;
  cudaStream_t s = (cudaStream_t)stream;
  binf::GramOperands op{W, logD, Wt, logDt, n, 1, 605.0f, 1.0f, 0.1f, 1.0f, 10.0f, 0.1f};
  const int D = 1 + 3 * n;
  const size_t chain =
      (binf::GramDensity::scratch_floats(n) + ((2 * D + 3) & ~3)) * sizeof(float);
  size_t smem = 16 * (size_t)n * n + warps * chain;
  if (smem > 232448) {
    op.resident = 0;
    smem = warps * chain;
  }
  *resident = op.resident;
  const int blocks = (n_chains + warps - 1) / warps;
  cudaError_t e;
  if (op.resident) {
    e = launch_probe(k7_warp_eval<true>, blocks, 32 * warps, smem, s);
    if (e != cudaSuccess) return (int)e;
    k7_warp_eval<true><<<blocks, 32 * warps, smem, s>>>(op, q0, n_chains, reps, sink, cycles);
  } else {
    e = launch_probe(k7_warp_eval<false>, blocks, 32 * warps, smem, s);
    if (e != cudaSuccess) return (int)e;
    k7_warp_eval<false><<<blocks, 32 * warps, smem, s>>>(op, q0, n_chains, reps, sink, cycles);
  }
  return (int)cudaGetLastError();
}

// K5's sweep phases (which 0-4, k5_phase) at d = 4 on groups of G = 4 or
// 8 lanes; a.draws holds (reps, C, 5) floats for the store phase
extern "C" int probe_k5_phase(int which, int G, const float* V, const float* y,
                              const float* vtv, const float* vty, const float* ipv,
                              const float* pm, int n, float gamma_d, float gamma_c, float rate,
                              const float* q0, int n_chains, int reps, float* sink,
                              long long* cycles, float* out, void* stream) {
  using namespace probe;
  cudaStream_t s = (cudaStream_t)stream;
  const binf::GibbsArgs a{V,  y,  vtv,      vty,  ipv,     pm,      n,       gamma_d, gamma_c,
                          rate, q0, n_chains, reps, 0x1234, nullptr, nullptr, nullptr, out};
  const size_t smem = binf::gibbs_smem_floats(n, 4) * sizeof(float);
  const int blocks = (int)(((int64_t)n_chains * G + binf::kK5Threads - 1) / binf::kK5Threads);
#define BINF_K5_PHASE(W, GG)                                                            \
  if (which == W && G == GG)                                                            \
    k5_phase<W, GG><<<blocks, binf::kK5Threads, smem, s>>>(a, reps, sink, cycles); \
  else
#define BINF_K5_PHASES(GG) \
  BINF_K5_PHASE(0, GG) BINF_K5_PHASE(1, GG) BINF_K5_PHASE(2, GG) BINF_K5_PHASE(3, GG) BINF_K5_PHASE(4, GG)
  BINF_K5_PHASES(4) BINF_K5_PHASES(8) return cudaErrorInvalidValue;
#undef BINF_K5_PHASES
#undef BINF_K5_PHASE
  return (int)cudaGetLastError();
}
