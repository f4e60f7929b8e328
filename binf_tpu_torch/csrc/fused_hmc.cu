// Whole-run fixed-L HMC on the linear-regression posterior, one kernel (K2).
//
// Replaces binf_tpu/ops/pallas/fused_hmc.py::_kernel (fused_linreg_hmc_run).
// The TPU kernel holds a (8, BC) tile of chains in VMEM and walks a
// sequential grid axis of step blocks; here one thread owns one chain for
// the whole run and loops over all num_steps itself.
//
// What bounds it: the latency of one chain's step, not the card's
// arithmetic rate.  16,384 chains are 512 warps, one for each of the
// card's 528 schedulers, and a chain's 4,000 x 10 evaluations run one
// after another.  Measured on an H100 (PERF.md; scripts/kernel_cycles.py
// probes the evaluations and the noise), an evaluation with its update
// took 960 cycles with the rows read from shared memory in a loop over a
// run-time n, against ~320 with the rows unrolled at a compile-time n and
// held in registers, and one step's Philox noise (four calls, five
// Box-Muller normals) 1,731 cycles of latency on its own.  So:
//
// - consumer warps run the trajectories.  At n = 20, d = 4 (the paths'
//   polynomial posterior) the rows, the prior and the Gamma terms sit in
//   each thread's registers (RegLinreg) and the row loop is unrolled; any
//   other n and d in 1..7 read the rows from shared memory
//   (LinregDensity::value_and_grad);
// - producer warps draw the noise one step ahead, into a slot of shared
//   memory, so a step's Philox latency overlaps the step before: warps
//   w + 4 and w + 8 of a CTA draw consumer warp w's momenta p = z /
//   sqrt(max(im, 1e-20)), the first the even Philox slots, the second the
//   odd ones and log(max(u, 1e-30)).  One producer alone took ~5,000
//   cycles a step beside its consumer on a scheduler (the consumer issues
//   most cycles), longer than the consumer's trajectory, which then waited
//   1,771 cycles a step; two halve the chain and the wait falls to ~125.
//   The three warps meet at two named barriers a step (full, empty).
//   Warps w, w + 4 and w + 8 share a scheduler (warp id mod 4): CTAs of
//   384 threads, 128 chains, which leave 168 registers a thread.  In them
//   the trajectory runs ~4,550 cycles a step with one accumulator for the
//   row sums, 5,300 with four (3,200 with four and 171 registers, one
//   producer); setmaxnreg, handing the producers' registers to the
//   consumers, left ptxas at 168 with 576 bytes of spills;
// - U and grad U of the current state are carried from step to step (the
//   endpoint's on acceptance): a trajectory costs L evaluations, not L + 1,
//   with the same bits.
//
// Noise comes from Philox keyed by (chain, step, slot, kTagSample), or from
// staged arrays in the JAX host-noise layout (steps, 8, C), (steps, 1, C).
// Accept rule: log u < E0 - E1 with no divergence guard, as the TPU
// kernel.  Draws (steps, C, d + 1) and per-chain accept counts (int32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"
#include "linreg_density.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK2Pairs = 4;                 // consumer warps a CTA, each with 2 producers
constexpr int kK2Threads = 96 * kK2Pairs;   // 128 chains a CTA
constexpr int kK2Slot = 9;                  // floats a chain's noise slot: p (D <= 8), log u
// a pair's slots are (kK2Slot, 32): lane-consecutive, so a warp reads without bank conflicts

// The density with the rows in registers: N rows of DC coefficients,
// unrolled, the sums over the rows in one accumulator each (several partial
// sums were slower in the kernel's 168 registers).
template <int DC, int N>
struct RegLinreg {
  static constexpr int D = DC + 1;
  float V[N][DC], y[N], pm[DC], ipv[DC];
  float half_n_plus_a, rate;

  __device__ explicit RegLinreg(const LinregDensity<DC>& d)
      : half_n_plus_a(d.half_n_plus_a), rate(d.rate) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < DC; ++k) V[i][k] = d.V[i * DC + k];
      y[i] = d.y[i];
    }
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      pm[k] = d.pm[k];
      ipv[k] = d.ipv[k];
    }
  }

  // U(q); writes grad U(q) into g: LinregDensity::value_and_grad's closed form
  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    float ss = 0.0f, gc[DC];
#pragma unroll
    for (int k = 0; k < DC; ++k) gc[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < DC; ++k) r = fmaf(V[i][k], q[k], r);
      r -= y[i];
      ss = fmaf(r, r, ss);
#pragma unroll
      for (int k = 0; k < DC; ++k) gc[k] = fmaf(V[i][k], r, gc[k]);
    }
    const float t = q[DC];
    const float lam = expf(t);
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      const float qc = q[k] - pm[k];
      prior += qc * qc * ipv[k];
      g[k] = lam * gc[k] + qc * ipv[k];
    }
    g[DC] = 0.5f * lam * ss - half_n_plus_a + rate * lam;
    return 0.5f * lam * ss - half_n_plus_a * t + rate * lam + 0.5f * prior;
  }
};

// The rows in shared memory, any n (the functor after its stage()).
template <int DC>
struct SharedLinreg {
  static constexpr int D = DC + 1;
  LinregDensity<DC> dens;
  __device__ explicit SharedLinreg(const LinregDensity<DC>& d) : dens(d) {}
  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    return dens.value_and_grad(q, g);
  }
};

struct K2Args {
  const float* q0;   // (C, D)
  const float* eps;  // (1,)
  const float* im;   // (D,)
  int n_chains, num_steps, num_leapfrog;
  uint64_t seed;
  const float* mom;   // staged (steps, 8, C), or null: Philox
  const float* unif;  // staged (steps, 1, C)
  float* draws;       // (steps, C, D)
  int* accepts;       // (C,)
};

// named barriers of the 96 threads of a consumer and its producers;
// barrier 0 is __syncthreads
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 96;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 96;" ::"r"(id) : "memory");
}

// Producer `half` (0 or 1) of chain c: the momenta of Philox slots
// half, half + 2, ... (normals 2 slot and 2 slot + 1, step_noise's
// counters, so its bits) and, for half 1, log u, into the chain's slot one
// step ahead of the consumer.  Barrier 1 + 2 pair: full; 2 + 2 pair: empty.
template <int D>
__device__ void k2_produce(const K2Args& a, int c, float* slot, int pair, int half) {
  constexpr int kMom = (D + 1) / 2;  // Philox slots of the momenta
  float s_im[D];
#pragma unroll
  for (int k = 0; k < D; ++k) s_im[k] = sqrtf(fmaxf(a.im[k], 1e-20f));
  const int cc = c < a.n_chains ? c : a.n_chains - 1;  // idle lanes draw a real chain's noise
  const uint32_t k0 = (uint32_t)a.seed, k1 = (uint32_t)(a.seed >> 32);
  for (int s = 0; s < a.num_steps; ++s) {
    float z[D], u = 0.0f;
    if (a.mom != nullptr) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        if ((k / 2) % 2 == half) z[k] = a.mom[((int64_t)s * 8 + k) * a.n_chains + cc];
      if (half) u = a.unif[(int64_t)s * a.n_chains + cc];
    } else {
#pragma unroll
      for (int sl = 0; sl < kMom; ++sl) {
        if (sl % 2 != half) continue;
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)cc, (uint32_t)s, (uint32_t)sl,
                                                kTagSample}, k0, k1);
        z[2 * sl] = bits_to_normal(b.x, b.y);
        if (2 * sl + 1 < D) z[2 * sl + 1] = bits_to_normal(b.z, b.w);
      }
      if (half) {
        const Philox4 b = philox4x32_10(Philox4{(uint32_t)cc, (uint32_t)s, kUniformSlot,
                                                kTagSample}, k0, k1);
        u = bits_to_uniform(b.x);
      }
    }
    float p[D];
#pragma unroll
    for (int k = 0; k < D; ++k)
      if ((k / 2) % 2 == half) p[k] = z[k] / s_im[k];
    const float log_u = logf(fmaxf(u, 1e-30f));
    if (s > 0) named_sync(2 + 2 * pair);  // the consumer has read the slot
#pragma unroll
    for (int k = 0; k < D; ++k)
      if ((k / 2) % 2 == half) slot[32 * k] = p[k];
    if (half) slot[32 * D] = log_u;
    named_arrive(1 + 2 * pair);
  }
  named_sync(2 + 2 * pair);  // the consumer's last read
}

template <class Rows>
__device__ void k2_consume(const Rows& rows, const K2Args& a, int c, const float* slot,
                           int pair) {
  constexpr int D = Rows::D;
  const bool live = c < a.n_chains;
  const int cc = live ? c : a.n_chains - 1;
  const float eps = *a.eps, half_eps = 0.5f * eps;
  float q[D], im[D], g[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    q[k] = a.q0[(int64_t)cc * D + k];
    im[k] = a.im[k];
  }
  float U = rows.value_and_grad(q, g);
  int n_acc = 0;
  for (int s = 0; s < a.num_steps; ++s) {
    float p[D];
    named_sync(1 + 2 * pair);  // this step's noise is in the slot
    float kin0 = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      p[k] = slot[32 * k];
      kin0 += p[k] * p[k] * im[k];
    }
    const float log_u = slot[32 * D];
    named_arrive(2 + 2 * pair);
    const float E0 = U + 0.5f * kin0;
    float qn[D], gn[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      p[k] = p[k] - half_eps * g[k];
      qn[k] = q[k];
      gn[k] = g[k];
    }
    float U1 = U;
    for (int l = 0; l < a.num_leapfrog; ++l) {
#pragma unroll
      for (int k = 0; k < D; ++k) qn[k] = qn[k] + eps * p[k] * im[k];
      U1 = rows.value_and_grad(qn, gn);
#pragma unroll
      for (int k = 0; k < D; ++k) p[k] = p[k] - eps * gn[k];
    }
    float kin = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      p[k] = p[k] + half_eps * gn[k];
      kin += p[k] * p[k] * im[k];
    }
    if (log_u < E0 - (U1 + 0.5f * kin)) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        q[k] = qn[k];
        g[k] = gn[k];
      }
      U = U1;
      ++n_acc;
    }
    if (live) {
      float* out = a.draws + ((int64_t)s * a.n_chains + c) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) out[k] = q[k];
    }
  }
  if (live) a.accepts[c] = n_acc;
}

// Warps 0..3 consume, warps 4..11 produce; pair w = warp % 4 covers chains
// blockIdx.x * 128 + 32 w + lane.
template <class Rows, int DC>
__global__ void __launch_bounds__(kK2Threads, 1)
fused_linreg_hmc_kernel(LinregDensity<DC> dens, const K2Args a) {
  constexpr int D = DC + 1;
  extern __shared__ float smem[];
  float* slots = smem + LinregDensity<DC>::smem_floats(dens.n);
  dens.stage(smem);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % kK2Pairs;
  const int c0 = blockIdx.x * (32 * kK2Pairs) + 32 * pair;
  if (c0 >= a.n_chains) return;  // a consumer and its producers leave together
  float* slot = slots + pair * 32 * kK2Slot + lane;
  if (warp >= kK2Pairs) {
    k2_produce<D>(a, c0 + lane, slot, pair, warp / kK2Pairs - 1);
  } else {
    const Rows rows(dens);
    k2_consume(rows, a, c0 + lane, slot, pair);
  }
}

template <int DC>
cudaError_t launch(const LinregDensity<DC>& dens, const K2Args& a, cudaStream_t stream,
                   int* grid) {
  if (a.n_chains <= 0 || a.num_steps <= 0 || a.num_leapfrog < 0) return cudaErrorInvalidValue;
  const size_t smem =
      (LinregDensity<DC>::smem_floats(dens.n) + 32 * kK2Pairs * kK2Slot) * sizeof(float);
  const int blocks = (a.n_chains + 32 * kK2Pairs - 1) / (32 * kK2Pairs);
  int reg_rows = 0;
  if constexpr (DC == 4) {
    if (dens.n == 20) {
      fused_linreg_hmc_kernel<RegLinreg<4, 20>, 4><<<blocks, kK2Threads, smem, stream>>>(dens, a);
      reg_rows = 1;
    }
  }
  if (!reg_rows)
    fused_linreg_hmc_kernel<SharedLinreg<DC>, DC><<<blocks, kK2Threads, smem, stream>>>(dens, a);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = kK2Threads;
    grid[2] = reg_rows;
  }
  return err;
}

}  // namespace binf

// grid (3 ints) receives what was launched: CTAs, threads a CTA, and 1
// where the rows sat in registers (n = 20, d = 4), else 0.
extern "C" int binf_fused_linreg_hmc(int d, const float* V, const float* y, const float* ipv,
                                     const float* pm, int n, float half_n_plus_a, float rate,
                                     const binf::K2Args* args, void* stream, int* grid) {
  cudaStream_t s = (cudaStream_t)stream;
#define BINF_K2(DC)                                                                          \
  case DC:                                                                                   \
    return (int)binf::launch<DC>(binf::LinregDensity<DC>{V, y, ipv, pm, n, half_n_plus_a, \
                                                         rate},                              \
                                 *args, s, grid);
  switch (d) {
    BINF_K2(1)
    BINF_K2(2)
    BINF_K2(3)
    BINF_K2(4)
    BINF_K2(5)
    BINF_K2(6)
    BINF_K2(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BINF_K2
}
