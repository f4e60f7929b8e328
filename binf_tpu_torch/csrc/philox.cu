// Philox4x32-10 standing alone: raw bits for given counters, and the HMC
// noise stream (normals and accept uniforms) of many chains and steps.
//
// Replaces binf_tpu/ops/pallas/prng.py::_uniform/_normal as a kernel of its
// own, so the device generator can be held bit for bit against its plain
// version (binf_tpu_torch/ops/kernels/prng.py) and timed.  The whole-run
// kernels inline the same device functions (philox.cuh::step_noise).
//
// What bounds it: the integer pipe, not its bytes.  At D = 5 a chain-step
// writes 24 bytes and issues the four Philox calls and five normals of
// philox.cuh, about 350 instructions of which about 170 take the integer
// pipe (chip_smoke.py::phase_philox counts them in this unit's SASS).  So
// the kernel spends as few instructions as it can beside them: a thread
// owns one chain over a run of steps (the chain's own Philox terms are
// computed once, the round keys come from the constant bank), and a warp's
// 32 chains of one step are 32 D contiguous floats, staged in shared memory
// and written as 16-byte stores, rather than each thread scattering D
// floats at a stride of D.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "c_api.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kNoiseThreads = 256;    // 8 warps, 256 chains a CTA
constexpr int kNoiseSteps = 16;       // steps a thread, at least

__global__ void philox_bits_kernel(const uint32_t* __restrict__ ctr, uint32_t k0,
                                   uint32_t k1, int n, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Philox4 b = philox4x32_10(
      Philox4{ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]}, k0, k1);
  out[4 * i] = b.x;
  out[4 * i + 1] = b.y;
  out[4 * i + 2] = b.z;
  out[4 * i + 3] = b.w;
}

// Lane `lane`'s D normals into its warp's staging row: as 16- or 8-byte
// stores where D allows (conflict-free at any D: odd D strides the banks).
template <int D>
__device__ __forceinline__ void stage_normals(float* buf, int lane, const float (&z)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D; k += 4)
      *reinterpret_cast<float4*>(buf + lane * D + k) = make_float4(z[k], z[k + 1], z[k + 2],
                                                                   z[k + 3]);
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D; k += 2)
      *reinterpret_cast<float2*>(buf + lane * D + k) = make_float2(z[k], z[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) buf[lane * D + k] = z[k];
  }
}

// grid (ceil(C / 256), ceil(steps / steps_per_cta)); a thread draws chain c's
// noise at steps_per_cta consecutive steps, four a pass, the round keys read
// from the parameter (the constant bank) rather than bumped in every call;
// up to 64 registers (4 CTAs an SM) keep the pass's constants and addresses
// out of its instructions.  Vec: every warp holds 32 chains
// (C % 32 == 0), so a warp's rows are 32 D floats at a 16-byte aligned
// offset and go out as float4; otherwise the rows go out as floats, the
// last warp's lanes past C storing nothing.
template <int D, bool Vec>
__global__ void __launch_bounds__(kNoiseThreads, 4)
philox_noise_kernel(const PhiloxKeys keys, uint32_t tag, int n_chains, int num_steps, int step0,
                    int steps_per_cta, float* __restrict__ z_out, float* __restrict__ u_out) {
  __shared__ __align__(16) float stage[kNoiseThreads / 32][32 * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kNoiseThreads + warp * 32;  // the warp's first chain
  if (c0 >= n_chains) return;
  const bool live = c0 + lane < n_chains;
  const uint32_t c = (uint32_t)(live ? c0 + lane : n_chains - 1);
  const int span = (Vec ? 32 : min(32, n_chains - c0)) * D;  // the warp's floats a step
  float* buf = stage[warp];
  const int s0 = blockIdx.y * steps_per_cta, s_end = min(num_steps, s0 + steps_per_cta);
  // the warp's rows at step s0, moved on a step at a time
  float* z_row = z_out + ((int64_t)s0 * n_chains + c0) * D;
  float* u_row = u_out + (int64_t)s0 * n_chains + c0;
  const int64_t z_step = (int64_t)n_chains * D;
#pragma unroll 4
  for (int s = s0; s < s_end; ++s, z_row += z_step, u_row += n_chains) {
    float z[D], u;
    step_noise<D>(keys, tag, c, (uint32_t)(step0 + s), z, u);
    if (Vec || live) u_row[lane] = u;
    stage_normals<D>(buf, lane, z);
    __syncwarp();
    if constexpr (Vec) {
#pragma unroll
      for (int j = lane; j < 8 * D; j += 32)
        reinterpret_cast<float4*>(z_row)[j] = reinterpret_cast<const float4*>(buf)[j];
    } else {
#pragma unroll
      for (int j = lane; j < 32 * D; j += 32)
        if (j < span) z_row[j] = buf[j];
    }
    __syncwarp();  // the row is out before the next step overwrites it
  }
}

// The checks' view of the conversions (chip_smoke.py::phase_philox): part 0
// the radius sqrt(-2 ln u1) of b1, 1 the cosine cos(2 pi u2) of b2, 2 the
// normal of (b1, b2), 3 the uniform of b1; Reference draws the previous
// form (logf, cosf, sqrtf).
template <bool Reference>
__global__ void philox_parts_kernel(int part, const uint32_t* __restrict__ b1,
                                    const uint32_t* __restrict__ b2, int n,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v;
  if (part == 0)
    v = Reference ? normal_radius_reference(b1[i]) : normal_radius(b1[i]);
  else if (part == 1)
    v = Reference ? normal_cosine_reference(b2[i]) : normal_cosine(b2[i]);
  else if (part == 2)
    v = Reference ? bits_to_normal_reference(b1[i], b2[i]) : bits_to_normal(b1[i], b2[i]);
  else
    v = Reference ? bits_to_uniform_reference(b1[i]) : bits_to_uniform(b1[i]);
  out[i] = v;
}

// Cycles of one step's noise at D = 5 (clock64() around reps steps, each
// drawn for a chain index that depends on the step before), in the
// kernels' form or the previous one.
template <bool Reference>
__global__ void philox_step_cycles_kernel(uint64_t seed, int n_chains, int reps,
                                          float* __restrict__ sink,
                                          long long* __restrict__ cycles) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  float acc = 0.0f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    float z[5], u;
    step_noise<5, Reference>(seed, kTagSample, (uint32_t)c + (acc > 1e30f), (uint32_t)r, z,
                             u);
    acc += z[0] + z[1] + z[2] + z[3] + z[4] + u;
  }
  const long long t1 = clock64();
  sink[c] = acc;
  cycles[c] = t1 - t0;
}

}  // namespace binf

extern "C" int binf_philox_bits(const uint32_t* ctr, unsigned int k0, unsigned int k1,
                                int n, uint32_t* out, void* stream) {
  const int threads = 256;
  binf::philox_bits_kernel<<<(n + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(ctr, k0, k1, n, out);
  return (int)cudaGetLastError();
}

// grid (2 ints) receives what was launched: CTAs and threads a CTA.
extern "C" int binf_philox_noise(int d, unsigned long long seed, unsigned int tag,
                                 int n_chains, int num_steps, int step0, float* z,
                                 float* u, void* stream, int* grid) {
  using binf::kNoiseThreads;
  if (n_chains <= 0 || num_steps <= 0) {  // nothing to draw
    grid[0] = 0;
    grid[1] = kNoiseThreads;
    return (int)cudaSuccess;
  }
  // at least kNoiseSteps steps a thread, and grid.y within its limit
  const int per_cta = std::max(binf::kNoiseSteps, (num_steps + 65534) / 65535);
  const dim3 blocks((unsigned)((n_chains + kNoiseThreads - 1) / kNoiseThreads),
                    (unsigned)((num_steps + per_cta - 1) / per_cta));
  const bool vec = n_chains % 32 == 0;
  const binf::PhiloxKeys keys(seed);
  cudaStream_t s = (cudaStream_t)stream;
  grid[0] = (int)(blocks.x * blocks.y);
  grid[1] = kNoiseThreads;
#define BINF_NOISE(D)                                                                       \
  case D:                                                                                   \
    if (vec)                                                                                \
      binf::philox_noise_kernel<D, true><<<blocks, kNoiseThreads, 0, s>>>(                  \
          keys, tag, n_chains, num_steps, step0, per_cta, z, u);                            \
    else                                                                                    \
      binf::philox_noise_kernel<D, false><<<blocks, kNoiseThreads, 0, s>>>(                 \
          keys, tag, n_chains, num_steps, step0, per_cta, z, u);                            \
    return (int)cudaGetLastError();
  switch (d) {
    BINF_NOISE(1)
    BINF_NOISE(2)
    BINF_NOISE(3)
    BINF_NOISE(4)
    BINF_NOISE(5)
    BINF_NOISE(6)
    BINF_NOISE(7)
    BINF_NOISE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BINF_NOISE
}

// part and reference as philox_parts_kernel; b2 may be b1
extern "C" int binf_philox_parts(int part, int reference, const uint32_t* b1,
                                 const uint32_t* b2, int n, float* out, void* stream) {
  if (part < 0 || part > 3 || n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (reference)
    binf::philox_parts_kernel<true><<<blocks, threads, 0, s>>>(part, b1, b2, n, out);
  else
    binf::philox_parts_kernel<false><<<blocks, threads, 0, s>>>(part, b1, b2, n, out);
  return (int)cudaGetLastError();
}

extern "C" int binf_philox_step_cycles(int reference, int n_chains, int threads, int reps,
                                       float* sink, long long* cycles, void* stream) {
  const unsigned blocks = (unsigned)((n_chains + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (reference)
    binf::philox_step_cycles_kernel<true><<<blocks, threads, 0, s>>>(0x1234ull, n_chains,
                                                                    reps, sink, cycles);
  else
    binf::philox_step_cycles_kernel<false><<<blocks, threads, 0, s>>>(0x1234ull, n_chains,
                                                                     reps, sink, cycles);
  return (int)cudaGetLastError();
}
