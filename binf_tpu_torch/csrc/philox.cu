// Philox4x32-10 standing alone: raw bits for given counters, and the HMC
// noise stream (normals and accept uniforms) of many chains and steps.
//
// Replaces binf_tpu/ops/pallas/prng.py::_uniform/_normal as a kernel of its
// own, so the device generator can be held bit for bit against its plain
// version (binf_tpu_torch/ops/kernels/prng.py) and timed.  The whole-run
// kernels inline the same device functions (philox.cuh::step_noise).
//
// Bound: the bytes of the output; each thread computes the noise of one
// (step, chain) and writes D + 1 floats.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"
#include "philox.cuh"

namespace binf {

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

template <int D>
__global__ void philox_noise_kernel(uint64_t seed, uint32_t tag, int n_chains,
                                    int num_steps, int step0, float* __restrict__ z_out,
                                    float* __restrict__ u_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_chains * num_steps) return;
  const int s = (int)(i / n_chains), c = (int)(i % n_chains);
  float z[D], u;
  step_noise<D>(seed, tag, (uint32_t)c, (uint32_t)(step0 + s), z, u);
#pragma unroll
  for (int k = 0; k < D; ++k) z_out[i * D + k] = z[k];
  u_out[i] = u;
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
  const int threads = 256;
  const int64_t n = (int64_t)n_chains * num_steps;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  grid[0] = (int)blocks;
  grid[1] = threads;
#define BINF_NOISE(D)                                                                 \
  case D:                                                                             \
    binf::philox_noise_kernel<D>                                                      \
        <<<blocks, threads, 0, s>>>(seed, tag, n_chains, num_steps, step0, z, u);    \
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
