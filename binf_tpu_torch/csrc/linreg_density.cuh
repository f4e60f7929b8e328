// The linear-regression potential in (c, log lambda) space, as a device
// functor the whole-run kernels are templated over.
//
//     U(q) = e^t/2 ||Vc - y||^2 - (n/2 + a) t + b e^t + sum (c-m)^2 / (2 prior_var)
//
// with q = (c_0 .. c_{DC-1}, t).  Closed form and hand gradient of
// binf_tpu/ops/pallas/fused_hmc.py::_kernel.potential_and_grad; the plain
// PyTorch version is LinregDensity.potential_and_grad in
// binf_tpu_torch/ops/kernels/fused_hmc.py.
//
// One evaluation per chain is ~(4 DC + 3) n + 6 DC + 12 float operations
// and one exp.  The data (V, y) and the prior rows live in shared memory,
// read by every thread of the block at the same address (a broadcast), so
// an evaluation touches no device memory.
#pragma once

#include <stdint.h>

namespace binf {

template <int DC>
struct LinregDensity {
  static constexpr int D = DC + 1;

  const float* V;    // (n, DC) row-major, device memory
  const float* y;    // (n,)
  const float* ipv;  // (DC,) 1 / prior variance
  const float* pm;   // (DC,) prior mean
  int n;
  float half_n_plus_a;  // n/2 + Gamma shape
  float rate;           // Gamma rate

  static __host__ __device__ int smem_floats(int n) { return n * DC + n + 2 * DC; }
  __host__ __device__ int shared_floats() const { return smem_floats(n); }

  // Copy the data into shared memory and point at it there.  Every thread
  // of the block calls this; the caller synchronises before the first use.
  __device__ void stage(float* smem) {
    float* sV = smem;
    float* sy = sV + n * DC;
    float* sipv = sy + n;
    float* spm = sipv + DC;
    for (int i = threadIdx.x; i < n * DC; i += blockDim.x) sV[i] = V[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) sy[i] = y[i];
    for (int i = threadIdx.x; i < DC; i += blockDim.x) {
      sipv[i] = ipv[i];
      spm[i] = pm[i];
    }
    V = sV;
    y = sy;
    ipv = sipv;
    pm = spm;
  }

  // U(q); writes grad U(q) into g
  __device__ __forceinline__ float value_and_grad(const float (&q)[D],
                                                  float (&g)[D]) const {
    float sumsq = 0.0f;
    float gc[DC];
#pragma unroll
    for (int k = 0; k < DC; ++k) gc[k] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float* row = V + i * DC;
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < DC; ++k) r = fmaf(row[k], q[k], r);
      r -= y[i];
      sumsq = fmaf(r, r, sumsq);
#pragma unroll
      for (int k = 0; k < DC; ++k) gc[k] = fmaf(row[k], r, gc[k]);
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
    g[DC] = 0.5f * lam * sumsq - half_n_plus_a + rate * lam;
    return 0.5f * lam * sumsq - half_n_plus_a * t + rate * lam + 0.5f * prior;
  }
};

}  // namespace binf
