// An axis-aligned Gaussian potential, as a device functor the whole-run
// kernels are templated over:
//
//     U(q) = 1/2 sum_k ((q_k - m_k) / s_k)^2,   grad_k U = (q_k - m_k) / s_k^2
//
// The plain PyTorch version is DiagGaussianDensity.potential_and_grad in
// binf_tpu_torch/ops/kernels/densities.py.  It is the target of the JAX
// package's in-kernel ChEES tests (tests/test_chees_fused.py), and it shows
// that the kernels take any functor with this interface.  One evaluation
// is 4 D + 1 float operations; m and s live in shared memory.
#pragma once

namespace binf {

template <int DD>
struct DiagGaussianDensity {
  static constexpr int D = DD;

  const float* m;  // (D,) means, device memory
  const float* s;  // (D,) standard deviations

  __host__ __device__ int shared_floats() const { return 2 * D; }

  // Copy the operands into shared memory and point at them there.  Every
  // thread of the block calls this; the caller synchronises before the
  // first use.
  __device__ void stage(float* smem) {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      smem[i] = m[i];
      smem[D + i] = s[i];
    }
    m = smem;
    s = smem + D;
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D],
                                                  float (&g)[D]) const {
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float z = (q[k] - m[k]) / s[k];
      u += z * z;
      g[k] = z / s[k];
    }
    return 0.5f * u;
  }
};

}  // namespace binf
