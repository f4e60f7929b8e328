// The logistic-regression potential (example/logistic.py), as a device
// functor the whole-run kernels are templated over:
//
//     U(w) = sum_i [softplus(x_i . w) - y_i x_i . w] + sum_k (w_k - m_k)^2 / (2 v_k) + C
//     grad U = X^T (sigmoid(X w) - y) + (w - m) / v
//
// C = sum_k log(2 pi v_k) / 2, so that U is minus the posterior's log
// density.  softplus(eta) = max(eta, 0) + log1p(e^-|eta|) and the sigmoid
// from the same e^-|eta|: one expf and one log1pf a row, stable at any
// eta.  The plain PyTorch version is LogisticDensity.potential_and_grad in
// binf_tpu_torch/ops/kernels/densities.py.
//
// One evaluation is ~(4 D + 12) n + 4 D + 4 float operations, a
// transcendental counted as one: one expf, one log1pf and one division a
// row.  X, y and the prior rows live in shared memory, read by every
// thread at the same address.
#pragma once

namespace binf {

template <int DD>
struct LogisticDensity {
  static constexpr int D = DD;

  const float* X;    // (n, D) row-major, device memory
  const float* y;    // (n,) labels, 0 or 1
  const float* ipv;  // (D,) 1 / prior variance
  const float* pm;   // (D,) prior mean
  int n;
  float cnst;  // C

  __host__ __device__ int shared_floats() const { return n * D + n + 2 * D; }

  // Copy the data into shared memory and point at it there.  Every thread
  // of the block calls this; the caller synchronises before the first use.
  __device__ void stage(float* smem) {
    float* sX = smem;
    float* sy = sX + n * D;
    float* sipv = sy + n;
    float* spm = sipv + D;
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) sX[i] = X[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) sy[i] = y[i];
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      sipv[i] = ipv[i];
      spm[i] = pm[i];
    }
    X = sX;
    y = sy;
    ipv = sipv;
    pm = spm;
  }

  // U(w); writes grad U(w) into g
  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float* row = X + i * D;
      float eta = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) eta = fmaf(row[k], q[k], eta);
      const float e = expf(-fabsf(eta));
      const float softplus = fmaxf(eta, 0.0f) + log1pf(e);
      const float sig = (eta >= 0.0f ? 1.0f : e) / (1.0f + e);
      u += softplus - y[i] * eta;
      const float r = sig - y[i];
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = fmaf(row[k], r, g[k]);
    }
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float qc = q[k] - pm[k];
      prior = fmaf(qc * qc, ipv[k], prior);
      g[k] = fmaf(qc, ipv[k], g[k]);
    }
    return u + 0.5f * prior + cnst;
  }
};

}  // namespace binf
