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
// row (the gradient alone needs no log1pf).  stage() copies each row as
// x_i and y_i, padded to an odd stride kStride: the lanes of a group
// (lanes.cuh) read rows i, i + 1, ..., i + G - 1 at once, and at an odd
// stride those rows start in G different banks for any G <= 32 (at D + 1
// = 6 floats, a stride of 6 puts rows r and r + 16 in one bank).  The
// prior rows follow the data.
#pragma once

namespace binf {

template <int DD>
struct LogisticDensity {
  static constexpr int D = DD;
  static constexpr int kStride = (D + 1) | 1;  // a staged row: x_i, y_i, padding

  const float* X;    // (n, D) row-major, device memory; after stage(), rows at kStride
  const float* y;    // (n,) labels, 0 or 1; after stage(), y_i at X + i kStride + D
  const float* ipv;  // (D,) 1 / prior variance
  const float* pm;   // (D,) prior mean
  int n;
  float cnst;  // C

  __host__ __device__ int shared_floats() const { return n * kStride + 2 * D; }

  // Copy the data into shared memory and point at it there.  Every thread
  // of the block calls this; the caller synchronises before the first use.
  __device__ void stage(float* smem) {
    float* sipv = smem + n * kStride;
    float* spm = sipv + D;
    for (int i = threadIdx.x; i < n * kStride; i += blockDim.x) {
      const int row = i / kStride, k = i - row * kStride;
      smem[i] = k < D ? X[row * D + k] : k == D ? y[row] : 0.0f;
    }
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      sipv[i] = ipv[i];
      spm[i] = pm[i];
    }
    X = smem;
    y = smem + D;
    ipv = sipv;
    pm = spm;
  }

  // One row's terms at eta = x_i . w: softplus(eta) - y_i eta into t (when
  // kValue) and sigmoid(eta) - y_i into r, one expf, one log1pf and one
  // division, in this order wherever a row is evaluated.
  template <bool kValue>
  __device__ static __forceinline__ void row(float eta, float yi, float& t, float& r) {
    const float e = expf(-fabsf(eta));
    if (kValue) t = fmaxf(eta, 0.0f) + log1pf(e) - yi * eta;
    r = (eta >= 0.0f ? 1.0f : e) / (1.0f + e) - yi;
  }

  // The prior after the row sums: adds (w - m) / v to g and returns U
  __device__ __forceinline__ float close(const float (&q)[D], float u, float (&g)[D]) const {
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
