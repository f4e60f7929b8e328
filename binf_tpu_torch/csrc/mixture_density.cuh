// The three-component Gaussian mixture posterior (example/mixture.py), as
// a device functor the whole-run kernels are templated over.  With
// q = (s, lw_0..2, mu_0..2) (sorted names: log_sigma, log_weights, means),
// the means sorted, m_(k), with their permutation, log weights normalised,
// l_k = lw_k - logsumexp(lw), and iv = e^-2s:
//
//     c_ik = -iv/2 (y_i - m_(k))^2 - s + l_k,   L_i = logsumexp_k c_ik
//     U(q) = -sum_i L_i + sum_j (q_j - m'_j)^2 / (2 v_j) + C
//
// with N(m', v) priors on all seven coordinates and C their constants, so
// that U is minus the posterior's log density.  With the responsibilities
// r_ik = e^(c_ik - L_i) and w = softmax(lw):
//
//     dL/dm_(k) = iv sum_i r_ik (y_i - m_(k)),  dL/ds = iv sum_ik r_ik (y_i - m_(k))^2 - n,
//     dL/dlw_k = sum_i r_ik - n w_k,
//
// and the means' gradient goes back through the permutation.  A point
// costs three expf and one logf (the log-sum-exp against its largest
// term) and one division.  The plain PyTorch version is
// MixtureDensity.potential_and_grad in binf_tpu_torch/ops/kernels/densities.py.
//
// One evaluation is ~47 n + 80 float operations (a transcendental counted
// as one); y and the prior rows live in shared memory.
#pragma once

namespace binf {

struct MixtureDensity {
  static constexpr int K = 3;
  static constexpr int D = 2 * K + 1;

  const float* y;    // (n,) observations, device memory
  const float* ipv;  // (D,) 1 / prior variance, pack order
  const float* pm;   // (D,) prior mean, pack order
  int n;
  float cnst;  // C

  __host__ __device__ int shared_floats() const { return n + 2 * D; }

  __device__ void stage(float* smem) {
    float* sy = smem;
    float* sipv = smem + n;
    float* spm = sipv + D;
    for (int i = threadIdx.x; i < n; i += blockDim.x) sy[i] = y[i];
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      sipv[i] = ipv[i];
      spm[i] = pm[i];
    }
    y = sy;
    ipv = sipv;
    pm = spm;
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    const float s = q[0];
    // sort the means by a three-comparator network, keeping the permutation
    float m[K] = {q[1 + K], q[2 + K], q[3 + K]};
    int perm[K] = {0, 1, 2};
    auto order = [&](int a, int b) {
      if (m[b] < m[a]) {
        const float tm = m[a];
        m[a] = m[b];
        m[b] = tm;
        const int tp = perm[a];
        perm[a] = perm[b];
        perm[b] = tp;
      }
    };
    order(0, 1);
    order(1, 2);
    order(0, 1);
    // normalised log weights and the weights
    const float lw_max = fmaxf(fmaxf(q[1], q[2]), q[3]);
    float wsum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) wsum += expf(q[1 + k] - lw_max);
    const float lse_w = lw_max + logf(wsum);
    float l[K], w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      l[k] = q[1 + k] - lse_w;
      w[k] = expf(l[k]);
    }
    const float iv = expf(-2.0f * s);
    float L = 0.0f, R[K] = {0.0f, 0.0f, 0.0f}, Gm[K] = {0.0f, 0.0f, 0.0f}, Gs = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float yi = y[i];
      float d[K], c[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        d[k] = yi - m[k];
        c[k] = -0.5f * iv * (d[k] * d[k]) - s + l[k];
      }
      const float cmax = fmaxf(fmaxf(c[0], c[1]), c[2]);
      float e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = expf(c[k] - cmax);
      const float se = e[0] + e[1] + e[2];
      L += cmax + logf(se);
      const float inv = 1.0f / se;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float r = e[k] * inv;
        R[k] += r;
        Gm[k] = fmaf(r, d[k], Gm[k]);
        Gs = fmaf(r * d[k], d[k], Gs);
      }
    }
    const float fn = (float)n;
    float dL[D];
    dL[0] = iv * Gs - fn;
#pragma unroll
    for (int k = 0; k < K; ++k) dL[1 + k] = R[k] - fn * w[k];
    // back through the sort: the sorted position k came from perm[k]
#pragma unroll
    for (int j = 0; j < K; ++j)
      dL[1 + K + j] = iv * (perm[0] == j ? Gm[0] : perm[1] == j ? Gm[1] : Gm[2]);
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float qc = q[k] - pm[k];
      prior = fmaf(qc * qc, ipv[k], prior);
      g[k] = fmaf(qc, ipv[k], -dL[k]);
    }
    return -L + 0.5f * prior + cnst;
  }
};

}  // namespace binf
