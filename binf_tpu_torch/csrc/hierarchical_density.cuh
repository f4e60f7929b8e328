// The hierarchical posterior (example/hierarchical.py) of NG groups under
// transform_logdensity(..., {"precision": LogTransform}), as a device
// functor the whole-run kernels are templated over.  With
// q = (group_params (NG, 2) row-major: la_g, r_g; log_tau (2); mu (2); t)
// (the sorted names), lambda = e^t, A_g = e^la_g, s_gi = sigmoid(r_g x_i),
// m_gi = A_g s_gi, eta_g = offset + la_g, tau_j = e^log_tau_j and
// d_gj = group_params[g, j] - mu_j:
//
//     U(q) = lambda/2 sum_gi (m_gi - y_gi)^2 - (N/2 + a) t + b lambda
//            + sum_g (e^eta_g - c_g eta_g)
//            + 1/2 sum_gj (d_gj / tau_j)^2 + NG sum_j log_tau_j
//            + sum_j mu_j^2 / 8 + 1/2 sum_j (log_tau_j + 1)^2 + C
//
// over N = NG n curve points: the curves' Gaussian error model with full
// normalisation (binf_tpu/model/error.py:82-89), the counts' Poisson model
// under its log link (:142-169; c log e^eta taken as c eta), the pooled
// prior and its hyperpriors (binf_tpu/example/hierarchical.py:95-121),
// Gamma(a, b) on lambda (pdf/priors.py:54) and the Jacobian t of
// LogTransform (pdf/transforms.py:102).  C gathers the data-only
// constants (the log 2 pi terms, sum_g lgamma(c_g + 1), the Gamma's),
// made on the host once, so that U is minus the posterior's log density.
// With res_gi = m_gi - y_gi:
//
//     dU/dla_g = lambda sum_i res_gi m_gi + e^eta_g - c_g + d_g0 / tau_0^2
//     dU/dr_g  = lambda A_g sum_i res_gi s_gi (1 - s_gi) x_i + d_g1 / tau_1^2
//     dU/dlog_tau_j = -sum_g (d_gj / tau_j)^2 + NG + log_tau_j + 1
//     dU/dmu_j = -sum_g d_gj / tau_j^2 + mu_j / 4
//     dU/dt = lambda/2 sum_gi res_gi^2 - (N/2 + a) + b lambda
//
// A row is one (group, point) pair: a sigmoid (one expf, one division)
// and a handful of FMAs, 16 float operations (the transcendental and the
// division counted as one each), two MUFU results (ex2 and rcp) and 36
// instructions in the SASS.  A group adds two expf (its amplitude and its
// Poisson rate) and ~12 operations; the pooled prior 16 NG more, the
// closed form two expf (1 / tau_j), one (lambda) and ~40 operations.  So
// one evaluation is ~16 N + 28 NG + 40 float operations
// (chip_smoke.py::hierarchical_eval_flops) and 2 N + 2 NG + 3 MUFU
// results (chip_smoke.py::mufu_counts).  The plain PyTorch
// version is HierarchicalDensity.potential_and_grad in
// binf_tpu_torch/ops/kernels/densities.py.
//
// stage() copies x, y, the counts and the scalars to shared memory; a
// lane group (lanes.cuh) gives each lane whole groups, so only the curve
// sum of squares (and with U the Poisson terms) cross lanes, and each
// group's two gradients are broadcast from the lane that owns it.
#pragma once

namespace binf {

template <int NG_>
struct HierarchicalDensity {
  static constexpr int NG = NG_;
  static constexpr int D = 2 * NG + 5;
  static constexpr int kLogTau = 2 * NG, kMu = 2 * NG + 2, kT = 2 * NG + 4;

  const float* x;       // (n,) curve points, device memory
  const float* y;       // (NG n,) curves, group-major
  const float* counts;  // (NG,)
  const float* scal;    // (4,): offset, N/2 + a, b, C
  int n;                // points a group

  __host__ __device__ int shared_floats() const { return n + NG * n + NG + 4; }

  __device__ void stage(float* smem) {
    float* sx = smem;
    float* sy = sx + n;
    float* sc = sy + NG * n;
    float* ss = sc + NG;
    for (int i = threadIdx.x; i < n; i += blockDim.x) sx[i] = x[i];
    for (int i = threadIdx.x; i < NG * n; i += blockDim.x) sy[i] = y[i];
    for (int i = threadIdx.x; i < NG; i += blockDim.x) sc[i] = counts[i];
    for (int i = threadIdx.x; i < 4; i += blockDim.x) ss[i] = scal[i];
    x = sx;
    y = sy;
    counts = sc;
    scal = ss;
  }

  // One row: adds res^2, res m and res s (1 - s) x to S, Ga and Gr.  One
  // expf and one division, in this order wherever a row is evaluated.
  __device__ static __forceinline__ void row(float r, float A, float xi, float yi, float& S,
                                             float& Ga, float& Gr) {
    const float s = 1.0f / (1.0f + expf(-(r * xi)));
    const float m = A * s;
    const float res = m - yi;
    S = fmaf(res, res, S);
    Ga = fmaf(res, m, Ga);
    Gr = fmaf(res * (s * (1.0f - s)), xi, Gr);
  }

  // Group g's sums at (la, r): the curve's sum of squares, its two data
  // gradients before lambda (sum res m, A sum res s (1 - s) x), the
  // Poisson value e^eta - c eta (when kValue) and gradient e^eta - c.
  struct Group {
    float sumsq, ga, gr, pois, dpois;
  };

  template <bool kValue>
  __device__ __forceinline__ Group group(int g, float la, float r) const {
    const float A = expf(la);
    const float* yg = y + g * n;
    float S = 0.0f, Ga = 0.0f, Gr = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) row(r, A, x[i], yg[i], S, Ga, Gr);
    const float eta = scal[0] + la;
    const float e = expf(eta);
    const float c = counts[g];
    return {S, Ga, A * Gr, kValue ? e - c * eta : 0.0f, e - c};
  }

  // After the sums: g holds each group's data gradients (lambda applied,
  // the Poisson term added); adds the pooled prior and writes the
  // hyperparameters' and t's gradients; returns U (when kValue) from the
  // curves' sum of squares S and the Poisson values P.
  template <bool kValue>
  __device__ __forceinline__ float close(const float (&q)[D], float lam, float S, float P,
                                         float (&g)[D]) const {
    float itau2[2], sq[2], sd[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float it = expf(-q[kLogTau + j]);
      itau2[j] = it * it;
      sq[j] = 0.0f;
      sd[j] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 2 * NG; ++k) {
      const int j = k & 1;
      const float d = q[k] - q[kMu + j];
      sq[j] = fmaf(d * d, itau2[j], sq[j]);
      sd[j] = fmaf(d, itau2[j], sd[j]);
      g[k] = fmaf(d, itau2[j], g[k]);
    }
    const float coef_t = scal[1], rate = scal[2];
    float prior = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float lt = q[kLogTau + j], mu = q[kMu + j];
      g[kLogTau + j] = (float)NG - sq[j] + (lt + 1.0f);
      g[kMu + j] = fmaf(0.25f, mu, -sd[j]);
      if (kValue) prior += 0.5f * sq[j] + (float)NG * lt + 0.125f * mu * mu
                           + 0.5f * (lt + 1.0f) * (lt + 1.0f);
    }
    const float half_lam_S = 0.5f * lam * S;
    g[kT] = half_lam_S - coef_t + rate * lam;
    if (!kValue) return 0.0f;
    return half_lam_S - coef_t * q[kT] + rate * lam + P + prior + scal[3];
  }
};

}  // namespace binf
