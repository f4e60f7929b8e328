// The K-component Gaussian mixture posterior (example/mixture.py), K = 2
// .. 8, as a device functor the whole-run kernels are templated over.  With
// q = (s, lw_0..K-1, mu_0..K-1) (sorted names: log_sigma, log_weights, means),
// the means sorted, m_(k), with their permutation, log weights normalised,
// l_k = lw_k - logsumexp(lw), and iv = e^-2s:
//
//     c_ik = -iv/2 (y_i - m_(k))^2 - s + l_k,   L_i = logsumexp_k c_ik
//     U(q) = -sum_i L_i + sum_j (q_j - m'_j)^2 / (2 v_j) + C
//
// with N(m', v) priors on all 2 K + 1 coordinates and C their constants, so
// that U is minus the posterior's log density.  With the responsibilities
// r_ik = e^(c_ik - L_i) and w = softmax(lw):
//
//     dL/dm_(k) = iv sum_i r_ik (y_i - m_(k)),  dL/ds = iv sum_ik r_ik (y_i - m_(k))^2 - n,
//     dL/dlw_k = sum_i r_ik - n w_k,
//
// and the means' gradient goes back through the permutation.  The means
// are sorted by an odd-even transposition network (K rounds of adjacent
// compare-and-swap on a strict <), which is stable: tied means keep their
// order, as torch.sort(stable=True) and jnp.sort keep it, so the gradient of
// a tie goes to the same coordinate.  At K = 3 it is the three-comparator
// network (0,1), (1,2), (0,1).  A point costs K expf and one logf (the
// log-sum-exp against its largest term) and one division.  The plain
// PyTorch version is
// MixtureDensity.potential_and_grad in binf_tpu_torch/ops/kernels/densities.py.
//
// One evaluation is ~47 n + 80 float operations at K = 3 (a transcendental
// counted as one); y and the prior rows live in shared memory.
#pragma once

namespace binf {

template <int K_>
struct MixtureDensity {
  static_assert(K_ >= 2 && K_ <= 8, "the mixture functor takes 2 to 8 components");
  static constexpr int K = K_;
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

  // What every point's terms need: the sorted means m with their
  // permutation perm, the normalised log weights l, the weights w and iv.
  struct Prologue {
    float m[K], l[K], w[K], s, iv;
    int perm[K];
  };

  __device__ static __forceinline__ Prologue prologue(const float (&q)[D]) {
    Prologue pr;
    pr.s = q[0];
    // sort the means by odd-even transposition, keeping the permutation
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pr.m[k] = q[1 + K + k];
      pr.perm[k] = k;
    }
#pragma unroll
    for (int pass = 0; pass < K; ++pass) {
#pragma unroll
      for (int a = pass & 1; a + 1 < K; a += 2) {
        const int b = a + 1;
        if (pr.m[b] < pr.m[a]) {
          const float tm = pr.m[a];
          pr.m[a] = pr.m[b];
          pr.m[b] = tm;
          const int tp = pr.perm[a];
          pr.perm[a] = pr.perm[b];
          pr.perm[b] = tp;
        }
      }
    }
    // normalised log weights and the weights
    float lw_max = q[1];
#pragma unroll
    for (int k = 1; k < K; ++k) lw_max = fmaxf(lw_max, q[1 + k]);
    float wsum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) wsum += expf(q[1 + k] - lw_max);
    const float lse_w = lw_max + logf(wsum);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pr.l[k] = q[1 + k] - lse_w;
      pr.w[k] = expf(pr.l[k]);
    }
    pr.iv = expf(-2.0f * pr.s);
    return pr;
  }

  // One point's terms: its distances d, responsibilities r and (when
  // kValue) log-sum-exp L_i; K expf, one logf and one division, in
  // this order wherever a point is evaluated.
  struct Point {
    float d[K], r[K], lse;
  };

  template <bool kValue>
  __device__ static __forceinline__ Point point(float yi, const Prologue& pr) {
    Point pt;
    float c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pt.d[k] = yi - pr.m[k];
      c[k] = -0.5f * pr.iv * (pt.d[k] * pt.d[k]) - pr.s + pr.l[k];
    }
    float cmax = c[0];
#pragma unroll
    for (int k = 1; k < K; ++k) cmax = fmaxf(cmax, c[k]);
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = expf(c[k] - cmax);
    float se = e[0];
#pragma unroll
    for (int k = 1; k < K; ++k) se += e[k];
    pt.lse = kValue ? cmax + logf(se) : 0.0f;
    const float inv = 1.0f / se;
#pragma unroll
    for (int k = 0; k < K; ++k) pt.r[k] = e[k] * inv;
    return pt;
  }

  // The sums over points: S[0] = sum L_i, S[1..K] = sum_i r_ik, S[K+1..2K]
  // = sum_i r_ik d_ik, S[2K+1] = sum_ik r_ik d_ik^2, each added in point
  // order.
  static constexpr int kSums = 2 * K + 2;

  template <bool kValue>
  __device__ static __forceinline__ void add(const Point& pt, float (&S)[kSums]) {
    if (kValue) S[0] += pt.lse;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      S[1 + k] += pt.r[k];
      S[1 + K + k] = fmaf(pt.r[k], pt.d[k], S[1 + K + k]);
      S[kSums - 1] = fmaf(pt.r[k] * pt.d[k], pt.d[k], S[kSums - 1]);
    }
  }

  // After the sums: grad U into g, and U
  __device__ __forceinline__ float close(const float (&q)[D], const Prologue& pr,
                                         const float (&S)[kSums], float (&g)[D]) const {
    const float fn = (float)n;
    float dL[D];
    dL[0] = pr.iv * S[kSums - 1] - fn;
#pragma unroll
    for (int k = 0; k < K; ++k) dL[1 + k] = S[1 + k] - fn * pr.w[k];
    // back through the sort: the sorted position k came from perm[k]; the
    // sum is picked by selects (a register array indexed by perm would go
    // to local memory)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float v = S[2 * K];
#pragma unroll
      for (int k = K - 2; k >= 0; --k) v = pr.perm[k] == j ? S[1 + K + k] : v;
      dL[1 + K + j] = pr.iv * v;
    }
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float qc = q[k] - pm[k];
      prior = fmaf(qc * qc, ipv[k], prior);
      g[k] = fmaf(qc, ipv[k], -dL[k]);
    }
    return -S[0] + 0.5f * prior + cnst;
  }
};

}  // namespace binf
