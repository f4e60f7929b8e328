// The Gram-form chromatin density as a CTA-cooperative functor: the density
// of binf_tpu/example/chromatin.py::make_gram_logdensity that the chain-grid
// kernel (chain_grid.cu) runs, one chain per CTA.
//
// Position, flat in sorted-name order: q[0] = u (log precision), then the
// structure X (N, 3) row-major.  With lambda = exp(u), K = sum(W) and
// d2_ij = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 1e-12), r_ij = log(d2)/2 - logD_ij:
//
//   U = lambda/2 sum_ij W_ij r_ij^2 - K u / 2 + k_spring/2 sum_i (|x_{i+1} - x_i| - d0)^2
//       + k_center/2 N |mean X|^2 - (a - 1) u + b lambda - u
//
// over all N^2 ordered pairs (W and logD need not be symmetric).  Its
// gradient with respect to x_i is lambda sum_j (W_ij r_ij + W_ji r_ji) / d2_ij
// (x_i - x_j), summed over pairs above the floor, plus the springs and the
// centring pull.  The plain version is GramChromatinDensity.potential_and_grad
// (binf_tpu_torch/example/chromatin.py).  In float32 the Gram form loses
// digits for close pairs (|x|^2 - x . y cancels), so both sides form x . y,
// |x|^2 and d2 in one order with every operation rounded alone: d2 is then
// the same float in the kernel and the plain version, and they differ only
// by the order of the sums over pairs.
//
// value_and_grad: warp w takes rows w, w + 8, ...; its lanes walk the row's
// columns 32 apart, reading W, logD and the transposes Wt, logDt row-wise
// (coalesced from device memory, conflict-free from shared memory), so one
// pass gives both the loss over the ordered pairs and each row's force.
// Lane sums meet in a fixed xor-shuffle tree and the warps' losses are added
// in warp order: the result is the same bit for bit on every call.  Then one
// warp adds the backbone, the centring and the Gamma terms and the
// log-precision gradient.
#pragma once

#include <stdint.h>

namespace binf {

constexpr int kGramWarps = 8;  // the functor's CTA: 256 threads

// Filled through ctypes by binf_tpu_torch/ops/kernels/chain_grid.py.
struct GramOperands {
  const float* W;      // (N, N)
  const float* logD;   // (N, N)
  const float* Wt;     // W^T, contiguous
  const float* logDt;  // logD^T, contiguous
  int n;
  int resident;  // the four matrices are staged in shared memory
  float k_obs, gamma_shape, gamma_rate, d0, k_spring, k_center;
};

__device__ __forceinline__ float gram_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

struct GramDensity {
  GramOperands op;
  float* sq;   // (N,) |x_i|^2
  float* red;  // kGramWarps warp losses, then U

  // shared floats the functor takes: scratch and, when resident, the matrices
  static __host__ __device__ int64_t shared_floats(int n, int resident) {
    return (int64_t)n + kGramWarps + 1 + (resident ? 4 * (int64_t)n * n : 0);
  }

  // Called by every thread of the CTA, followed by a __syncthreads().
  __device__ void stage(const GramOperands& o, float* s) {
    op = o;
    sq = s;
    red = s + o.n;
    if (o.resident) {
      const int64_t nn = (int64_t)o.n * o.n;
      float* m = red + kGramWarps + 1;
      for (int64_t k = threadIdx.x; k < nn; k += blockDim.x) {
        m[k] = o.W[k];
        m[nn + k] = o.logD[k];
        m[2 * nn + k] = o.Wt[k];
        m[3 * nn + k] = o.logDt[k];
      }
      op.W = m;
      op.logD = m + nn;
      op.Wt = m + 2 * nn;
      op.logDt = m + 3 * nn;
    }
  }

  // U(q) into the return value of every thread and grad U into g (both in
  // shared memory); all threads of the CTA call it.
  __device__ float value_and_grad(const float* q, float* g) const {
    const int n = op.n, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
    const float u = q[0];
    const float* X = q + 1;
    float* gX = g + 1;
    for (int i = tid; i < n; i += blockDim.x) {
      const float x0 = X[3 * i], x1 = X[3 * i + 1], x2 = X[3 * i + 2];
      sq[i] = __fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)), __fmul_rn(x2, x2));
    }
    __syncthreads();

    float loss = 0.0f;
    for (int i = warp; i < n; i += n_warps) {
      const float xi0 = X[3 * i], xi1 = X[3 * i + 1], xi2 = X[3 * i + 2], sqi = sq[i];
      const int64_t row = (int64_t)i * n;
      float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float xj0 = X[3 * j], xj1 = X[3 * j + 1], xj2 = X[3 * j + 2];
        // rounded op by op, as the plain version computes it: d2 is the
        // same float on both sides, whatever the compiler would contract
        const float gram =
            __fadd_rn(__fadd_rn(__fmul_rn(xi0, xj0), __fmul_rn(xi1, xj1)), __fmul_rn(xi2, xj2));
        const float raw = __fsub_rn(__fadd_rn(sqi, sq[j]), 2.0f * gram);
        const float d2 = fmaxf(raw, 1e-12f);
        const float half_log = 0.5f * logf(d2);
        const float w = op.W[row + j];
        const float r = half_log - op.logD[row + j];
        loss += w * r * r;
        const float rt = half_log - op.logDt[row + j];
        const float h = raw > 1e-12f ? (w * r + op.Wt[row + j] * rt) / d2 : 0.0f;
        f0 += h * (xi0 - xj0);
        f1 += h * (xi1 - xj1);
        f2 += h * (xi2 - xj2);
      }
      f0 = gram_warp_sum(f0);
      f1 = gram_warp_sum(f1);
      f2 = gram_warp_sum(f2);
      if (lane == 0) {
        gX[3 * i] = f0;
        gX[3 * i + 1] = f1;
        gX[3 * i + 2] = f2;
      }
    }
    loss = gram_warp_sum(loss);
    if (lane == 0) red[warp] = loss;
    __syncthreads();

    if (warp == 0) {
      float total = 0.0f;
      for (int w = 0; w < n_warps; ++w) total += red[w];
      const float prec = expf(u);
      float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
      for (int i = lane; i < n; i += 32) {
        m0 += X[3 * i];
        m1 += X[3 * i + 1];
        m2 += X[3 * i + 2];
      }
      m0 = gram_warp_sum(m0) / (float)n;
      m1 = gram_warp_sum(m1) / (float)n;
      m2 = gram_warp_sum(m2) / (float)n;
      float springs = 0.0f;
      for (int i = lane; i < n; i += 32) {
        float g0 = prec * gX[3 * i] + op.k_center * m0;
        float g1 = prec * gX[3 * i + 1] + op.k_center * m1;
        float g2 = prec * gX[3 * i + 2] + op.k_center * m2;
        if (i > 0) {  // segment (i - 1, i) pulls bead i
          const float s0 = X[3 * i] - X[3 * i - 3], s1 = X[3 * i + 1] - X[3 * i - 2],
                      s2 = X[3 * i + 2] - X[3 * i - 1];
          const float ss = s0 * s0 + s1 * s1 + s2 * s2;
          const float d = sqrtf(fmaxf(ss, 1e-12f));
          const float c = ss > 1e-12f ? op.k_spring * (d - op.d0) / d : 0.0f;
          g0 += c * s0;
          g1 += c * s1;
          g2 += c * s2;
        }
        if (i + 1 < n) {  // segment (i, i + 1): its energy, and its pull on bead i
          const float s0 = X[3 * i + 3] - X[3 * i], s1 = X[3 * i + 4] - X[3 * i + 1],
                      s2 = X[3 * i + 5] - X[3 * i + 2];
          const float ss = s0 * s0 + s1 * s1 + s2 * s2;
          const float d = sqrtf(fmaxf(ss, 1e-12f));
          const float c = ss > 1e-12f ? op.k_spring * (d - op.d0) / d : 0.0f;
          g0 -= c * s0;
          g1 -= c * s1;
          g2 -= c * s2;
          springs += (d - op.d0) * (d - op.d0);
        }
        gX[3 * i] = g0;
        gX[3 * i + 1] = g1;
        gX[3 * i + 2] = g2;
      }
      springs = gram_warp_sum(springs);
      const float restraint = -0.5f * prec * total + 0.5f * op.k_obs * u;
      const float backbone = -0.5f * op.k_spring * springs;
      const float center = -0.5f * op.k_center * (m0 * m0 + m1 * m1 + m2 * m2) * (float)n;
      const float gamma = (op.gamma_shape - 1.0f) * u - op.gamma_rate * prec + u;
      if (lane == 0) {
        g[0] = 0.5f * prec * total - 0.5f * op.k_obs - op.gamma_shape + op.gamma_rate * prec;
        red[kGramWarps] = -(restraint + backbone + center + gamma);
      }
    }
    __syncthreads();
    return red[kGramWarps];
  }
};

}  // namespace binf
