// The Gram-form chromatin density as a functor of a group of warps: the
// density of binf_tpu/example/chromatin.py::make_gram_logdensity that the
// chain-grid kernel (chain_grid.cu) runs, one chain per group.
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
// value_and_grad: with the matrices staged and one warp a chain (the
// kernel's geometry while chains fill the card), each unordered pair once
// (pairs_once: d2, its log and the force coefficient are symmetric, and
// the force on the partner bead goes to its lane by shuffle).  Otherwise
// thread t of the chain's group of G warps owns beads t, t + 32 G, ...; it
// walks every j for two of them at once (two independent pairs an
// iteration), reading W_ij as Wt[j][i], W_ji as W[j][i] and logD the same
// way, so a warp's 32 lanes read 32 consecutive words (whole lines from
// device memory), and x_j as a broadcast of the chain's (x, |x|^2) scratch.  A thread adds its beads'
// forces in registers, with the springs and the centring pull of its own
// beads; the loss, the springs' energy and the mean are xor-butterfly warp
// sums, then the G warps' partials added in warp order, so every thread
// ends with the same bits of U, and every call gives the same bits.  A
// group of one warp synchronises with __syncwarp; a larger one at its own
// named barrier.  The CTA's groups share only the staged matrices.
#pragma once

#include <stdint.h>

#include "chain_group.cuh"

namespace binf {

// Filled through ctypes by binf_tpu_torch/ops/kernels/chain_grid.py.
struct GramOperands {
  const float* W;      // (N, N)
  const float* logD;   // (N, N)
  const float* Wt;     // W^T, contiguous
  const float* logDt;  // logD^T, contiguous
  int n;
  int resident;  // the four matrices are staged in shared memory (set by the launch)
  float k_obs, gamma_shape, gamma_rate, d0, k_spring, k_center;
};

// Entry o of staged matrix m (0 W, 1 logD, 2 Wt, 3 logDt; stage() puts them
// at the start of the block's dynamic shared memory, N^2 floats each) or,
// when they are not resident, of the matrix in device memory.  Indexing the
// shared array itself keeps the loads LDS with 32-bit addresses.
template <bool Resident>
__device__ __forceinline__ float gram_load(const float* global, int m, int nn, int o) {
  if constexpr (Resident) {
    extern __shared__ __align__(16) float gram_staged[];
    return gram_staged[m * nn + o];
  } else {
    return __ldg(global + o);
  }
}

struct GramDensity {
  GramOperands op;

  // floats of the staged matrices in a CTA's shared memory
  static __host__ __device__ int64_t matrix_floats(int n, int resident) {
    return resident ? 4 * (int64_t)n * n : 0;
  }
  // floats of a chain's scratch: (x, |x|^2) per bead, then the group sums'
  // partials (8 warps, the widest group)
  static __host__ __device__ int64_t scratch_floats(int n) { return 4 * (int64_t)n + 8; }

  // Called by every thread of the CTA, followed by a __syncthreads(): the
  // matrices into the start of the block's shared memory m when resident.
  __device__ void stage(const GramOperands& o, float* m) {
    op = o;
    if (o.resident) {
      const int nn = o.n * o.n;
      for (int k = threadIdx.x; k < nn; k += blockDim.x) {
        m[k] = o.W[k];
        m[nn + k] = o.logD[k];
        m[2 * nn + k] = o.Wt[k];
        m[3 * nn + k] = o.logDt[k];
      }
    }
  }

  // |x_i - x_j|^2 in the Gram form, rounded op by op as the plain version
  // forms it (the same float), before the floor
  static __device__ __forceinline__ float gram_d2(const float4& xi, const float4& xj) {
    const float gram =
        __fadd_rn(__fadd_rn(__fmul_rn(xi.x, xj.x), __fmul_rn(xi.y, xj.y)), __fmul_rn(xi.z, xj.z));
    return __fsub_rn(__fadd_rn(xi.w, xj.w), 2.0f * gram);
  }

  // One ordered pair (i, j) into bead i's loss and force: W_ij at Wt[j][i],
  // W_ji at W[j][i], logD likewise (o = j N + i).
  template <bool Resident>
  __device__ __forceinline__ void pair(const float4& xi, const float4& xj, int o, float& loss,
                                       float& f0, float& f1, float& f2) const {
    const int nn = op.n * op.n;
    const float raw = gram_d2(xi, xj);
    const float d2 = fmaxf(raw, 1e-12f);
    const float half_log = 0.5f * logf(d2);
    const float w = gram_load<Resident>(op.Wt, 2, nn, o);
    const float r = half_log - gram_load<Resident>(op.logDt, 3, nn, o);
    loss += w * r * r;
    const float rt = half_log - gram_load<Resident>(op.logD, 1, nn, o);
    // __fdividef (within 2 ulp): IEEE division's slow-path branch would
    // split the unrolled pairs into blocks the scheduler cannot overlap
    const float h =
        raw > 1e-12f ? __fdividef(w * r + gram_load<Resident>(op.W, 0, nn, o) * rt, d2) : 0.0f;
    f0 += h * (xi.x - xj.x);
    f1 += h * (xi.y - xj.y);
    f2 += h * (xi.z - xj.z);
  }

  // The pairs' loss and forces with the matrices staged and one warp a
  // chain: each unordered pair once.  Beads fall in tiles of 32, bead 32 I +
  // l owned by lane l.  For tiles I <= J lane l pairs its bead i = 32 I + l
  // with j = 32 J + ((l + k) & 31): k = 0..31 when I < J; when I = J, k =
  // 0 (the bead itself) to 16, k = 16 on lanes 0..15 only, so each pair
  // comes once.  The pair's force on j goes to j's lane, l + k, by one
  // shuffle a component.  Forces accumulate in g (1 + 3 b), each bead's in
  // its own lane in a fixed order; returns the lane's share of the loss.
  // Matrix reads: entry j N + i, lanes l + k apart in j and l in i, without
  // bank conflicts for even N.
  __device__ float pairs_once(const float4* X, float* g) const {
    extern __shared__ __align__(16) float gram_staged[];
    const int n = op.n, nn = n * n, lane = threadIdx.x & 31, tiles = (n + 31) / 32;
    for (int b = lane; b < n; b += 32) {
      g[1 + 3 * b] = 0.0f;
      g[2 + 3 * b] = 0.0f;
      g[3 + 3 * b] = 0.0f;
    }
    float loss = 0.0f;
    for (int I = 0; I < tiles; ++I) {
      const int i = 32 * I + lane;
      const bool vi = i < n;
      const int ic = vi ? i : n - 1;
      const float4 xi = X[ic];
      float fi0 = 0.0f, fi1 = 0.0f, fi2 = 0.0f;
      for (int J = I; J < tiles; ++J) {
        float fj0 = 0.0f, fj1 = 0.0f, fj2 = 0.0f;
        const int ks = J == I ? 17 : 32;
#pragma unroll 4
        for (int k = 0; k < ks; ++k) {
          const int j = 32 * J + ((lane + k) & 31);
          const bool on = vi && j < n && (J > I || k < 16 || lane < 16);
          const int jc = j < n ? j : n - 1;
          const float4 xj = X[jc];
          const int o = jc * n + ic;
          const float raw = gram_d2(xi, xj);
          const float d2 = fmaxf(raw, 1e-12f);
          const float half_log = 0.5f * logf(d2);
          const float w = gram_staged[2 * nn + o];                  // W_ij
          const float r = half_log - gram_staged[3 * nn + o];       // logD_ij
          const float wt = gram_staged[o];                          // W_ji
          const float rt = half_log - gram_staged[nn + o];          // logD_ji
          const float self = J == I && k == 0 ? 0.0f : 1.0f;         // i = j: one order
          loss += on ? w * r * r + self * (wt * rt * rt) : 0.0f;
          const float h = on && raw > 1e-12f ? __fdividef(w * r + wt * rt, d2) : 0.0f;
          const float d0 = xi.x - xj.x, d1 = xi.y - xj.y, dd2 = xi.z - xj.z;
          fi0 += h * d0;
          fi1 += h * d1;
          fi2 += h * dd2;
          // the force on my tile-J bead, from the lane that paired with it
          const int from = (lane - k) & 31;
          fj0 += __shfl_sync(0xFFFFFFFFu, -h * d0, from);
          fj1 += __shfl_sync(0xFFFFFFFFu, -h * d1, from);
          fj2 += __shfl_sync(0xFFFFFFFFu, -h * dd2, from);
        }
        const int b = 32 * J + lane;
        if (b < n) {
          g[1 + 3 * b] += fj0;
          g[2 + 3 * b] += fj1;
          g[3 + 3 * b] += fj2;
        }
      }
      if (vi) {
        g[1 + 3 * i] += fi0;
        g[2 + 3 * i] += fi1;
        g[3 + 3 * i] += fi2;
      }
    }
    return loss;
  }

  // grad U of bead i into g from its pair forces f: the precision, the
  // centring pull and both springs; returns its segment (i, i + 1)'s
  // (d - d0)^2
  __device__ __forceinline__ float bead_grad(const float4* X, int i, const float4& xi, float f0,
                                             float f1, float f2, float prec, float m0, float m1,
                                             float m2, float* g) const {
    const int n = op.n;
    float g0 = prec * f0 + op.k_center * m0;
    float g1 = prec * f1 + op.k_center * m1;
    float g2 = prec * f2 + op.k_center * m2;
    float spring = 0.0f;
    if (i > 0) {  // segment (i - 1, i) pulls bead i
      const float4 xp = X[i - 1];
      const float s0 = xi.x - xp.x, s1 = xi.y - xp.y, s2 = xi.z - xp.z;
      const float ss = s0 * s0 + s1 * s1 + s2 * s2;
      const float d = sqrtf(fmaxf(ss, 1e-12f));
      const float c = ss > 1e-12f ? op.k_spring * (d - op.d0) / d : 0.0f;
      g0 += c * s0;
      g1 += c * s1;
      g2 += c * s2;
    }
    if (i + 1 < n) {  // segment (i, i + 1): its energy, and its pull on bead i
      const float4 xn = X[i + 1];
      const float s0 = xn.x - xi.x, s1 = xn.y - xi.y, s2 = xn.z - xi.z;
      const float ss = s0 * s0 + s1 * s1 + s2 * s2;
      const float d = sqrtf(fmaxf(ss, 1e-12f));
      const float c = ss > 1e-12f ? op.k_spring * (d - op.d0) / d : 0.0f;
      g0 -= c * s0;
      g1 -= c * s1;
      g2 -= c * s2;
      spring = (d - op.d0) * (d - op.d0);
    }
    g[1 + 3 * i] = g0;
    g[2 + 3 * i] = g1;
    g[3 + 3 * i] = g2;
    return spring;
  }

  // U(q), the same in every thread, and grad U into g; q and g flat (1 +
  // 3N) and X the chain's scratch, all in shared memory.  Every thread of
  // the chain's group calls it; it ends with the group synchronised.
  template <bool Resident>
  __device__ float value_and_grad(const float* q, float* g, float4* X, const ChainGroup& grp) const {
    const int n = op.n;
    float* red = reinterpret_cast<float*>(X + n);
    const float u = q[0];
    const float* Xq = q + 1;
    float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
    for (int i = grp.r; i < n; i += grp.T) {
      const float x0 = Xq[3 * i], x1 = Xq[3 * i + 1], x2 = Xq[3 * i + 2];
      // rounded op by op, as the plain version computes it
      X[i] = make_float4(x0, x1, x2,
                         __fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)),
                                   __fmul_rn(x2, x2)));
      m0 += x0;
      m1 += x1;
      m2 += x2;
    }
    // the group sums also order the scratch's writes before its reads
    m0 = grp.sum(m0, red) / (float)n;
    m1 = grp.sum(m1, red) / (float)n;
    m2 = grp.sum(m2, red) / (float)n;
    grp.sync();
    const float prec = expf(u);
    float loss = 0.0f, springs = 0.0f;
    if constexpr (Resident) {
      if (grp.T == 32) {
        loss = pairs_once(X, g);
        for (int i = grp.r; i < n; i += 32)
          springs += bead_grad(X, i, X[i], g[1 + 3 * i], g[2 + 3 * i], g[3 + 3 * i], prec, m0,
                               m1, m2, g);
      }
    }
    // otherwise each ordered pair, two beads a pass, i and i + T, for two
    // independent pairs an iteration
    for (int i0 = (Resident && grp.T == 32) ? n : grp.r; i0 < n; i0 += 2 * grp.T) {
      const bool two = i0 + grp.T < n;
      const int i1 = two ? i0 + grp.T : i0;  // one bead: the second pair repeats the first
      const float4 xa = X[i0], xb = X[i1];
      float fa0 = 0.0f, fa1 = 0.0f, fa2 = 0.0f, fb0 = 0.0f, fb1 = 0.0f, fb2 = 0.0f;
      float la = 0.0f, lb = 0.0f;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const float4 xj = X[j];
        const int o = j * n;
        pair<Resident>(xa, xj, o + i0, la, fa0, fa1, fa2);
        pair<Resident>(xb, xj, o + i1, lb, fb0, fb1, fb2);
      }
      loss += two ? la + lb : la;
      springs += bead_grad(X, i0, xa, fa0, fa1, fa2, prec, m0, m1, m2, g);
      if (two) springs += bead_grad(X, i1, xb, fb0, fb1, fb2, prec, m0, m1, m2, g);
    }
    const float total = grp.sum(loss, red);
    springs = grp.sum(springs, red);
    const float restraint = -0.5f * prec * total + 0.5f * op.k_obs * u;
    const float backbone = -0.5f * op.k_spring * springs;
    const float center = -0.5f * op.k_center * (m0 * m0 + m1 * m1 + m2 * m2) * (float)n;
    const float gamma = (op.gamma_shape - 1.0f) * u - op.gamma_rate * prec + u;
    if (grp.r == 0)
      g[0] = 0.5f * prec * total - 0.5f * op.k_obs - op.gamma_shape + op.gamma_rate * prec;
    grp.sync();
    return -(restraint + backbone + center + gamma);
  }
};

}  // namespace binf
