// K5's kernel template (fused_gibbs.cu describes the design): a group of
// G lanes a chain, instantiated per coefficient count DC and G by the
// fused_gibbs.g<G>.cu units.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kK5Threads = 128;
constexpr int kK5Partials = 8;  // partial j of the residual sum: rows i = j (mod 8)
constexpr int kK5MaxRowsPerPartial = 3;  // register rows: n <= 24 (the polynomial's 20)

struct GibbsArgs {
  const float* V;    // (n, DC) row-major
  const float* y;    // (n,)
  const float* vtv;  // (DC, DC) V^T V
  const float* vty;  // (DC,) V^T y
  const float* ipv;  // (DC,) 1 / prior variance
  const float* pm;   // (DC,) prior mean
  int n;
  float gamma_d;  // Marsaglia-Tsang d = a + n/2 - 1/3
  float gamma_c;  // 1 / sqrt(9 d)
  float rate;     // Gamma rate b
  const float* q0;  // (C, DC + 1)
  int n_chains, num_steps;
  uint64_t seed;
  const float* gz;  // staged (steps, 8, C) each, or null: Philox
  const float* gu;
  const float* cz;
  float* draws;  // (steps, C, DC + 1)
};

// Shared memory of a CTA: V, y, V^T V, V^T y, 1/v0, mu0
__host__ __device__ constexpr int gibbs_smem_floats(int n, int dc) {
  return n * (dc + 1) + dc * dc + 3 * dc;
}

// The noise of one sweep staged in the JAX host-noise layout, (steps, 8,
// C) each, with group_gibbs_noise's interface: every lane of the group
// reads the same addresses; rounds 1-3 are read only when needed.
template <int DC, int G>
struct StagedGibbsNoise {
  const float *gz_, *gu_, *cz_;
  int64_t n_chains, c, last;
  uint32_t sweep;
  float gz0, gu0, czs[DC];

  __device__ StagedGibbsNoise(const GibbsArgs& args, int c_, unsigned)
      : gz_(args.gz), gu_(args.gu), cz_(args.cz), n_chains(args.n_chains), c(c_),
        last(args.num_steps - 1) {}

  __device__ __forceinline__ float at(const float* a, int row) const {
    return a[((int64_t)min((int64_t)sweep, last) * 8 + row) * n_chains + c];
  }
  __device__ __forceinline__ void draw(uint64_t, uint32_t s) {
    sweep = s;
    gz0 = at(gz_, 0);
    gu0 = at(gu_, 0);
#pragma unroll
    for (int k = 0; k < DC; ++k) czs[k] = at(cz_, k);
  }
  __device__ __forceinline__ void values(SweepNoise<DC>& out) const {
    out.gz0 = gz0;
    out.gu0 = gu0;
#pragma unroll
    for (int k = 0; k < DC; ++k) out.cz[k] = czs[k];
  }
  __device__ __forceinline__ float gz1() const { return at(gz_, 1); }
  __device__ __forceinline__ float gu(int r) const { return at(gu_, r); }
  __device__ __forceinline__ void slot1(uint64_t, float& z2, float& z3) const {
    z2 = at(gz_, 2);
    z3 = at(gz_, 3);
  }
};

// One Marsaglia-Tsang round (fused_gibbs.py::_gamma_draw): writes d v and
// returns whether the round accepts.  Both logs are taken, so the
// decision is branch-free.
__device__ __forceinline__ bool gamma_round(float d, float c, float x, float u, float& out) {
  const float t = 1.0f + c * x;
  const float v = t * t * t;
  const float logv = logf(fmaxf(v, 1e-20f));
  out = d * v;
  return (v > 0.0f) & (logf(fmaxf(u, 1e-30f)) < 0.5f * x * x + d - d * v + d * logv);
}

// Rounds 1-3 of the sweep `noise` holds, for a group whose round 0
// rejected (its lanes take this together): the first accepted round's
// d v, else the reference's fallback d.
template <class Noise>
__device__ float later_rounds(const Noise& noise, uint64_t seed, float d, float c) {
  float out;
  if (gamma_round(d, c, noise.gz1(), noise.gu(1), out)) return out;
  float z2, z3;
  noise.slot1(seed, z2, z3);
  const float u2 = noise.gu(2), u3 = noise.gu(3);
  if (gamma_round(d, c, z2, u2, out)) return out;
  if (gamma_round(d, c, z3, u3, out)) return out;
  return d;
}

// The rows of V and y that lane `lane` of a group adds: partials j = lane
// + p G (p < P = 8 / G), partial j over rows j, j + 8, j + 16, ...; the
// first RPP rows of each partial in registers (zeros past n, which add
// exactly nothing), the rest read from shared memory.
template <int DC, int G>
struct GibbsRows {
  static constexpr int P = kK5Partials / G;
  static constexpr int kFit = kLaneFloats / ((DC + 1) * P);
  static constexpr int RPP =
      kFit < 1 ? 1 : (kFit > kK5MaxRowsPerPartial ? kK5MaxRowsPerPartial : kFit);
  float rv[P][RPP][DC], ry[P][RPP];
  const float *V, *y;
  int n, lane, rpp;

  static __host__ __device__ constexpr bool in_registers(int n) {
    return n <= kK5Partials * RPP;
  }

  __device__ GibbsRows(const float* sV, const float* sy, int n_, int lane_)
      : V(sV), y(sy), n(n_), lane(lane_) {
    const int per = (n + kK5Partials - 1) / kK5Partials;
    rpp = per < RPP ? per : RPP;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int m = 0; m < RPP; ++m) {
        const int i = lane + p * G + m * kK5Partials;
        const bool here = i < n;
#pragma unroll
        for (int k = 0; k < DC; ++k) rv[p][m][k] = here ? V[i * DC + k] : 0.0f;
        ry[p][m] = here ? y[i] : 0.0f;
      }
    }
  }

  // one row's squared residual added to a partial, rounded op by op
  static __device__ __forceinline__ float add_row(const float* v, float yi,
                                                  const float (&c)[DC], float part) {
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < DC; ++k) r = fmaf(v[k], c[k], r);
    r = __fsub_rn(r, yi);
    return fmaf(r, r, part);
  }

  // ||V c - y||^2 in one fixed order, the same bits at every G: the 8
  // partials, then a tree that adds partials j and j ^ 4, then j ^ 2, then
  // j ^ 1; a lane's own levels first, group_sum's butterfly the rest.
  __device__ __forceinline__ float ss(const float (&c)[DC], unsigned mask) const {
    float part[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      part[p] = 0.0f;
#pragma unroll
      for (int m = 0; m < RPP; ++m)
        if (m < rpp) part[p] = add_row(rv[p][m], ry[p][m], c, part[p]);
      for (int i = lane + p * G + RPP * kK5Partials; i < n; i += kK5Partials)
        part[p] = add_row(V + i * DC, y[i], c, part[p]);
    }
#pragma unroll
    for (int h = P / 2; h > 0; h /= 2) {
#pragma unroll
      for (int p = 0; p < h; ++p) part[p] = __fadd_rn(part[p], part[p + h]);
    }
    return group_sum<G>(part[0], mask);
  }
};

// 3-5: P = lam V^T V + diag(1/v0) = L L^T (diagonal floored at 1e-20),
// P mean = lam V^T y + mu0/v0 by two triangular solves, c = mean + L^-T z,
// in the order of fused_gibbs.py:130-170, but for the divisions by L_kk:
// 1 / L_kk comes from one reciprocal square root, and every division by
// L_kk is a multiplication by it (IEEE sqrtf and / took the kernel 60%
// longer at the gibbs path's shape).
template <int DC>
__device__ __forceinline__ void coefficient_draw(float lam, const float* vtv, const float* vty,
                                                 const float* ipv, const float* pm,
                                                 const float (&cz)[DC], float (&coef)[DC]) {
  float L[DC][DC], inv[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      float acc = lam * vtv[i * DC + k];
      if (i == k) acc += ipv[i];
#pragma unroll
      for (int m = 0; m < k; ++m) acc -= L[i][m] * L[k][m];
      if (i == k)
        inv[i] = rsqrtf(fmaxf(acc, 1e-20f));
      else
        L[i][k] = acc * inv[k];
    }
  }
  float w[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    float acc = lam * vty[i] + pm[i] * ipv[i];
#pragma unroll
    for (int m = 0; m < i; ++m) acc -= L[i][m] * w[m];
    w[i] = acc * inv[i];
  }
  float mean[DC], x[DC];
#pragma unroll
  for (int i = DC - 1; i >= 0; --i) {
    float am = w[i], az = cz[i];
#pragma unroll
    for (int m = i + 1; m < DC; ++m) {
      am -= L[m][i] * mean[m];
      az -= L[m][i] * x[m];
    }
    mean[i] = am * inv[i];
    x[i] = az * inv[i];
  }
#pragma unroll
  for (int k = 0; k < DC; ++k) coef[k] = mean[k] + x[k];
}

// The group's draw of one sweep into out (DC + 1 floats): lane r writes
// entries r, r + G, ...; the warp's chains are consecutive, so each store
// instruction of the warp falls in one contiguous run of (32 / G) (DC + 1)
// floats.
template <int DC, int G>
__device__ __forceinline__ void store_draw(float* out, int lane, const float (&coef)[DC],
                                           float lam) {
#pragma unroll
  for (int j = 0; j < (DC + G) / G; ++j) {
    const int k = lane + j * G;
    float v = lam;
#pragma unroll
    for (int t = 0; t < DC; ++t) v = k == t ? coef[t] : v;
    if (k <= DC) out[k] = v;
  }
}

template <int DC, int G, class Noise>
__global__ void __launch_bounds__(kK5Threads, 4) fused_linreg_gibbs_kernel(GibbsArgs a) {
  constexpr int D = DC + 1;
  extern __shared__ float smem[];
  float* sV = smem;
  float* sy = sV + a.n * DC;
  float* svtv = sy + a.n;
  float* svty = svtv + DC * DC;
  float* sipv = svty + DC;
  float* spm = sipv + DC;
  for (int i = threadIdx.x; i < a.n * DC; i += blockDim.x) sV[i] = a.V[i];
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) sy[i] = a.y[i];
  for (int i = threadIdx.x; i < DC * DC; i += blockDim.x) svtv[i] = a.vtv[i];
  for (int i = threadIdx.x; i < DC; i += blockDim.x) {
    svty[i] = a.vty[i];
    sipv[i] = a.ipv[i];
    spm[i] = a.pm[i];
  }
  __syncthreads();

  // a group's lanes share its chain; a group past the last chain leaves
  // whole, and nothing below waits for the CTA
  const int c = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (c >= a.n_chains) return;
  const int lane = (int)(threadIdx.x & (G - 1));
  const unsigned mask = group_mask<G>();
  const GibbsRows<DC, G> rows(sV, sy, a.n, lane);
  Noise noise(a, c, mask);
  float coef[DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) coef[k] = a.q0[(int64_t)c * D + k];

  // The noise and round 0 of the Gamma draw depend on no state: sweep
  // s + 1's are made in sweep s's iteration, beside its dependent chain.
  SweepNoise<DC> cur, nxt;
  noise.draw(a.seed, 0u);
  noise.values(cur);
  cur.acc0 = gamma_round(a.gamma_d, a.gamma_c, cur.gz0, cur.gu0, cur.g0);
  for (int s = 0; s < a.num_steps; ++s) {
    // 1-2: lambda = Gamma(a + n/2, 1) / (b + SS/2), the first accepted
    // round's draw; rounds 1-3 run only after round 0 rejects (~0.27%)
    const float gam = cur.acc0 ? cur.g0 : later_rounds(noise, a.seed, a.gamma_d, a.gamma_c);
    noise.draw(a.seed, (uint32_t)s + 1u);
    noise.values(nxt);
    nxt.acc0 = gamma_round(a.gamma_d, a.gamma_c, nxt.gz0, nxt.gu0, nxt.g0);
    const float lam = gam / (a.rate + 0.5f * rows.ss(coef, mask));
    coefficient_draw<DC>(lam, svtv, svty, sipv, spm, cur.cz, coef);
    store_draw<DC, G>(a.draws + ((int64_t)s * a.n_chains + c) * D, lane, coef, lam);
    cur = nxt;
  }
}

template <int DC, int G>
cudaError_t launch_gibbs(const GibbsArgs& a, cudaStream_t stream, int* grid) {
  const size_t smem = gibbs_smem_floats(a.n, DC) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int ctas = (int)(((int64_t)a.n_chains * G + kK5Threads - 1) / kK5Threads);
  grid[0] = ctas;
  grid[1] = kK5Threads;
  grid[2] = GibbsRows<DC, G>::in_registers(a.n);
  if (a.gz != nullptr)
    fused_linreg_gibbs_kernel<DC, G, StagedGibbsNoise<DC, G>>
        <<<ctas, kK5Threads, smem, stream>>>(a);
  else
    fused_linreg_gibbs_kernel<DC, G, GroupGibbsNoise<DC, G>>
        <<<ctas, kK5Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// explicit instances for one G, DC = 1..7 (the fused_gibbs.g<G>.cu units)
#define BINF_K5_INSTANCE(DC, G) \
  template cudaError_t launch_gibbs<DC, G>(const GibbsArgs&, cudaStream_t, int*);
#define BINF_K5(G)        \
  BINF_K5_INSTANCE(1, G)  \
  BINF_K5_INSTANCE(2, G)  \
  BINF_K5_INSTANCE(3, G)  \
  BINF_K5_INSTANCE(4, G)  \
  BINF_K5_INSTANCE(5, G)  \
  BINF_K5_INSTANCE(6, G)  \
  BINF_K5_INSTANCE(7, G)

}  // namespace binf
