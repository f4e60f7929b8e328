// Lane groups: G consecutive lanes of a warp share one chain (G in 1, 2,
// 4, 8), for the whole-run kernels K3 (fused_warmup.cu), K4
// (fused_potential.cu) and K5 (fused_gibbs.cu).
//
// One thread per chain leaves an SM with about four warps at 16,384
// chains, too few to hide the latency of a density evaluation's chain of
// dependent FMAs and shared-memory loads.  A group splits the data rows of
// the linear-regression density across its lanes: lane r takes rows r,
// r + G, r + 2G, ..., the first kRegRows of them held in registers (all of
// them at the G the wrappers pick, so the row loop unrolls with no test),
// the rest read from shared memory, and a fixed xor butterfly inside the group
// adds the partial residual sum of squares and gradient, so every lane
// ends with the same bits of U and grad U.  Every lane keeps the chain's
// q, p and grad U, so the drift and kick need no communication and a
// trajectory runs on a Lanes functor as on a one-thread one.  The diagonal
// Gaussian has no data axis and keeps G = 1.  The AR(1) functor's T steps
// are one affine recurrence: a group scans it (Lanes<AR1Density, G>).
//
// The logistic and mixture functors split their rows (points) the same
// way, at G = 1 too (one lane then takes every row in order).  Their rows
// are latency chains of transcendentals (the logistic's expf, log1pf and
// division, the mixture's three expf, logf and division), so a lane keeps several rows in flight: its register rows
// unrolled in full, its shared-memory rows kRowUnroll at a time, each
// row's own operations in the functor's order and each lane's sums in row
// order; the butterfly then adds the D + 1 (logistic) or 2 K + 2 (mixture)
// partials.  The prior, and the mixture's sort and weights, follow once
// per lane.  A gradient alone skips the softplus's log1pf and the
// log-sum-exp's logf.  The hierarchical posterior's lanes own whole groups
// (at G = 4, the width scripts/family_lanes.py's sweep chose, two groups
// of 15 rows each), so only two sums cross lanes.
//
// group_step_noise spreads the Philox calls of one step over the group's
// lanes and broadcasts their normals by shuffle; the counters (chain,
// step, slot, tag) are those of step_noise, so the bits are too.
// GroupGibbsNoise does the same for a collapsed-Gibbs sweep (gibbs_noise).
//
// lane_trajectory is the trajectory of these kernels: the
// intermediate evaluations skip U, and with a diagonal metric every
// update, like the linear regression's closed form after the row sums, is
// rounded operation by operation in the plain version's order
// (__fmul_rn, __fadd_rn: no contraction into FMAs), so that kernel and
// plain version part only by the sums' order and the library functions.
#pragma once

#include <stdint.h>

#include "ar1_density.cuh"
#include "diag_gaussian_density.cuh"
#include "hierarchical_density.cuh"
#include "linreg_density.cuh"
#include "logistic_density.cuh"
#include "mixture_density.cuh"
#include "philox.cuh"

namespace binf {

constexpr int kLaneFloats = 50;  // register budget of a lane's data rows
// The logistic's and mixture's: their rows are read once an evaluation
// between transcendentals, and registers buy these branches more in
// occupancy (LaneOccupancy) than in loads
constexpr int kFamilyLaneFloats = 16;
constexpr int kGroupRows = 256;  // rows a lane group of the logistic or mixture sizes its registers for
constexpr int kRowUnroll = 4;    // shared-memory rows a lane has in flight

// Register rows of a lane of G whose rows take F floats: what
// kFamilyLaneFloats holds, and no more than its share of kGroupRows rows.
template <int F, int G>
__host__ __device__ constexpr int reg_rows() {
  return kFamilyLaneFloats / F < (kGroupRows + G - 1) / G ? kFamilyLaneFloats / F
                                                           : (kGroupRows + G - 1) / G;
}

// Lanes of the group holding this thread, as a shuffle mask (G <= 32, a
// power of two; groups start at multiples of G within the warp).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xFFFFFFFFu;
  } else {
    const int base = (threadIdx.x & 31) & ~(G - 1);
    return ((1u << G) - 1u) << base;
  }
}

// Sum over the G lanes of a group by a fixed xor butterfly.  Float
// addition commutes, so every lane ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

// CTAs an SM K3 and K4 ask the compiler to fit (__launch_bounds__'
// second argument, which caps the registers a thread): the lane-group
// branches of the logistic, AR(1) and mixture take 2 CTAs of K3 (128
// registers, so that the card holds 8,192 chains' groups of 8 in one
// round) and 4 of K4 (16 warps an SM); every other branch, their one-lane
// ones included, leaves the registers to the compiler.
template <class Density, int G>
struct LaneOccupancy {
  static constexpr int k3 = 1, k4 = 1;
};

template <class Density, int G>
struct FamilyOccupancy {
  static constexpr int k3 = G > 1 ? 2 : 1, k4 = G > 1 ? 4 : 1;
};

// A density functor evaluated by a group of G lanes; specialised per
// family below.  Constructed in the kernel after the functor's stage()
// and the block's __syncthreads().
template <class Density, int G>
struct Lanes;

// One lane a chain: the functor's own evaluation (its gradient alone costs
// the same as with the value); the diagonal Gaussian's.
template <class Density>
struct OneLane {
  static constexpr int D = Density::D;
  Density dens;

  __device__ explicit OneLane(const Density& d) : dens(d) {}
  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    return dens.value_and_grad(q, g);
  }
  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    dens.value_and_grad(q, g);
  }
};

template <int DD, int G>
struct LaneOccupancy<LogisticDensity<DD>, G> : FamilyOccupancy<LogisticDensity<DD>, G> {};
template <int G>
struct LaneOccupancy<AR1Density, G> : FamilyOccupancy<AR1Density, G> {};
template <int K, int G>
struct LaneOccupancy<MixtureDensity<K>, G> : FamilyOccupancy<MixtureDensity<K>, G> {};

// The hierarchical posterior at D = 21: q, p, grad U, the proposal, the
// metric and K3's ChEES copies hold ~170 live floats a lane, so its
// branches leave the registers to the compiler: ptxas gives K3 254-255
// registers (one CTA an SM) and K4's diagonal branch 221-245 (two CTAs an
// SM) with no spills at every width of the sweep; chip_smoke.py's
// hierarchical path reads them from the build's ptxas logs.
template <int NG, int G>
struct LaneOccupancy<HierarchicalDensity<NG>, G> {
  static constexpr int k3 = 1, k4 = 1;
};

template <int DD>
struct Lanes<DiagGaussianDensity<DD>, 1> : OneLane<DiagGaussianDensity<DD>> {
  using OneLane<DiagGaussianDensity<DD>>::OneLane;
};

// AR(1) at G lanes a chain: lane r takes the contiguous steps [s0, s1) of
// the recurrence, s0 = r ceil(T / G).  Its segment maps a state by
// (a, a', S, S') = (phi^L, d phi^L / d phi, sum_{j<L} phi^j, its d / d phi):
// x -> a x + drift S, t_phi -> a' x + a t_phi + drift S', t_drift -> a
// t_drift + S, t_x0 -> a t_x0.  Each lane builds its map (L steps), an
// inclusive shuffle scan composes the maps up the group (log2 G rounds),
// a shift makes it exclusive, and the prefix applied to the start (x0, 0,
// 0, 1) is the lane's state at s0; the lane then runs its L steps and the
// butterfly adds the four sums.  2 ceil(T / G) serial steps a lane, not T;
// at G = 1 the one segment starts at the start, and T steps.
template <int G>
struct Lanes<AR1Density, G> {
  using Dens = AR1Density;
  static constexpr int D = Dens::D;
  Dens dens;  // points into shared memory after stage()
  int lane, s0, s1;
  unsigned mask;

  __device__ explicit Lanes(const Dens& d)
      : dens(d), lane((int)(threadIdx.x & (G - 1))), mask(group_mask<G>()) {
    const int seg = (d.n + G - 1) / G;
    s0 = lane * seg < d.n ? lane * seg : d.n;
    s1 = s0 + seg < d.n ? s0 + seg : d.n;
  }

  // The state at s0: the prefix of the segments before this lane's,
  // applied to the start (x0, 0, 0, 1).
  __device__ __forceinline__ Dens::State segment_start(float phi, float drift, float x0) const {
    float a = 1.0f, da = 0.0f, S = 0.0f, dS = 0.0f;  // this lane's segment
    for (int s = s0; s < s1; ++s) {
      dS = fmaf(phi, dS, S);
      S = fmaf(phi, S, 1.0f);
      da = fmaf(phi, da, a);
      a = phi * a;
    }
    // inclusive scan: after round off, lane r's map covers segments
    // r - 2 off + 1 .. r, composed earliest first
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const float pa = __shfl_up_sync(mask, a, off, G), pda = __shfl_up_sync(mask, da, off, G);
      const float pS = __shfl_up_sync(mask, S, off, G), pdS = __shfl_up_sync(mask, dS, off, G);
      if (lane >= off) {
        dS = fmaf(da, pS, fmaf(a, pdS, dS));
        S = fmaf(a, pS, S);
        da = fmaf(da, pa, a * pda);
        a = a * pa;
      }
    }
    // exclusive: the segments before this lane's, the identity for lane 0
    float ea = __shfl_up_sync(mask, a, 1, G), eda = __shfl_up_sync(mask, da, 1, G);
    float eS = __shfl_up_sync(mask, S, 1, G), edS = __shfl_up_sync(mask, dS, 1, G);
    if (lane == 0) {
      ea = 1.0f;
      eda = eS = edS = 0.0f;
    }
    return {fmaf(ea, x0, drift * eS), fmaf(eda, x0, drift * edS), eS, ea};
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    const float phi = tanhf(q[0]), drift = q[1], x0 = q[2];
    Dens::State v = {x0, 0.0f, 0.0f, 1.0f};
    if constexpr (G > 1) v = segment_start(phi, drift, x0);
    Dens::Sums m = {0.0f, 0.0f, 0.0f, 0.0f};
    dens.run(phi, drift, v, s0, s1, m);
    m.sumsq = group_sum<G>(m.sumsq, mask);
    m.a_phi = group_sum<G>(m.a_phi, mask);
    m.a_drift = group_sum<G>(m.a_drift, mask);
    m.a_x0 = group_sum<G>(m.a_x0, mask);
    return dens.close(q, phi, m, g);
  }
  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    value_and_grad(q, g);
  }
};

// The logistic regression at G lanes a chain: lane r takes rows r, r + G,
// ..., the first kRegRows in registers (zeros past n, masked out of U;
// none past D = 15, where a row outgrows kFamilyLaneFloats).
template <int DD, int G>
struct Lanes<LogisticDensity<DD>, G> {
  using Dens = LogisticDensity<DD>;
  static constexpr int D = DD;
  static constexpr int kRegRows = reg_rows<D + 1, G>();
  static constexpr int kRegSlots = kRegRows > 0 ? kRegRows : 1;  // no array of length 0
  Dens dens;  // points into shared memory after stage()
  float rx[kRegSlots][D];
  float ry[kRegSlots];
  int lane;
  unsigned mask;

  __device__ explicit Lanes(const Dens& d)
      : dens(d), lane((int)(threadIdx.x & (G - 1))), mask(group_mask<G>()) {
#pragma unroll
    for (int j = 0; j < kRegRows; ++j) {
      const int i = lane + j * G;
      const bool here = i < dens.n;
      const float* xr = dens.X + i * Dens::kStride;
#pragma unroll
      for (int k = 0; k < D; ++k) rx[j][k] = here ? xr[k] : 0.0f;
      ry[j] = here ? xr[D] : 0.0f;
    }
  }

  // The group's sums over the rows: returns sum_i t_i (when kValue) and
  // writes sum_i r_i x_i into g; every lane ends with the same bits.
  template <bool kValue>
  __device__ __forceinline__ float sums(const float (&q)[D], float (&g)[D]) const {
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = 0.0f;
    // register rows: a zero row adds nothing to g, and is masked out of u
#pragma unroll
    for (int j = 0; j < kRegRows; ++j) {
      float eta = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) eta = fmaf(rx[j][k], q[k], eta);
      float t = 0.0f, r;
      Dens::template row<kValue>(eta, ry[j], t, r);
      if (kValue) u += lane + j * G < dens.n ? t : 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = fmaf(rx[j][k], r, g[k]);
    }
    // shared-memory rows, kRowUnroll at a time, added in row order
    int i = lane + kRegRows * G;
    for (; i + (kRowUnroll - 1) * G < dens.n; i += kRowUnroll * G) {
      float x[kRowUnroll][D], t[kRowUnroll], r[kRowUnroll];
#pragma unroll
      for (int j = 0; j < kRowUnroll; ++j) {
        const float* xr = dens.X + (i + j * G) * Dens::kStride;
        float eta = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          x[j][k] = xr[k];
          eta = fmaf(x[j][k], q[k], eta);
        }
        Dens::template row<kValue>(eta, xr[D], t[j], r[j]);
      }
#pragma unroll
      for (int j = 0; j < kRowUnroll; ++j) {
        if (kValue) u += t[j];
#pragma unroll
        for (int k = 0; k < D; ++k) g[k] = fmaf(x[j][k], r[j], g[k]);
      }
    }
    for (; i < dens.n; i += G) {
      const float* xr = dens.X + i * Dens::kStride;
      float eta = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) eta = fmaf(xr[k], q[k], eta);
      float t, r;
      Dens::template row<kValue>(eta, xr[D], t, r);
      if (kValue) u += t;
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = fmaf(xr[k], r, g[k]);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = group_sum<G>(g[k], mask);
    return kValue ? group_sum<G>(u, mask) : 0.0f;
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    return dens.close(q, sums<true>(q, g), g);
  }
  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    dens.close(q, sums<false>(q, g), g);
  }
};

// The mixture at G lanes a chain: lane r takes points r, r + G, ..., the
// first kRegRows in registers; the sort and the weights are every lane's.
template <int K, int G>
struct Lanes<MixtureDensity<K>, G> {
  using Dens = MixtureDensity<K>;
  static constexpr int D = Dens::D;
  static constexpr int kRegRows = reg_rows<1, G>();
  Dens dens;  // points into shared memory after stage()
  float ry[kRegRows];
  int lane;
  int rows;  // this lane's points: lane, lane + G, ... below n
  unsigned mask;

  __device__ explicit Lanes(const Dens& d)
      : dens(d),
        lane((int)(threadIdx.x & (G - 1))),
        rows(d.n > lane ? (d.n - lane + G - 1) / G : 0),
        mask(group_mask<G>()) {
#pragma unroll
    for (int j = 0; j < kRegRows; ++j) ry[j] = j < rows ? dens.y[lane + j * G] : 0.0f;
  }

  template <bool kValue>
  __device__ __forceinline__ float eval(const float (&q)[D], float (&g)[D]) const {
    const typename Dens::Prologue pr = Dens::prologue(q);
    float S[Dens::kSums];
#pragma unroll
    for (int j = 0; j < Dens::kSums; ++j) S[j] = 0.0f;
    // register points: the ones past this lane's count are skipped (a zero
    // point is not neutral here)
#pragma unroll
    for (int j = 0; j < kRegRows; ++j) {
      const typename Dens::Point pt = Dens::template point<kValue>(ry[j], pr);
      if (j < rows) Dens::template add<kValue>(pt, S);
    }
    int i = lane + kRegRows * G;
    for (; i + (kRowUnroll - 1) * G < dens.n; i += kRowUnroll * G) {
      typename Dens::Point pt[kRowUnroll];
#pragma unroll
      for (int j = 0; j < kRowUnroll; ++j)
        pt[j] = Dens::template point<kValue>(dens.y[i + j * G], pr);
#pragma unroll
      for (int j = 0; j < kRowUnroll; ++j) Dens::template add<kValue>(pt[j], S);
    }
    for (; i < dens.n; i += G) Dens::template add<kValue>(Dens::template point<kValue>(dens.y[i], pr), S);
#pragma unroll
    for (int j = kValue ? 0 : 1; j < Dens::kSums; ++j) S[j] = group_sum<G>(S[j], mask);
    return dens.close(q, pr, S, g);
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    return eval<true>(q, g);
  }
  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    eval<false>(q, g);
  }
};

// The hierarchical posterior at G lanes a chain (G divides NG): lane r
// owns groups r, r + G, ..., adds their rows in row order and their sums
// in group order; a butterfly adds the lanes' curve sums of squares (and
// with U their Poisson values), and each group's two gradients are
// broadcast from its owner (2 NG shuffles).  The pooled prior, a
// function of q alone, is every lane's, so all lanes end with the same
// bits.  A lane's own groups are picked out of q by selects: a register
// array indexed by the lane would go to local memory.
template <int NG, int G>
struct Lanes<HierarchicalDensity<NG>, G> {
  using Dens = HierarchicalDensity<NG>;
  static constexpr int D = Dens::D;
  static constexpr int kOwn = NG / G;  // groups a lane owns
  static_assert(G >= 1 && NG % G == 0, "a lane group of the hierarchical posterior divides NG");
  Dens dens;  // points into shared memory after stage()
  int lane, base;
  unsigned mask;

  __device__ explicit Lanes(const Dens& d)
      : dens(d),
        lane((int)(threadIdx.x & (G - 1))),
        base((int)(threadIdx.x & 31) & ~(G - 1)),
        mask(group_mask<G>()) {}

  template <bool kValue>
  __device__ __forceinline__ float eval(const float (&q)[D], float (&g)[D]) const {
    const float lam = expf(q[Dens::kT]);
    float S = 0.0f, P = 0.0f, gla[kOwn], gr[kOwn];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      // group lane + j G: its (la, r) by selects over the G candidates
      float la = q[2 * j * G], r = q[2 * j * G + 1];
#pragma unroll
      for (int k = 1; k < G; ++k) {
        la = lane == k ? q[2 * (j * G + k)] : la;
        r = lane == k ? q[2 * (j * G + k) + 1] : r;
      }
      const typename Dens::Group s = dens.template group<kValue>(lane + j * G, la, r);
      S += s.sumsq;
      if (kValue) P += s.pois;
      gla[j] = fmaf(lam, s.ga, s.dpois);
      gr[j] = lam * s.gr;
    }
    S = group_sum<G>(S, mask);
    if (kValue) P = group_sum<G>(P, mask);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      if constexpr (G == 1) {
        g[2 * k] = gla[k];
        g[2 * k + 1] = gr[k];
      } else {
        g[2 * k] = __shfl_sync(mask, gla[k / G], base + k % G);
        g[2 * k + 1] = __shfl_sync(mask, gr[k / G], base + k % G);
      }
    }
    return dens.template close<kValue>(q, lam, S, P, g);
  }

  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    return eval<true>(q, g);
  }
  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    eval<false>(q, g);
  }
};

template <int DC, int G>
struct Lanes<LinregDensity<DC>, G> {
  static constexpr int D = DC + 1;
  // rows a lane holds in registers: 50 floats of V and y (10 rows at
  // DC = 4); ops/kernels/fused_potential.py::lanes_for picks the narrowest
  // group whose lanes hold all the rows there
  static constexpr int kRegRows = kLaneFloats / (DC + 1) > 0 ? kLaneFloats / (DC + 1) : 1;
  LinregDensity<DC> dens;  // points into shared memory after stage()
  float rv[kRegRows][DC];
  float ry[kRegRows];
  float pm[DC], ipv[DC];  // the prior's rows, in registers too
  int lane;
  int rows;  // ceil(n / G), the same in every lane: the rest are zeros
  unsigned mask;

  __device__ explicit Lanes(const LinregDensity<DC>& d)
      : dens(d),
        lane((int)(threadIdx.x & (G - 1))),
        rows((d.n + G - 1) / G),
        mask(group_mask<G>()) {
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      pm[k] = dens.pm[k];
      ipv[k] = dens.ipv[k];
    }
#pragma unroll
    for (int j = 0; j < kRegRows; ++j) {
      const int i = lane + j * G;
      const bool here = i < dens.n;
#pragma unroll
      for (int k = 0; k < DC; ++k) rv[j][k] = here ? dens.V[i * DC + k] : 0.0f;
      ry[j] = here ? dens.y[i] : 0.0f;
    }
  }

  // The group's sums over the data rows: sum r_i^2 and sum r_i V_i.
  __device__ __forceinline__ float row_sums(const float (&q)[D], float (&gc)[DC]) const {
    float sumsq = 0.0f;
#pragma unroll
    for (int k = 0; k < DC; ++k) gc[k] = 0.0f;
    // rows past n are zeros in registers and add exactly nothing, so when
    // a lane's rows fill its registers the unrolled loop needs no test and
    // its rows' arithmetic interleaves
    auto add_row = [&](int j) {
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < DC; ++k) r = fmaf(rv[j][k], q[k], r);
      r -= ry[j];
      sumsq = fmaf(r, r, sumsq);
#pragma unroll
      for (int k = 0; k < DC; ++k) gc[k] = fmaf(rv[j][k], r, gc[k]);
    };
    if (rows == kRegRows) {
#pragma unroll
      for (int j = 0; j < kRegRows; ++j) add_row(j);
    } else {
#pragma unroll
      for (int j = 0; j < kRegRows; ++j)
        if (j < rows) add_row(j);
    }
    for (int i = lane + kRegRows * G; i < dens.n; i += G) {
      const float* row = dens.V + i * DC;
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < DC; ++k) r = fmaf(row[k], q[k], r);
      r -= dens.y[i];
      sumsq = fmaf(r, r, sumsq);
#pragma unroll
      for (int k = 0; k < DC; ++k) gc[k] = fmaf(row[k], r, gc[k]);
    }
#pragma unroll
    for (int k = 0; k < DC; ++k) gc[k] = group_sum<G>(gc[k], mask);
    return group_sum<G>(sumsq, mask);
  }

  // grad U(q) into g: lam gc + (c - m) / v, and dU/dt = lam/2 sumsq -
  // (n/2 + a) + b lam, in LinregDensity.potential_and_grad's order
  __device__ __forceinline__ void grad_from(const float (&q)[D], const float (&gc)[DC],
                                            float sumsq, float lam, float (&g)[D]) const {
#pragma unroll
    for (int k = 0; k < DC; ++k)
      g[k] = __fadd_rn(__fmul_rn(lam, gc[k]), __fmul_rn(__fsub_rn(q[k], pm[k]), ipv[k]));
    g[DC] = __fadd_rn(__fsub_rn(__fmul_rn(__fmul_rn(0.5f, lam), sumsq), dens.half_n_plus_a),
                      __fmul_rn(dens.rate, lam));
  }

  __device__ __forceinline__ void grad(const float (&q)[D], float (&g)[D]) const {
    float gc[DC];
    const float sumsq = row_sums(q, gc);
    grad_from(q, gc, sumsq, expf(q[DC]), g);
  }

  // U(q); writes grad U(q) into g.  The closed form of
  // LinregDensity::value_and_grad with the row sum split over the group.
  __device__ __forceinline__ float value_and_grad(const float (&q)[D], float (&g)[D]) const {
    float gc[DC];
    const float sumsq = row_sums(q, gc);
    const float t = q[DC];
    const float lam = expf(t);
    grad_from(q, gc, sumsq, lam, g);
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      const float qc = __fsub_rn(q[k], pm[k]);
      prior = __fadd_rn(prior, __fmul_rn(__fmul_rn(qc, qc), ipv[k]));
    }
    return __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(__fmul_rn(0.5f, lam), sumsq),
                                         __fmul_rn(dens.half_n_plus_a, t)),
                               __fmul_rn(dens.rate, lam)),
                     __fmul_rn(0.5f, prior));
  }
};

// A diagonal metric rounded as the plain version's: p = z / sqrt(im),
// drift q + eps p im, kinetic sum of p p im in coordinate order.
template <int D>
struct LaneDiagMetric {
  float im[D];

  __device__ __forceinline__ void momentum(const float (&z)[D], float (&p)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = z[k] / sqrtf(fmaxf(im[k], 1e-20f));
  }
  __device__ __forceinline__ float kinetic2(const float (&p)[D]) const {
    float kin = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) kin = __fadd_rn(kin, __fmul_rn(__fmul_rn(p[k], p[k]), im[k]));
    return kin;
  }
  __device__ __forceinline__ void drift(float (&q)[D], const float (&p)[D], float eps) const {
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = __fadd_rn(q[k], __fmul_rn(__fmul_rn(eps, p[k]), im[k]));
  }
};

// p - c g, rounded as the plain version's p - c * g
template <int D>
__device__ __forceinline__ void kick(float (&p)[D], const float (&g)[D], float c) {
#pragma unroll
  for (int k = 0; k < D; ++k) p[k] = __fsub_rn(p[k], __fmul_rn(c, g[k]));
}

// One trajectory for a Lanes functor (the plain version's
// ops/kernels/fused_hmc.py::leapfrog_trajectory): U only at the ends.
template <class Lanes, class Metric>
__device__ __forceinline__ float lane_trajectory(const Lanes& dens, const Metric& metric,
                                                 const float (&q)[Lanes::D],
                                                 const float (&z)[Lanes::D], float eps,
                                                 int num_leapfrog, float (&q_new)[Lanes::D],
                                                 float (&p)[Lanes::D]) {
  constexpr int D = Lanes::D;
  float g[D];
  metric.momentum(z, p);
  const float U0 = dens.value_and_grad(q, g);
  const float E0 = __fadd_rn(U0, __fmul_rn(0.5f, metric.kinetic2(p)));
  const float half_eps = 0.5f * eps;
  kick(p, g, half_eps);
#pragma unroll
  for (int k = 0; k < D; ++k) q_new[k] = q[k];
  float U1 = U0;
  for (int l = 0; l < num_leapfrog; ++l) {
    metric.drift(q_new, p, eps);
    if (l + 1 < num_leapfrog)
      dens.grad(q_new, g);
    else
      U1 = dens.value_and_grad(q_new, g);
    kick(p, g, eps);
  }
  kick(p, g, -half_eps);
  return __fsub_rn(E0, __fadd_rn(U1, __fmul_rn(0.5f, metric.kinetic2(p))));
}

// step_noise for a group: the ceil(D/2) momentum calls and the uniform's
// call are spread over the G lanes (lane r makes calls r, r + G, ...), and
// each value is broadcast from the lane that drew it.
template <int D, int G>
__device__ __forceinline__ void group_step_noise(uint64_t seed, uint32_t tag, uint32_t chain,
                                                 uint32_t step, float (&z)[D], float& u) {
  if constexpr (G == 1) {
    step_noise<D>(seed, tag, chain, step, z, u);
  } else {
    constexpr int kMom = (D + 1) / 2;             // momentum calls
    constexpr int kPerLane = (kMom + G) / G;      // calls per lane, the uniform's included
    const int lane = (int)(threadIdx.x & (G - 1));
    const int base = (int)(threadIdx.x & 31) & ~(G - 1);
    const unsigned mask = group_mask<G>();
    const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
    float a[kPerLane], b[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + j * G;
      a[j] = 0.0f;
      b[j] = 0.0f;
      if (s < kMom) {
        const Philox4 r = philox4x32_10(Philox4{chain, step, (uint32_t)s, tag}, k0, k1);
        a[j] = bits_to_normal(r.x, r.y);
        b[j] = bits_to_normal(r.z, r.w);
      } else if (s == kMom) {
        const Philox4 r = philox4x32_10(Philox4{chain, step, kUniformSlot, tag}, k0, k1);
        a[j] = bits_to_uniform(r.x);
      }
    }
#pragma unroll
    for (int s = 0; s < kMom; ++s) {
      z[2 * s] = __shfl_sync(mask, a[s / G], base + s % G);
      if (2 * s + 1 < D) z[2 * s + 1] = __shfl_sync(mask, b[s / G], base + s % G);
    }
    u = __shfl_sync(mask, a[kMom / G], base + kMom % G);
  }
}

// What every lane of a group holds of one collapsed-Gibbs sweep's noise:
// the Gamma draw's round-0 normal and uniform (and, once the kernel has
// taken that round, its draw and decision) and the coefficient normals.
template <int DC>
struct SweepNoise {
  float gz0, gu0, g0;
  bool acc0;
  float cz[DC];
};

// gibbs_noise for a group, in the least calls: slot 0 (the Gamma draw's
// normals 0 and 1), slot 2 (its four uniforms) and the coefficient slots
// 3.. are spread over the G lanes (lane r makes calls r, r + G, ...),
// converted by the lane that made them and broadcast by shuffle; slot 1
// (normals 2 and 3) is made only for rounds 2 and 3 (slot1), and round
// 1's normal converted only when asked for (gz1) unless the lane's column
// converts a second normal anyway.  The counters (chain, sweep, slot,
// kTagGibbs) are gibbs_noise's, so the bits are too.  draw() has no
// branch: every lane of a warp runs the same instructions.
template <int DC, int G>
struct GroupGibbsNoise {
  static constexpr int kCalls = 2 + (DC + 1) / 2;
  static constexpr int kPerLane = (kCalls + G - 1) / G;
  uint32_t chain, sweep;
  int lane, base;
  unsigned mask;
  Philox4 bits[kPerLane];
  float a[kPerLane], b[kPerLane];

  template <class Args>
  __device__ GroupGibbsNoise(const Args&, int c, unsigned mask_)
      : chain((uint32_t)c),
        lane((int)(threadIdx.x & (G - 1))),
        base((int)(threadIdx.x & 31) & ~(G - 1)),
        mask(mask_) {}

  // call q's Philox slot: 0, then 2, 3, ...
  static __host__ __device__ constexpr uint32_t slot(int q) {
    return q == 0 ? 0u : (uint32_t)q + 1u;
  }
  // whether a call of column j (calls jG .. jG + G - 1) carries a
  // coefficient normal in its second pair of words
  static __host__ __device__ constexpr bool second_normal(int j) {
    for (int q = j * G; q < (j + 1) * G && q < kCalls; ++q)
      if (q >= 2 && 2 * (q - 2) + 1 < DC) return true;
    return false;
  }

  __device__ __forceinline__ void draw(uint64_t seed, uint32_t s) {
    const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
    sweep = s;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int q = lane + j * G;
      bits[j] = philox4x32_10(Philox4{chain, s, slot(q < kCalls ? q : 0), kTagGibbs}, k0, k1);
      const float nrm = bits_to_normal(bits[j].x, bits[j].y);
      a[j] = q == 1 ? bits_to_uniform(bits[j].x) : nrm;
      b[j] = second_normal(j) ? bits_to_normal(bits[j].z, bits[j].w) : 0.0f;
    }
  }

  // value v of call q's lane
  __device__ __forceinline__ float from(int q, float v) const {
    return G == 1 ? v : __shfl_sync(mask, v, base + q % G);
  }

  __device__ __forceinline__ void values(SweepNoise<DC>& out) const {
    out.gz0 = from(0, a[0]);
    out.gu0 = from(1, a[1 / G]);
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      const int q = 2 + k / 2;
      out.cz[k] = from(q, k % 2 ? b[q / G] : a[q / G]);
    }
  }

  // round 1's normal (slot 0's second) and round r's uniform (slot 2)
  __device__ __forceinline__ float gz1() const {
    return from(0, second_normal(0) ? b[0] : bits_to_normal(bits[0].z, bits[0].w));
  }
  __device__ __forceinline__ float gu(int r) const {
    const Philox4& u = bits[1 / G];
    return from(1, bits_to_uniform(r == 1 ? u.y : r == 2 ? u.z : u.w));
  }
  // rounds 2 and 3's normals: slot 1, made by every lane of the group
  __device__ __forceinline__ void slot1(uint64_t seed, float& z2, float& z3) const {
    const Philox4 r = philox4x32_10(Philox4{chain, sweep, 1u, kTagGibbs}, (uint32_t)seed,
                                    (uint32_t)(seed >> 32));
    z2 = bits_to_normal(r.x, r.y);
    z3 = bits_to_normal(r.z, r.w);
  }
};

}  // namespace binf
