// Whole-run collapsed Gibbs on the linear-regression posterior, one kernel
// (K5; the template is fused_gibbs_kernel.cuh, its instances the
// fused_gibbs.g<G>.cu units).
//
// Replaces binf_tpu/ops/pallas/fused_gibbs.py::_kernel
// (fused_linreg_gibbs_run).  The TPU kernel holds a (8, BC) tile of chains
// with every d x d matrix entry a lane vector and walks a sequential grid
// axis of sweep blocks; here a group of G lanes of a warp owns one chain,
// keeps c and lambda in registers for the whole run and loops over all
// sweeps itself.  Each sweep, in the order of fused_gibbs.py:111-180 (the
// plain version, ops/kernels/fused_gibbs.py, repeats it batched over
// chains):
//
//   1. SS = ||V c - y||^2 over the n data points;
//   2. lambda = Gamma(a + n/2, 1) / (b + SS/2), Marsaglia-Tsang: the first
//      of four rounds that accepts, the reference's fallback d = shape -
//      1/3 if none does;
//   3. P = lambda V^T V + diag(1/v0), rhs = lambda V^T y + mu0/v0;
//   4. P = L L^T with the diagonal floored at 1e-20, unrolled for d <= 7;
//   5. mean = P^-1 rhs by two triangular solves, c = mean + L^-T z.
//
// What bounded the previous design was the latency of a chain's sweep,
// not the card's rates: one thread a chain in 128-thread CTAs, one warp a
// scheduler at 16,384 chains, took 7,571 cycles a sweep on an H100, its
// phases apart (scripts/kernel_cycles.py section k5, one warp): the noise
// (five Philox calls, eight Box-Muller normals) 2,583 cycles, the Cholesky
// factor and solves 1,625, all four Gamma rounds 892, the residual sum
// from shared memory 585, the staged store with two block barriers 264.
// So:
//
// - a group of G = 4 lanes shares a chain (16 warps an SM, four a
//   scheduler, at 16,384 chains; G = 8 is built too, so that the card
//   checks can hold the draws to the same bits at two widths).  Its
//   lanes split the residual sum's rows (the first rows of each in
//   registers) and the sweep's Philox calls (lanes.cuh::GroupGibbsNoise:
//   the least calls, one a lane at d = 4), and each runs the Cholesky
//   factor and solves with the same bits, so nothing else is broadcast;
// - the noise and round 0 of the Gamma draw depend on no state: sweep
//   s + 1's are made in the iteration of sweep s, beside its dependent
//   chain (SS, lambda, the factor, the solves), which needs none of them;
// - rounds 1-3 run only when round 0 rejects (0.27% of the sweeps at the
//   polynomial's shape a + n/2 = 11), slot 1's Philox call only when round
//   1 rejects too: the same draw as taking all four, bit for bit;
// - SS is added in one fixed order whatever G is (8 partials, partial j
//   over the rows i = j mod 8, then a xor tree 4, 2, 1), so the draws do
//   not depend on G, on block_chains or on the CTA count;
// - 1 / L_kk comes from one reciprocal square root and the factor and
//   solves multiply by it (IEEE division's slow-path branch cost K6b and
//   K7 dearly);
// - no barrier after the data is staged: each lane stores its share of
//   its chain's draw, a warp's stores falling in one contiguous run.
//
// Measured the same way: 2,791 cycles a sweep at 16,384 chains (5.64 ms
// for 4,000 sweeps), 1,704 with one warp a scheduler (32 chains).  Four
// warps a scheduler keep it issuing most cycles, ~700 instructions a warp
// and sweep, the noise (a Philox call and two Box-Muller normals a lane)
// the largest part: now the issue rate bounds it.  G = 2 took 6.14 ms,
// G = 8 10.45 (each lane repeats the factor and solves; 1,024 CTAs); IEEE
// sqrtf and / for the factor took 9.11 ms.  Past the register rows G = 4
// still leads (section k5_rows): 6.62 ms at n = 37 (G = 8 10.77, one
// thread a chain 15.33), 42.84 at n = 1,001 (G = 8 44.60, one thread a
// chain 54.60).
//
// Noise comes from Philox (counters (chain, sweep, slot, kTagGibbs), those
// of philox.cuh::gibbs_noise), or from staged arrays in the JAX host-noise
// layout (steps, 8, C).  The only device-memory traffic is the draws,
// (steps, C, d + 1) float32 written once.

#include "c_api.cuh"
#include "fused_gibbs_kernel.cuh"

namespace binf {

#define BINF_K5_EXTERN(DC)                                                                 \
  extern template cudaError_t launch_gibbs<DC, 4>(const GibbsArgs&, cudaStream_t, int*);  \
  extern template cudaError_t launch_gibbs<DC, 8>(const GibbsArgs&, cudaStream_t, int*);
BINF_K5_EXTERN(1)
BINF_K5_EXTERN(2)
BINF_K5_EXTERN(3)
BINF_K5_EXTERN(4)
BINF_K5_EXTERN(5)
BINF_K5_EXTERN(6)
BINF_K5_EXTERN(7)
#undef BINF_K5_EXTERN

template <int DC>
cudaError_t launch_lanes(int G, const GibbsArgs& a, cudaStream_t s, int* grid) {
  switch (G) {
    case 4:
      return launch_gibbs<DC, 4>(a, s, grid);
    case 8:
      return launch_gibbs<DC, 8>(a, s, grid);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace binf

// grid receives the CTAs, the threads a CTA and whether every data row
// sits in registers
extern "C" int binf_fused_linreg_gibbs(int d, int lanes, const float* q0, const float* V,
                                       const float* y, const float* vtv, const float* vty,
                                       const float* ipv, const float* pm, int n,
                                       float gamma_d, float gamma_c, float rate,
                                       int n_chains, int num_steps, unsigned long long seed,
                                       const float* gz, const float* gu, const float* cz,
                                       float* draws, void* stream, int* grid) {
  const binf::GibbsArgs a{V,  y,  vtv,      vty,       ipv,  pm, n,  gamma_d, gamma_c,
                          rate, q0, n_chains, num_steps, seed, gz, gu, cz,      draws};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
#define BINF_K5_CASE(DC) \
  case DC:               \
    return (int)binf::launch_lanes<DC>(lanes, a, s, grid);
    BINF_K5_CASE(1)
    BINF_K5_CASE(2)
    BINF_K5_CASE(3)
    BINF_K5_CASE(4)
    BINF_K5_CASE(5)
    BINF_K5_CASE(6)
    BINF_K5_CASE(7)
#undef BINF_K5_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
