// L-step leapfrog for a quadratic potential on a batch of chains (K8).
//
// Replaces binf_tpu/ops/pallas/leapfrog.py::_leapfrog_kernel
// (quadratic_leapfrog).  For U(q) = q^T A q / 2 - b^T q over chains q (C, D),
// the gradient is q A - b (a row vector times A, as the TPU kernel and its
// lax.scan reference compute it, so a non-symmetric A acts as there):
//
//   p -= eps/2 (q A - b);  L x { q += eps (p * im);  p -= eps (q A - b) };  p += eps/2 (q A - b)
//
// The trailing half kick reuses the loop's last product (L + 1 products a
// call, not L + 2): p - eps (g - b), then + eps/2 (g - b), the arithmetic of
// forming that product anew, so the bits are those of the L + 2 form.  When
// asked, the kernel also writes each chain's potential at the final q,
// U = q . (q A / 2 - b), from the last product, so a sampler's MH test needs
// no product of its own; with L = 0 it is U at the start.
//
// Two routes, picked by D and reported to the caller:
//
// Tensor route (D <= 128).  The products run on the tensor cores as 3xTF32:
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi accumulated in float32 (the a_lo b_lo term lies
// below float32's rounding), so a product keeps float32 accuracy; one pass
// of TF32 would not.  A warp owns 16 chains and keeps their q and p in
// registers for the whole trajectory, in the m16n8k8 accumulator layout:
// lane (g, t) holds rows g and g + 8, columns 8j + 2t and 8j + 2t + 1 of
// each 8-column tile j.  That layout is the A operand of the next product
// once A's rows are permuted when staged (logical k = t is row 8kk + 2t,
// k = t + 4 is row 8kk + 2t + 1), so drift, product and kick never leave
// registers and a warp passes no barrier after staging.  A's hi and lo
// planes sit in shared memory as each lane's B fragments, one 16-byte load a
// fragment (128 KB at D = 128); D is padded with zeros to a multiple of 8.
// A CTA is 4 warps (64 chains) sharing one staged copy, one CTA an SM at
// 8,192 chains.  The kick comes in the product's epilogue: as soon as a
// group of 8 column tiles has its sums, their p is kicked.
//
// SIMT route (D > 128, where q and p outgrow the registers).  One CTA of
// 256 threads takes a tile of TC chains (32, or fewer so that A fits beside
// the tile; a ragged last tile is masked, nothing is padded).  The tile's q,
// p and q A live in shared memory; A sits there too when it fits, else it is
// streamed through shared memory in chunks of rows for every product.  Each
// thread owns a 4-chain x 4-column block of q A in full float32 FMA.
//
// Bound: operations.  L + 1 products of 2 C D^2 flops, on the tensor route
// three passes at the TF32 rate, on the SIMT route one at the float32 rate;
// q, p and A are read once and q, p (and U) written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"

namespace binf {

constexpr int64_t kLfSmemLimit = 232448;  // 227 KB a block

// -- tensor route ----------------------------------------------------------------------

constexpr int kTcWarps = 4;     // warps a CTA, 16 chains each
constexpr int kTcMaxTiles = 16; // 8-column tiles: D <= 128
constexpr int kTcGroup = 8;     // column tiles kicked together
constexpr int kTcStageBatch = 16;  // fragments a thread loads at once while staging

inline int64_t tc_smem_bytes(int nt) {
  return (int64_t)nt * nt * 32 * sizeof(float4) + 2 * 8 * (int64_t)nt * sizeof(float);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's hi and lo planes as B fragments: fragment (kk, j) of lane (g, t) is
// {hi A[r][c], hi A[r + 1][c], lo A[r][c], lo A[r + 1][c]} with r = 8 kk + 2 t,
// c = 8 j + g; then b and the metric, zero past D.  A thread builds whole
// fragments, so a warp's 16-byte stores are consecutive (no bank conflicts)
// and its loads of A cover whole 32-byte sectors (rows r, r + 1 of 8
// columns); kTcStageBatch fragments a thread are loaded before any is
// stored, so the loads are in flight together.  (Staged one element at a
// time, a launch with L = 0 took 47 us at 8,192 chains, D = 128; so 26.)
template <int NT>
__device__ __forceinline__ void tc_stage(const float* __restrict__ A,
                                         const float* __restrict__ b,
                                         const float* __restrict__ im, int D, float4* frag,
                                         float* bs, float* ims) {
  constexpr int kSlots = NT * NT * 32;
  for (int s0 = threadIdx.x; s0 < kSlots; s0 += blockDim.x * kTcStageBatch) {
    float a[kTcStageBatch][2];
#pragma unroll
    for (int k = 0; k < kTcStageBatch; ++k) {
      const int s = s0 + k * blockDim.x, tile = s >> 5, ln = s & 31;
      const int r = 8 * (tile / NT) + 2 * (ln & 3), c = 8 * (tile % NT) + (ln >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[k][h] = s < kSlots && r + h < D && c < D ? A[(int64_t)(r + h) * D + c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kTcStageBatch; ++k) {
      const int s = s0 + k * blockDim.x;
      if (s >= kSlots) break;
      const uint32_t h0 = tf32_rna(a[k][0]), h1 = tf32_rna(a[k][1]);
      frag[s] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                            __uint_as_float(tf32_rna(a[k][0] - __uint_as_float(h0))),
                            __uint_as_float(tf32_rna(a[k][1] - __uint_as_float(h1))));
    }
  }
  for (int j = threadIdx.x; j < 8 * NT; j += blockDim.x) {
    bs[j] = j < D ? b[j] : 0.0f;
    ims[j] = j < D ? im[j] : 0.0f;
  }
}

// One product g = q A on the tensor cores (3xTF32) and its kick,
// p -= coef (g - b), in groups of kTcGroup column tiles, each group kicked as
// soon as its sums are whole; at the last product (last) also the trailing
// half kick, p += half (g - b), and each of the lane's two rows' share of U.
template <int NT>
__device__ __forceinline__ void tc_product_kick(const float (&qr)[NT][4], float (&pr)[NT][4],
                                                const float4* frag, const float2* b2, int lane,
                                                float coef, float half, bool last,
                                                float (&u)[2]) {
  constexpr int G = NT < kTcGroup ? NT : kTcGroup;
  const int tig = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += G) {
    float acc[G][4];
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.0f;  // a last group past NT stays unused
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      // A operand of k-tile kk: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float av[4] = {qr[kk][0], qr[kk][2], qr[kk][1], qr[kk][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = tf32_rna(av[i]);
        al[i] = tf32_rna(av[i] - __uint_as_float(ah[i]));
      }
#pragma unroll
      for (int jj = 0; jj < G && j0 + jj < NT; ++jj) {
        const float4 f = frag[(kk * NT + j0 + jj) * 32 + lane];
        const uint32_t h0 = __float_as_uint(f.x), h1 = __float_as_uint(f.y);
        mma_tf32(acc[jj], al, h0, h1);
        mma_tf32(acc[jj], ah, __float_as_uint(f.z), __float_as_uint(f.w));
        mma_tf32(acc[jj], ah, h0, h1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < G && j0 + jj < NT; ++jj) {
      const int j = j0 + jj;
      const float2 bb = b2[4 * j + tig];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bj = e & 1 ? bb.y : bb.x;
        const float gb = acc[jj][e] - bj;
        pr[j][e] = pr[j][e] - coef * gb;
        if (last) {
          pr[j][e] = pr[j][e] + half * gb;
          u[e >> 1] = fmaf(qr[j][e], 0.5f * acc[jj][e] - bj, u[e >> 1]);
        }
      }
    }
  }
}

// q += eps (p * im) on the lane's elements
template <int NT>
__device__ __forceinline__ void tc_drift(float (&qr)[NT][4], const float (&pr)[NT][4],
                                         const float2* im2, int lane, float eps) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 m = im2[4 * j + (lane & 3)];
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[j][e] = qr[j][e] + eps * (pr[j][e] * (e & 1 ? m.y : m.x));
  }
}

template <int NT>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
quadratic_leapfrog_tc_kernel(const float* __restrict__ q, const float* __restrict__ p,
                             const float* __restrict__ A, const float* __restrict__ b,
                             const float* __restrict__ im, const float* __restrict__ eps_ptr,
                             int C, int D, int num_steps, float* __restrict__ q_out,
                             float* __restrict__ p_out, float* __restrict__ u_out) {
  extern __shared__ float4 frag[];
  float* bs = reinterpret_cast<float*>(frag + NT * NT * 32);
  float* ims = bs + 8 * NT;
  tc_stage<NT>(A, b, im, D, frag, bs, ims);
  __syncthreads();
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int64_t row0 = ((int64_t)blockIdx.x * kTcWarps + (threadIdx.x >> 5)) * 16;
  if (row0 >= C) return;
  // element e of tile j: row row0 + gid + 8 (e >> 1), column 8 j + 2 tig + (e & 1)
  const int64_t rows[2] = {row0 + gid, row0 + gid + 8};
  float qr[NT][4], pr[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = rows[e >> 1];
      const int col = 8 * j + 2 * tig + (e & 1);
      const bool in = row < C && col < D;
      qr[j][e] = in ? q[row * D + col] : 0.0f;
      pr[j][e] = in ? p[row * D + col] : 0.0f;
    }
  const float2* b2 = reinterpret_cast<const float2*>(bs);
  const float2* im2 = reinterpret_cast<const float2*>(ims);
  const float eps = *eps_ptr, half = 0.5f * eps;
  float u[2] = {0.0f, 0.0f};
  for (int l = 0; l <= num_steps; ++l) {
    if (l > 0) tc_drift<NT>(qr, pr, im2, lane, eps);
    tc_product_kick<NT>(qr, pr, frag, b2, lane, l == 0 ? half : eps, half, l == num_steps, u);
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = rows[e >> 1];
      const int col = 8 * j + 2 * tig + (e & 1);
      if (row < C && col < D) {
        q_out[row * D + col] = qr[j][e];
        p_out[row * D + col] = pr[j][e];
      }
    }
  if (u_out != nullptr) {  // the quad's four lanes hold a row's columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u[h] += __shfl_xor_sync(0xffffffffu, u[h], 1);
      u[h] += __shfl_xor_sync(0xffffffffu, u[h], 2);
      if (tig == 0 && rows[h] < C) u_out[rows[h]] = u[h];
    }
  }
}

template <int NT>
int tc_launch(const float* q, const float* p, const float* A, const float* b, const float* im,
              const float* eps, int C, int D, int num_steps, float* q_out, float* p_out,
              float* u_out, cudaStream_t stream, int* grid) {
  const int64_t bytes = tc_smem_bytes(NT);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quadratic_leapfrog_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int chains = 16 * kTcWarps;
  const int blocks = (C + chains - 1) / chains;
  grid[0] = blocks;
  grid[1] = kTcWarps * 32;
  quadratic_leapfrog_tc_kernel<NT><<<blocks, kTcWarps * 32, (size_t)bytes, stream>>>(
      q, p, A, b, im, eps, C, D, num_steps, q_out, p_out, u_out);
  return (int)cudaGetLastError();
}

// -- SIMT route --------------------------------------------------------------------------

constexpr int kLfThreads = 256;
constexpr int kLfMaxTile = 32;

struct LfShape {
  int tile;  // chains per CTA, a multiple of 4
  int rows;  // rows of A in shared memory at a time; D when resident
};

inline int64_t lf_smem_bytes(int tile, int rows, int D) {
  return ((int64_t)rows * D + 3 * (int64_t)tile * D + 2 * (int64_t)D) * (int64_t)sizeof(float);
}

// A resident beside a tile of at least 16 chains if it fits; else 32-chain
// tiles (fewer for very wide D) and A in chunks of rows.
inline LfShape lf_shape(int D) {
  for (int tile = kLfMaxTile; tile >= 16; tile -= 4)
    if (lf_smem_bytes(tile, D, D) <= kLfSmemLimit) return {tile, D};
  for (int tile = kLfMaxTile; tile >= 4; tile -= 4) {
    const int64_t free = kLfSmemLimit - lf_smem_bytes(tile, 0, D);
    const int64_t rows = free / ((int64_t)D * (int64_t)sizeof(float));  // signed: free may be < 0
    if (rows >= 8) return {tile, (int)(rows < D ? rows : D)};
  }
  return {0, 0};
}

// p -= coef (gq - b) on the elements of gs this thread wrote in lf_product.
__device__ __forceinline__ void lf_apply_kick(float* ps, const float* gs, const float* bs, int D,
                                              int tile, float coef) {
  const int col_groups = (D + 127) / 128;
  const int n_micro = (tile / 4) * col_groups * 32;
  for (int m = threadIdx.x; m < n_micro; m += blockDim.x) {
    const int jt = m & 31, rest = m >> 5;
    const int jb = rest % col_groups, cg = rest / col_groups;
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int cx = 0; cx < 4; ++cx) {
        const int j = jb * 128 + jt + 32 * cx;
        if (j < D) {
          const int e = (cg * 4 + y) * D + j;
          ps[e] = ps[e] - coef * (gs[e] - bs[j]);
        }
      }
  }
}

// gq = q A over the tile (chunked over rows of A when not resident), then
// p -= coef (gq - b).  Ends with __syncthreads().
__device__ __forceinline__ void lf_kick(const float* __restrict__ A, float* As, const float* qs,
                                        float* ps, float* gs, const float* bs, int D, int tile,
                                        int rows, float coef) {
  const int col_groups = (D + 127) / 128;
  const int n_micro = (tile / 4) * col_groups * 32;
  const bool resident = rows == D;
  for (int k0 = 0; k0 < D; k0 += rows) {
    const int kn = min(rows, D - k0);
    if (!resident) {
      __syncthreads();
      for (int64_t e = threadIdx.x; e < (int64_t)kn * D; e += blockDim.x)
        As[e] = A[(int64_t)k0 * D + e];
      __syncthreads();
    }
    for (int m = threadIdx.x; m < n_micro; m += blockDim.x) {
      const int jt = m & 31, rest = m >> 5;
      const int jb = rest % col_groups, cg = rest / col_groups;
      float acc[4][4] = {};
      for (int kk = 0; kk < kn; ++kk) {
        float a[4], x[4];
#pragma unroll
        for (int cx = 0; cx < 4; ++cx) {
          const int j = jb * 128 + jt + 32 * cx;
          a[cx] = j < D ? As[(int64_t)kk * D + j] : 0.0f;
        }
#pragma unroll
        for (int y = 0; y < 4; ++y) x[y] = qs[(cg * 4 + y) * D + k0 + kk];
#pragma unroll
        for (int y = 0; y < 4; ++y)
#pragma unroll
          for (int cx = 0; cx < 4; ++cx) acc[y][cx] = fmaf(x[y], a[cx], acc[y][cx]);
      }
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int cx = 0; cx < 4; ++cx) {
          const int j = jb * 128 + jt + 32 * cx;
          if (j < D) {
            float* g = gs + (cg * 4 + y) * D + j;
            *g = k0 == 0 ? acc[y][cx] : *g + acc[y][cx];
          }
        }
    }
  }
  lf_apply_kick(ps, gs, bs, D, tile, coef);
  __syncthreads();
}

__global__ void __launch_bounds__(kLfThreads)
quadratic_leapfrog_kernel(const float* __restrict__ q, const float* __restrict__ p,
                          const float* __restrict__ A, const float* __restrict__ b,
                          const float* __restrict__ im, const float* __restrict__ eps_ptr,
                          int C, int D, int num_steps, int tile, int rows,
                          float* __restrict__ q_out, float* __restrict__ p_out,
                          float* __restrict__ u_out) {
  extern __shared__ float smem[];
  float* As = smem;
  float* qs = As + (int64_t)rows * D;
  float* ps = qs + tile * D;
  float* gs = ps + tile * D;
  float* bs = gs + tile * D;
  float* ims = bs + D;
  const int64_t c0 = (int64_t)blockIdx.x * tile;
  const int valid = (int)min((int64_t)tile, C - c0);
  for (int e = threadIdx.x; e < tile * D; e += blockDim.x) {
    const bool in = e / D < valid;
    qs[e] = in ? q[c0 * D + e] : 0.0f;
    ps[e] = in ? p[c0 * D + e] : 0.0f;
  }
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    bs[j] = b[j];
    ims[j] = im[j];
  }
  if (rows == D)
    for (int64_t e = threadIdx.x; e < (int64_t)D * D; e += blockDim.x) As[e] = A[e];
  __syncthreads();
  const float eps = *eps_ptr;
  lf_kick(A, As, qs, ps, gs, bs, D, tile, rows, 0.5f * eps);
  for (int l = 0; l < num_steps; ++l) {
    for (int e = threadIdx.x; e < tile * D; e += blockDim.x)
      qs[e] = qs[e] + eps * (ps[e] * ims[e % D]);
    __syncthreads();
    lf_kick(A, As, qs, ps, gs, bs, D, tile, rows, eps);
  }
  // gs holds q A at the final q: the trailing kick to a half, on the
  // elements each thread's product wrote
  lf_apply_kick(ps, gs, bs, D, tile, -(0.5f * eps));
  __syncthreads();
  for (int e = threadIdx.x; e < valid * D; e += blockDim.x) {
    q_out[c0 * D + e] = qs[e];
    p_out[c0 * D + e] = ps[e];
  }
  if (u_out != nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = warp; c < valid; c += kLfThreads / 32) {
      float acc = 0.0f;
      for (int j = lane; j < D; j += 32)
        acc = fmaf(qs[c * D + j], 0.5f * gs[c * D + j] - bs[j], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) u_out[c0 + c] = acc;
    }
  }
}

int simt_launch(const float* q, const float* p, const float* A, const float* b, const float* im,
                const float* eps, int C, int D, int num_steps, float* q_out, float* p_out,
                float* u_out, cudaStream_t stream, int* grid) {
  const LfShape s = lf_shape(D);
  const int64_t bytes = lf_smem_bytes(s.tile, s.rows, D);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quadratic_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + s.tile - 1) / s.tile;
  grid[0] = blocks;
  grid[1] = kLfThreads;
  quadratic_leapfrog_kernel<<<blocks, kLfThreads, (size_t)bytes, stream>>>(
      q, p, A, b, im, eps, C, D, num_steps, s.tile, s.rows, q_out, p_out, u_out);
  return (int)cudaGetLastError();
}

// 1: the tensor route; 0: the SIMT route; -1: D too wide for either
inline int lf_route(int D) {
  if (D >= 1 && D <= 8 * kTcMaxTiles) return 1;
  return lf_shape(D).tile > 0 ? 0 : -1;
}

}  // namespace binf

// The route a launch at this D takes: 1 tensor cores, 0 SIMT, -1 too wide.
extern "C" int binf_quadratic_leapfrog_route(int D) { return binf::lf_route(D); }

// grid (3 ints) receives the launch's CTAs, threads a CTA and route.
extern "C" int binf_quadratic_leapfrog(const float* q, const float* p, const float* A,
                                       const float* b, const float* im, const float* eps,
                                       int C, int D, int num_steps, float* q_out, float* p_out,
                                       float* u_out, void* stream, int* grid) {
  const int route = binf::lf_route(D);
  if (route < 0 || C <= 0 || num_steps < 0) return cudaErrorInvalidValue;
  grid[2] = route;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return binf::simt_launch(q, p, A, b, im, eps, C, D, num_steps, q_out, p_out, u_out, s, grid);
  switch ((D + 7) / 8) {
#define BINF_TC_CASE(NT)                                                                    \
  case NT:                                                                                  \
    return binf::tc_launch<NT>(q, p, A, b, im, eps, C, D, num_steps, q_out, p_out, u_out, s, \
                               grid);
    BINF_TC_CASE(1) BINF_TC_CASE(2) BINF_TC_CASE(3) BINF_TC_CASE(4)
    BINF_TC_CASE(5) BINF_TC_CASE(6) BINF_TC_CASE(7) BINF_TC_CASE(8)
    BINF_TC_CASE(9) BINF_TC_CASE(10) BINF_TC_CASE(11) BINF_TC_CASE(12)
    BINF_TC_CASE(13) BINF_TC_CASE(14) BINF_TC_CASE(15) BINF_TC_CASE(16)
#undef BINF_TC_CASE
  }
  return cudaErrorInvalidValue;
}
