// L-step leapfrog for a quadratic potential on a tile of chains (K8).
//
// Replaces binf_tpu/ops/pallas/leapfrog.py::_leapfrog_kernel
// (quadratic_leapfrog).  For U(q) = q^T A q / 2 - b^T q over chains q (C, D),
// the gradient is q A - b (a row vector times A, as the TPU kernel and its
// lax.scan reference compute it, so a non-symmetric A acts as there):
//
//   p -= eps/2 (q A - b);  L x { q += eps (p * im);  p -= eps (q A - b) };  p += eps/2 (q A - b)
//
// One CTA of 256 threads takes a tile of TC chains (32, or fewer so that A
// fits beside the tile; a ragged last tile is masked, nothing is padded).
// The tile's q, p and q A live in shared memory for all L steps; A sits
// there too when it fits (4 D^2 bytes, 64 KB at D = 128), else it is
// streamed through shared memory in chunks of rows for every product.  A
// product is full float32 FMA, not TF32: each thread owns a 4-chain x
// 4-column block of q A (columns 32 apart, so a warp reads 32 consecutive
// floats of A and one broadcast value of q at a time) and walks k in order.
//
// When asked, the kernel also writes each chain's potential at the final q,
// U = q . (q A / 2 - b), from the last product (one warp a chain, lanes
// reduced in a fixed order), so a sampler's MH test needs no product of its
// own; with L = 0 it is U at the start.
//
// Bound: operations, 2 C D^2 flops a product and L + 1 products a call
// (this kernel forms the last gradient anew, L + 2, as the TPU kernel does);
// q, p and A are read once and q, p (and U) written once.  Register blocking gives
// 16 FMAs for 8 shared-memory loads; wgmma and TMA are the way to the card's
// rate, left for a later version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"

namespace binf {

constexpr int kLfThreads = 256;
constexpr int kLfMaxTile = 32;
constexpr int64_t kLfSmemLimit = 232448;  // 227 KB a block

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
  // each thread updates the elements of gs it wrote
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
  lf_kick(A, As, qs, ps, gs, bs, D, tile, rows, -(0.5f * eps));
  for (int e = threadIdx.x; e < valid * D; e += blockDim.x) {
    q_out[c0 * D + e] = qs[e];
    p_out[c0 * D + e] = ps[e];
  }
  if (u_out != nullptr) {  // gs holds q A at the final q
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

}  // namespace binf

// The tile and chunk a launch at this D takes (tile 0: D too wide).
extern "C" int binf_quadratic_leapfrog_tile(int D) { return binf::lf_shape(D).tile; }

extern "C" int binf_quadratic_leapfrog(const float* q, const float* p, const float* A,
                                       const float* b, const float* im, const float* eps,
                                       int C, int D, int num_steps, float* q_out, float* p_out,
                                       float* u_out, void* stream, int* grid) {
  const binf::LfShape s = binf::lf_shape(D);
  if (s.tile == 0 || C <= 0 || num_steps < 0) return cudaErrorInvalidValue;
  const int64_t bytes = binf::lf_smem_bytes(s.tile, s.rows, D);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        binf::quadratic_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + s.tile - 1) / s.tile;
  grid[0] = blocks;
  grid[1] = binf::kLfThreads;
  binf::quadratic_leapfrog_kernel<<<blocks, binf::kLfThreads, (size_t)bytes,
                                    (cudaStream_t)stream>>>(q, p, A, b, im, eps, C, D,
                                                             num_steps, s.tile, s.rows, q_out,
                                                             p_out, u_out);
  return (int)cudaGetLastError();
}
