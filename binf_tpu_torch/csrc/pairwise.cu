// Pairwise-distance restraint loss (K6a) and its row forces (K6b).
//
// Replaces binf_tpu/ops/pallas/pairwise.py::_fwd_kernel and ::_bwd_kernel
// (pairwise_restraint_loss_pallas).  For X (N, 3) and row-major (N, N)
// matrices logD and W:
//
//   loss      = sum_ij W_ij r_ij^2,         r_ij = 1/2 log(d2_ij + eps) - logD_ij
//   forces_i  = 2 sum_j (W r / d2)_ij (x_i - x_j)
//
// with d2 + eps formed as the TPU kernel forms it (pairwise.py:89).  The TPU
// walks (block x block) tiles on a sequential grid and carries the scalar
// (or a row of forces) from one grid step to the next.  Here blocks run in
// any order, so each block of 8 warps takes a tile of kRows rows by kCols
// columns and writes one partial: the tile's loss, or each row's force
// over the tile's columns.  A second, one-block (loss) or one-thread-a-row
// (forces) pass sums the partials in a fixed order, so a result is the
// same bit for bit from run to run: no float atomics.
//
// Inside a tile each warp owns kRows / 8 rows; its lanes walk the row's
// kCols columns 32 apart, so a warp reads 32 consecutive floats of W and of
// logD at a time (coalesced), and the tile's coordinates sit in shared
// memory.  Lane sums are combined by a fixed xor-shuffle tree.
//
// Bound: bytes.  Both kernels read W and logD once, 8 N^2 bytes (33.5 MB at
// N = 2048, 10 us at 3.35 TB/s); the arithmetic is ~20 float operations and
// one log per pair (one division more for the forces).

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"

namespace binf {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // rows of a tile: two per warp
constexpr int kCols = 256;     // columns of a tile: eight per lane
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// kForces false: partial[tile] = the tile's loss, tiles numbered
// row-block-major.  kForces true: partial[(col_block * n + i) * 3 + c] =
// 2 sum_j coef_ij diff_ij(c) over the tile's columns.
template <bool kForces>
__global__ void __launch_bounds__(kThreads)
pairwise_tile_kernel(const float* __restrict__ X, const float* __restrict__ logD,
                     const float* __restrict__ W, int n, float* __restrict__ partial) {
  __shared__ float xr[kRows][3];
  __shared__ float xc[3][kCols];
  __shared__ float warp_loss[kThreads / 32];
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int row0 = rb * kRows, col0 = cb * kCols;
  for (int t = threadIdx.x; t < kCols; t += blockDim.x) {
    const int j = col0 + t;
#pragma unroll
    for (int c = 0; c < 3; ++c) xc[c][t] = j < n ? X[(int64_t)j * 3 + c] : 0.0f;
  }
  if (threadIdx.x < kRows * 3) {
    const int r = threadIdx.x / 3, c = threadIdx.x % 3;
    xr[r][c] = row0 + r < n ? X[(int64_t)(row0 + r) * 3 + c] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cols = min(kCols, n - col0);
  float loss = 0.0f;
#pragma unroll
  for (int rr = 0; rr < kRows / (kThreads / 32); ++rr) {
    const int r = warp * (kRows / (kThreads / 32)) + rr;
    const int i = row0 + r;
    if (i >= n) break;  // uniform over the warp
    const float* w_row = W + (int64_t)i * n + col0;
    const float* t_row = logD + (int64_t)i * n + col0;
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
    for (int t = lane; t < cols; t += 32) {
      const float dx = xr[r][0] - xc[0][t];
      const float dy = xr[r][1] - xc[1][t];
      const float dz = xr[r][2] - xc[2][t];
      float d2 = kEps;
      d2 = d2 + dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      const float w = w_row[t];
      const float res = 0.5f * logf(d2) - t_row[t];
      if (kForces) {
        const float coef = w * res / d2;
        f0 += coef * dx;
        f1 += coef * dy;
        f2 += coef * dz;
      } else {
        loss += w * res * res;
      }
    }
    if (kForces) {
      f0 = warp_sum(f0);
      f1 = warp_sum(f1);
      f2 = warp_sum(f2);
      if (lane == 0) {
        float* out = partial + ((int64_t)cb * n + i) * 3;
        out[0] = 2.0f * f0;
        out[1] = 2.0f * f1;
        out[2] = 2.0f * f2;
      }
    }
  }
  if (!kForces) {
    loss = warp_sum(loss);
    if (lane == 0) warp_loss[warp] = loss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int k = 0; k < kThreads / 32; ++k) s += warp_loss[k];
      partial[(int64_t)rb * gridDim.x + cb] = s;
    }
  }
}

// One block: each thread sums a strided share of the partials in order,
// then a fixed tree over the threads.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int count, float* __restrict__ out) {
  __shared__ float s[kThreads];
  float acc = 0.0f;
  for (int k = threadIdx.x; k < count; k += kThreads) acc += partial[k];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

// forces[i][c] = sum over column blocks, in order
__global__ void sum_forces_kernel(const float* __restrict__ partial, int n_col_blocks, int n,
                                  float* __restrict__ forces) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (int64_t)n * 3) return;
  float acc = 0.0f;
  for (int cb = 0; cb < n_col_blocks; ++cb) acc += partial[(int64_t)cb * n * 3 + k];
  forces[k] = acc;
}

inline dim3 tile_grid(int n) { return dim3((n + kCols - 1) / kCols, (n + kRows - 1) / kRows); }

}  // namespace binf

// Scratch sizes the caller allocates: binf_pairwise_loss needs
// tiles(n) floats, binf_pairwise_forces col_blocks(n) * n * 3.
extern "C" int binf_pairwise_tiles(int n) {
  const dim3 g = binf::tile_grid(n);
  return (int)(g.x * g.y);
}

extern "C" int binf_pairwise_col_blocks(int n) { return (int)binf::tile_grid(n).x; }

extern "C" int binf_pairwise_loss(const float* X, const float* logD, const float* W, int n,
                                  float* partial, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = binf::tile_grid(n);
  binf::pairwise_tile_kernel<false><<<grid, binf::kThreads, 0, s>>>(X, logD, W, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  binf::sum_partials_kernel<<<1, binf::kThreads, 0, s>>>(partial, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

extern "C" int binf_pairwise_forces(const float* X, const float* logD, const float* W, int n,
                                    float* partial, float* forces, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = binf::tile_grid(n);
  binf::pairwise_tile_kernel<true><<<grid, binf::kThreads, 0, s>>>(X, logD, W, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n * 3 + binf::kThreads - 1) / binf::kThreads;
  binf::sum_forces_kernel<<<blocks, binf::kThreads, 0, s>>>(partial, (int)grid.x, n, forces);
  return (int)cudaGetLastError();
}
