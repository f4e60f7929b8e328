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
// any order.
//
// The loss (K6a): each block of 8 warps takes a tile of kRows rows by kCols
// columns and writes the tile's loss as one partial; a second, one-block
// pass sums the partials in a fixed order.  Each warp owns kRows / 8 rows;
// its lanes walk the row's kCols columns 32 apart, so a warp reads 32
// consecutive floats of W and of logD at a time (coalesced), and the tile's
// coordinates sit in shared memory.
//
// The forces (K6b): one launch, no partials.  A warp owns a whole row across
// all N columns (pairwise_forces_kernel), so a row's force is summed where
// it is made.  Both are the same bit for bit from run to run: lane sums
// combined by a fixed xor-shuffle tree, no float atomics.  W and logD are not
// assumed symmetric: both fields are read in full, as the TPU kernel reads
// them.
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
constexpr int kFRows = kThreads / 32;  // forces: rows a CTA, one a warp
constexpr int kXCols = 4096;           // forces: columns of X staged at a time (48 KB)
constexpr int kRing = 4;               // forces: a lane's ring slots of W and logD in flight

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// partial[tile] = the tile's loss, tiles numbered row-block-major.
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
      loss += w * res * res;
    }
  }
  loss = warp_sum(loss);
  if (lane == 0) warp_loss[warp] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) s += warp_loss[k];
    partial[(int64_t)rb * gridDim.x + cb] = s;
  }
}

// 16-byte copy from device to shared memory that completes asynchronously
// (cp.async; src_size 0 fills zeros and reads nothing)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

// One pair's force coefficient w r / d2, times (x_i - x_j), into f.  The
// division is __fdividef (within 2 ulp) where IEEE division's slow-path
// branch cost ~10 us a launch at 2,048 beads, and the log __logf (absolute
// error under 2^-21.4 on [0.5, 2], 3 ulp elsewhere), ~3 us more.
__device__ __forceinline__ void force_pair(const float (&xi)[3], float xj0, float xj1, float xj2,
                                           float w, float t, float (&f)[3]) {
  const float dx = xi[0] - xj0;
  const float dy = xi[1] - xj1;
  const float dz = xi[2] - xj2;
  float d2 = kEps;
  d2 = d2 + dx * dx;
  d2 = d2 + dy * dy;
  d2 = d2 + dz * dz;
  const float res = 0.5f * __logf(d2) - t;
  const float coef = __fdividef(w * res, d2);
  f[0] += coef * dx;
  f[1] += coef * dy;
  f[2] += coef * dz;
}

// The forces: one warp a row across all n columns, kFRows rows a CTA, in
// one pass.  X sits in shared memory as three planes, kXCols columns at a
// time (n > kXCols walks chunks).  With kVec (n a multiple of 4, W and logD
// 16-byte aligned) each lane streams its 16-byte pieces of W and logD (4
// columns, 128 columns a warp an iteration) through a ring of kRing slots
// of its own in shared memory by cp.async, kRing - 1 iterations ahead, so
// the loads stay in flight while the pairs are computed and no register
// holds them; else one column at a time.  Each lane sums its columns in
// order and the warp's lanes by a fixed xor tree: no atomics, the same bits
// every run.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pairwise_forces_kernel(const float* __restrict__ X, const float* __restrict__ logD,
                       const float* __restrict__ W, int n, int cols,
                       float* __restrict__ forces) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // x, y, z planes of cols floats each, then the lanes' rings
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kFRows + warp;
  const bool row = i < n;  // uniform over the warp
  float xi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) xi[c] = row ? X[(int64_t)i * 3 + c] : 0.0f;
  float f[3] = {0.0f, 0.0f, 0.0f};
  const float* w_row = W + (int64_t)(row ? i : 0) * n;
  const float* t_row = logD + (int64_t)(row ? i : 0) * n;

  // ring slot s of this lane: W at ring[(s * 2) * 32 + lane], logD 32 further
  float4* ring = reinterpret_cast<float4*>(smem + 3 * cols) + warp * kRing * 64;
  const int n4 = n / 4, iters = (n4 + 31) / 32;
  const auto issue = [&](int it) {  // the lane's piece lane + 32 it into slot it % kRing
    const int v = lane + 32 * it;
    const bool in = row && v < n4;
    float4* slot = ring + (it % kRing) * 64;
    cp_async16(slot + lane, reinterpret_cast<const float4*>(w_row) + (in ? v : 0), in);
    cp_async16(slot + 32 + lane, reinterpret_cast<const float4*>(t_row) + (in ? v : 0), in);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kRing - 1; ++k) issue(k);
  }
  int it = 0;
  for (int c0 = 0; c0 < n; c0 += cols) {
    const int cn = min(cols, n - c0);
    if (c0 > 0) __syncthreads();
    for (int t = threadIdx.x; t < cn; t += blockDim.x)
#pragma unroll
      for (int c = 0; c < 3; ++c) xs[c * cols + t] = X[(int64_t)(c0 + t) * 3 + c];
    __syncthreads();
    if (kVec) {
      // cols is a multiple of 128, so a chunk holds whole iterations
      const float4* x4 = reinterpret_cast<const float4*>(xs);
      const int plane4 = cols / 4, it_end = min(iters, (c0 + cn + 127) / 128);
      for (; it < it_end; ++it) {
        asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
        issue(it + kRing - 1);  // into the slot the last iteration read
        const float4 w = ring[(it % kRing) * 64 + lane];
        const float4 t = ring[(it % kRing) * 64 + 32 + lane];
        const int v = lane + 32 * it;
        if (!row || v >= n4) continue;
        const int vl = v - c0 / 4;
        const float4 a = x4[vl], b = x4[plane4 + vl], c = x4[2 * plane4 + vl];
        force_pair(xi, a.x, b.x, c.x, w.x, t.x, f);
        force_pair(xi, a.y, b.y, c.y, w.y, t.y, f);
        force_pair(xi, a.z, b.z, c.z, w.z, t.z, f);
        force_pair(xi, a.w, b.w, c.w, w.w, t.w, f);
      }
    } else if (row) {
      for (int t = lane; t < cn; t += 32)
        force_pair(xi, xs[t], xs[cols + t], xs[2 * cols + t], w_row[c0 + t], t_row[c0 + t], f);
    }
  }
  if (kVec) asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (!row) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) f[c] = warp_sum(f[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) forces[(int64_t)i * 3 + c] = 2.0f * f[c];
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

inline dim3 tile_grid(int n) { return dim3((n + kCols - 1) / kCols, (n + kRows - 1) / kRows); }

}  // namespace binf

// Scratch floats the caller allocates for binf_pairwise_loss: tiles(n).
extern "C" int binf_pairwise_tiles(int n) {
  const dim3 g = binf::tile_grid(n);
  return (int)(g.x * g.y);
}

// launched (2 ints) receives the tile kernel's grid: CTAs and threads a CTA.
extern "C" int binf_pairwise_loss(const float* X, const float* logD, const float* W, int n,
                                  float* partial, float* out, void* stream, int* launched) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = binf::tile_grid(n);
  launched[0] = (int)(grid.x * grid.y);
  launched[1] = binf::kThreads;
  binf::pairwise_tile_kernel<<<grid, binf::kThreads, 0, s>>>(X, logD, W, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  binf::sum_partials_kernel<<<1, binf::kThreads, 0, s>>>(partial, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

// launched (3 ints) receives the grid (CTAs, threads a CTA) and whether the
// 16-byte loads ran.
extern "C" int binf_pairwise_forces(const float* X, const float* logD, const float* W, int n,
                                    float* forces, void* stream, int* launched) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + binf::kFRows - 1) / binf::kFRows;
  const bool vec = n % 4 == 0 && ((uintptr_t)logD | (uintptr_t)W) % 16 == 0;
  // the 16-byte route stages whole 128-column iterations of X and keeps
  // each lane's ring: 3 cols + 8 warps x kRing x 64 x 4 floats
  const int cols = vec ? min((n + 127) & ~127, binf::kXCols) : min((n + 3) & ~3, binf::kXCols);
  const size_t smem =
      (3 * (size_t)cols + (vec ? (size_t)binf::kFRows * binf::kRing * 64 * 4 : 0)) * sizeof(float);
  launched[0] = blocks;
  launched[1] = binf::kThreads;
  launched[2] = vec;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(binf::pairwise_forces_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    binf::pairwise_forces_kernel<true><<<blocks, binf::kThreads, smem, s>>>(X, logD, W, n, cols,
                                                                           forces);
  } else {
    binf::pairwise_forces_kernel<false><<<blocks, binf::kThreads, smem, s>>>(X, logD, W, n,
                                                                            cols, forces);
  }
  return (int)cudaGetLastError();
}
