// The row-tile machinery shared by the sweep kernels (sweep.cu) and the
// double-float sweep kernels (df_sweep.cu), where one thread block walks one
// row in tiles of blockDim*C cells, C consecutive cells a thread: the
// block-wide scan of affine maps that stands in for the TPU kernels'
// Hillis-Steele prefix (_hillis_steele), the exchange of the value upwind of
// each thread's first cell, the cell loads and stores with the ragged-tile
// rule, and the launch of the two direction halves.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan over a warp of the maps x -> A*x + B in lane order
// ("f then g" composes to (gA*fA, gA*fB + gB)).
__device__ __forceinline__ void warp_inclusive_scan(float& A, float& B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pA = __shfl_up_sync(kFull, A, d);
    const float pB = __shfl_up_sync(kFull, B, d);
    if (lane >= d) {
      B = A * pB + B;
      A = A * pA;
    }
  }
}

// Exclusive prefix, over the block's threads in order, of each thread's map
// (A, B); also reads the carry entering the tile. The carry is read between
// the two barriers: after the previous tile's write of it (which precedes the
// writer's first barrier here) and before this tile's write (which follows
// the second). `buf` alternates between calls, so a warp that runs ahead
// into the next scan never overwrites totals that another warp still reads.
// S is the kernel's shared-memory struct; it must hold the double-buffered
// cross-warp totals `float scanA[2][32], scanB[2][32]`.
template <class S>
__device__ __forceinline__ float block_exclusive_scan(
    float A, float B, const float* carry, S& sm, int& buf, float& exA,
    float& exB) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_inclusive_scan(A, B);
  if (lane == 31) {
    sm.scanA[buf][warp] = A;
    sm.scanB[buf][warp] = B;
  }
  __syncthreads();
  const float c_in = *carry;
  if (warp == 0) {
    float wA = lane < nwarps ? sm.scanA[buf][lane] : 1.f;
    float wB = lane < nwarps ? sm.scanB[buf][lane] : 0.f;
    warp_inclusive_scan(wA, wB);
    float xA = __shfl_up_sync(kFull, wA, 1);
    float xB = __shfl_up_sync(kFull, wB, 1);
    if (lane == 0) {
      xA = 1.f;
      xB = 0.f;
    }
    if (lane < nwarps) {
      sm.scanA[buf][lane] = xA;
      sm.scanB[buf][lane] = xB;
    }
  }
  __syncthreads();
  const float wA = sm.scanA[buf][warp], wB = sm.scanB[buf][warp];
  float tA = __shfl_up_sync(kFull, A, 1);
  float tB = __shfl_up_sync(kFull, B, 1);
  if (lane == 0) {
    tA = 1.f;
    tB = 0.f;
  }
  exA = tA * wA;
  exB = tA * wB + tB;
  buf ^= 1;
  return c_in;
}

// The value of x at the cell just upwind of this thread's first cell: the
// previous thread's last cell, or *tile_tail (the previous tile's last cell)
// for thread 0. *tile_tail is read after the barrier, so the previous tile's
// write of it is visible.
__device__ __forceinline__ float upwind_value(float my_last,
                                              const float* tile_tail,
                                              float* edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v = __shfl_up_sync(kFull, my_last, 1);
  if (lane == 31) edge[warp] = my_last;
  __syncthreads();
  if (lane == 0) v = warp ? edge[warp - 1] : *tile_tail;
  return v;
}

// A thread's C cells from j0; cells past N load as 0 and are never stored
// (they lie downstream of every real cell).
template <int C>
__device__ __forceinline__ void load_cells(float (&x)[C],
                                           const float* __restrict__ g,
                                           int j0, int N) {
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = (j0 + c < N) ? g[j0 + c] : 0.f;
}

template <int C>
__device__ __forceinline__ void store_cells(float* __restrict__ g, int j0,
                                            int N, const float (&x)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (j0 + c < N) g[j0 + c] = x[c];
}

// Index among a thread's `cells` cells (from j0) of the tile's last real
// cell, or -1: the tile starts at t0 and the row's cells end at N.
__device__ __forceinline__ int tile_owner(int t0, int j0, int tile, int N,
                                          int cells) {
  const int last = min(t0 + tile, N) - 1;
  return (last >= j0 && last < j0 + cells) ? last - j0 : -1;
}

// Threads per row block: enough warps for N cells at `cells` a thread, at
// most max_threads.
inline int pick_threads(int N, int cells, int max_threads) {
  int t = (N + cells - 1) / cells;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : (t > max_threads ? max_threads : t);
}

// Launch `launch(grid, half0)` over the rows: both halves at once for a
// source boundary, else the mu<0 half and then the mu>0 half, which reads
// the former's outflow record.
template <typename Launch>
int launch_halves(int Bh, int reflective, Launch launch) {
  if (!reflective) {
    launch(2 * Bh, 0);
    return static_cast<int>(cudaGetLastError());
  }
  launch(Bh, 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch(Bh, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
