// The row-tile machinery shared by the sweep kernels (sweep.cu), the
// double-float sweep kernels (df_sweep.cu) and the adjoint kernels
// (adjoint.cu), where one thread block walks one row in tiles of blockDim*C
// cells, C consecutive cells a thread: the block-wide scan of affine maps
// that stands in for the TPU kernels' Hillis-Steele prefix (_hillis_steele),
// the exchange of the value upwind of each thread's first cell, the cell
// loads and stores with the ragged-tile rule, the launch of the two
// direction halves, and the float32 sub-step of one tile (substep_tile),
// which the sweep kernels and the adjoint's forward and recompute share, so
// that the adjoint's step is the sweep's by construction.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan over a warp of the maps x -> A*x + B in lane order
// ("f then g" composes to (gA*fA, gA*fB + gB)). With kOneMinus the maps
// are x -> (1 - A)*x + B, A carrying 1 minus the multiplier ("f then g":
// (gA + (fA - gA*fA), gB + (fB - gA*fB))): the double-float kernels'
// form, in which a multiplier near 1 keeps the relative precision of its
// distance from 1 (df_sweep.cu, KindCoef::g). The identity is (1, 0), or
// (0, 0) with kOneMinus.
template <bool kOneMinus = false>
__device__ __forceinline__ void warp_inclusive_scan(float& A, float& B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pA = __shfl_up_sync(kFull, A, d);
    const float pB = __shfl_up_sync(kFull, B, d);
    if (lane >= d) {
      if constexpr (kOneMinus) {
        B = B + (pB - A * pB);
        A = A + (pA - A * pA);
      } else {
        B = A * pB + B;
        A = A * pA;
      }
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
// cross-warp totals `float scanA[2][32], scanB[2][32]`. kOneMinus: the
// maps of warp_inclusive_scan<true>, (exA, exB) in the same form.
template <bool kOneMinus = false, class S>
__device__ __forceinline__ float block_exclusive_scan(
    float A, float B, const float* carry, S& sm, int& buf, float& exA,
    float& exB) {
  constexpr float kIdA = kOneMinus ? 0.f : 1.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_inclusive_scan<kOneMinus>(A, B);
  if (lane == 31) {
    sm.scanA[buf][warp] = A;
    sm.scanB[buf][warp] = B;
  }
  __syncthreads();
  const float c_in = *carry;
  if (warp == 0) {
    float wA = lane < nwarps ? sm.scanA[buf][lane] : kIdA;
    float wB = lane < nwarps ? sm.scanB[buf][lane] : 0.f;
    warp_inclusive_scan<kOneMinus>(wA, wB);
    float xA = __shfl_up_sync(kFull, wA, 1);
    float xB = __shfl_up_sync(kFull, wB, 1);
    if (lane == 0) {
      xA = kIdA;
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
    tA = kIdA;
    tB = 0.f;
  }
  if constexpr (kOneMinus) {
    exA = tA + (wA - tA * wA);
    exB = tB + (wB - tA * wB);
  } else {
    exA = tA * wA;
    exB = tA * wB + tB;
  }
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

constexpr int kBE = 1, kCN = 2, kBDF = 3;  // sub-step kinds
constexpr int kNCoef = 10;  // f32 pack: w T0 q idet a Sb c1 c0 kee kp

struct Coef {
  float w, T0, q, idet, a, Sb, c1, c0, kee, kp;
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ c) {
  Coef k;
  k.w = c[0];
  k.T0 = c[1];
  k.q = c[2];
  k.idet = c[3];
  k.a = c[4];
  k.Sb = c[5];
  k.c1 = c[6];
  k.c0 = c[7];
  k.kee = c[8];
  k.kp = c[9];
  return k;
}

// The right-hand sides r0, r1 of one cell of a sub-step of kind KIND: e the
// sub-step's own state, p/h its history planes, sp/sh the p1/h1 values of
// the cell upwind (the shift1 terms of CN and BDF).
template <int KIND>
__device__ __forceinline__ void rhs(const Coef& k, float e0, float e1,
                                    float p0, float p1, float h0, float h1,
                                    float sp, float sh, float& r0,
                                    float& r1) {
  const float psi = 0.5f * (e0 + e1);
  const float S = k.Sb + k.c1 * psi + k.c0;
  if constexpr (KIND == kBE) {
    r0 = S + k.kee * e0;
    r1 = S + k.kee * e1;
  } else if constexpr (KIND == kCN) {
    r0 = S + k.kee * e0 - k.q * e1 + k.w * sp;
    r1 = S + k.q * e0 + k.kee * e1;
  } else {
    r0 = S + k.kee * h0 - 2.f * k.w * h1 - k.kp * p0 - k.q * p1 +
         k.w * (4.f * sh + sp);
    r1 = S + 2.f * k.w * h0 + k.kee * h1 + k.q * p0 - k.kp * p1;
  }
}

// The first stage of substep_tile: the right-hand sides r0, r1 and b of
// the thread's C cells, and the composed map (A, B) of their carries.
template <int KIND, int C>
__device__ __forceinline__ void substep_rhs(
    const Coef& k, const float (&e0)[C], const float (&e1)[C],
    const float (&p0)[C], const float (&p1)[C], const float (&h0)[C],
    const float (&h1)[C], float p1_up, float h1_up, float (&r0)[C],
    float (&r1)[C], float (&b)[C], float& A, float& B) {
  A = 1.f;
  B = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    rhs<KIND>(k, e0[c], e1[c], p0[c], p1[c], h0[c], h1[c],
              c ? p1[c - 1] : p1_up, c ? h1[c - 1] : h1_up, r0[c], r1[c]);
    b[c] = (k.q * r0[c] + k.T0 * r1[c]) * k.idet;
    B = k.a * B + b[c];
    A = A * k.a;
  }
}

// The last stage of substep_tile: the 2x2 reconstruction of the thread's
// cells from `cur`, the carry entering its first cell; the owner of the
// tile's last real cell (`owner` its index, or -1) writes the carry leaving
// it to *carry, and `cin` (if given) gets each cell's entering carry.
template <int C>
__device__ __forceinline__ void substep_out(const Coef& k,
                                            const float (&r0)[C],
                                            const float (&r1)[C],
                                            const float (&b)[C], float cur,
                                            float* carry, int owner,
                                            float (&o0)[C], float (&o1)[C],
                                            float* cin = nullptr) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (cin) cin[c] = cur;
    const float u = r0[c] + k.w * cur;
    o0[c] = (k.T0 * u - k.q * r1[c]) * k.idet;
    o1[c] = (k.q * u + k.T0 * r1[c]) * k.idet;
    cur = k.a * cur + b[c];
    if (c == owner) *carry = cur;
  }
}

// One sub-step of kind KIND over this thread's C cells of the tile
// (_substep_block): the right-hand sides, the exact scan of the carry
// recurrence carry_j = a*carry_{j-1} + b_j, the 2x2 reconstruction. p1_up/
// h1_up: the p1/h1 values of the cell upwind of the thread's first cell.
// *carry: the carry entering the tile, replaced by the carry leaving it by
// the thread that owns the tile's last real cell (`owner` its index among
// the thread's cells, or -1: then nothing is written). If `cin` is given it
// gets each cell's entering carry. Returns the carry entering the tile.
template <int KIND, int C, class S>
__device__ __forceinline__ float substep_tile(
    const Coef& k, const float (&e0)[C], const float (&e1)[C],
    const float (&p0)[C], const float (&p1)[C], const float (&h0)[C],
    const float (&h1)[C], float p1_up, float h1_up, float* carry, int owner,
    S& sm, int& buf, float (&o0)[C], float (&o1)[C],
    float* cin = nullptr) {
  float r0[C], r1[C], b[C], A, B;
  substep_rhs<KIND>(k, e0, e1, p0, p1, h0, h1, p1_up, h1_up, r0, r1, b, A, B);
  float exA, exB;
  const float c_in = block_exclusive_scan(A, B, carry, sm, buf, exA, exB);
  // exA * c_in + exB: the carry entering this thread's first cell.
  substep_out(k, r0, r1, b, exA * c_in + exB, carry, owner, o0, o1, cin);
  return c_in;
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
