// The row tile of sweep.cu's kernels (kSegCells cells a thread) and its
// shared-memory carries and tails per (step, phase) slot (SegShared), which
// the cluster wavefronts of B1, B2, B4 and B5 (sweep.cu) and B11
// (adjoint.cu; wave.cuh holds their bodies), B8's look-back (sharded.cu)
// and B3's one-block walk share (B13, fused.cu, the tile alone); the row's
// inflow and outflow records; and the one-sub-step row walk
// (substep_segment), where one thread block owns one row and loops over its
// tiles, which only B3 (sweep.cu substep_kernel) runs.

#pragma once

#include <cstddef>

#include "tiles.cuh"

namespace {

constexpr int kSegCells = 8;       // consecutive cells per thread
constexpr int kSegThreads = 512;   // at most, a row block
constexpr int kMaxSlots = 256;     // 4*K phase carries, K <= 64
constexpr int kMaxSteps = kMaxSlots / 4;

struct SegShared {
  float carry[kMaxSlots];      // per-(step, phase) carry entering the tile
  float etail[kMaxSteps];      // per-step upwind p1 edge of the previous tile
  float htail[kMaxSteps];      // per-step upwind h1 edge of the previous tile
  float scanA[2][32];          // cross-warp scan, double-buffered
  float scanB[2][32];
  float edge_p[32];            // last cell of each warp, for the p1 shift
  float edge_h[32];            // last cell of each warp, for the h1 shift
};

__device__ __forceinline__ void copy_cells(float (&dst)[kSegCells],
                                           const float (&src)[kSegCells]) {
#pragma unroll
  for (int c = 0; c < kSegCells; ++c) dst[c] = src[c];
}

// Carries entering a row: s of the slot's phase times the boundary value,
// or for the mu>0 half of a reflective slab the recorded mu<0 outflow of the
// flipped row.
__device__ __forceinline__ void init_row(SegShared& sm, int slots, int steps,
                                         const float* s_of, int phases,
                                         const float* __restrict__ bc,
                                         const int* __restrict__ flip,
                                         const float* rec, int h, int row,
                                         int hr, int reflective) {
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float in =
        (h == 1 && reflective) ? rec[flip[row] * slots + i] : bc[hr];
    sm.carry[i] = s_of[i % phases] * in;
  }
  for (int i = threadIdx.x; i < steps; i += blockDim.x) {
    sm.etail[i] = 0.f;
    sm.htail[i] = 0.f;
  }
  __syncthreads();
}

// Writes the carries leaving the row's last cell, one per slot.
__device__ __forceinline__ void write_record(const SegShared& sm, int slots,
                                             float* rec) {
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += blockDim.x) rec[i] = sm.carry[i];
}

// The mu<0 half of a reflective slab records its outflow carries.
__device__ __forceinline__ void record_row(const SegShared& sm, int slots,
                                           float* rec, int h, int row,
                                           int reflective) {
  if (h == 0 && reflective) write_record(sm, slots, rec + row * slots);
}

// One sub-step of kind KIND over the N cells of one row (pointers are the
// row's), in tiles from cell 0 (B3): the carry and the upwind p1/h1 tails start
// where the caller left them, in sm.carry[0], sm.etail[0] and sm.htail[0].
// load(j0, x0, x1, p0, p1, q0, q1) fills the thread's cells from j0 of the
// planes KIND reads: e (x0, x1); CN also p1; BDF also p0, p1 and h (q0, q1).
template <int KIND, class Load>
__device__ __forceinline__ void substep_segment(const Coef& kc,
                                                const Load& load,
                                                float* __restrict__ o0g,
                                                float* __restrict__ o1g,
                                                int N, SegShared& sm,
                                                int& buf) {
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  const int tile = blockDim.x * kSegCells;
  for (int t0 = 0; t0 < N; t0 += tile) {
    const int j0 = t0 + threadIdx.x * kSegCells;
    const int owner = tile_owner(t0, j0, tile, N, kSegCells);
    float x0[kSegCells], x1[kSegCells], p0[kSegCells], p1[kSegCells],
        q0[kSegCells], q1[kSegCells], f0[kSegCells], f1[kSegCells];
    load(j0, x0, x1, p0, p1, q0, q1);
    if constexpr (KIND == kBE) {
      substep_tile<kBE>(kc, x0, x1, x0, x1, x0, x1, 0.f, 0.f, sm.carry,
                        owner, sm, buf, f0, f1);
    } else if constexpr (KIND == kCN) {
      const float p1_up =
          upwind_value(p1[kSegCells - 1], sm.etail, sm.edge_p);
      substep_tile<kCN>(kc, x0, x1, x0, p1, x0, x1, p1_up, 0.f, sm.carry,
                        owner, sm, buf, f0, f1);
      if (tail_thread) sm.etail[0] = p1[kSegCells - 1];
    } else {
      const float p1_up =
          upwind_value(p1[kSegCells - 1], sm.etail, sm.edge_p);
      const float h1_up =
          upwind_value(q1[kSegCells - 1], sm.htail, sm.edge_h);
      substep_tile<kBDF>(kc, x0, x1, p0, p1, q0, q1, p1_up, h1_up, sm.carry,
                         owner, sm, buf, f0, f1);
      if (tail_thread) {
        sm.etail[0] = p1[kSegCells - 1];
        sm.htail[0] = q1[kSegCells - 1];
      }
    }
    store_cells(o0g, j0, N, f0);
    store_cells(o1g, j0, N, f1);
  }
}

}  // namespace
