// The row tile of sweep.cu's kernels (kSegCells cells a thread) and its
// shared-memory carries and tails per (step, phase) slot (SegShared), which
// the cluster wavefronts of B1, B2, B4 and B5 (sweep.cu) and B11
// (adjoint.cu; wave.cuh holds their bodies) and B8's look-back (sharded.cu)
// share (B3, B9 and B13, the tile alone), and the row's inflow and outflow
// records. No kernel walks a row on one block any more.

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

}  // namespace
