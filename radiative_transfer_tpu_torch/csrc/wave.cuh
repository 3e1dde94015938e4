// The K-step BDF2 wavefront over (tile, slot) shared by B1 (sweep.cu
// bdf2_kernel) and the K-fused adjoint forward B11 (adjoint.cu
// fwd_record_k_kernel), and the take and give of one slot's mail, which B2
// (sweep.cu multistep_kernel) shares.
//
// A row's tiles run on the C blocks of a thread block cluster, tile t on
// block t mod C, and each (step, phase) slot's carry goes from tile t to
// tile t+1 through cluster.cuh's mailboxes, step k's upwind p1 edge with
// slot 4k and its h1 edge with slot 4k+1. The tiles, slots and arithmetic
// are those of the one-block walk (segments.cuh bdf2_segment, which B4
// keeps), so the planes are its planes to the bit. A record hook sees each
// slot's carry entering the tile, each step's upwind edges and the inputs
// of steps 1..K-1: NoRecords for B1, B11's KRecords, so B11's six planes
// are B1's to the bit and its records those of K chained B9 launches.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster.cuh"
#include "segments.cuh"

namespace {

// Per slot the mail is the carry leaving the tile (field 0) and, where the
// slot carries one, a tail (field 1).
using WaveMail = Mailbox<2, kMaxSlots>;

// The row a cluster block of a B1, B2 or B11 launch works on: the cluster
// of C blocks at blockIdx.x / C owns row `row` of half h (hr = h * Bh +
// row), block `rank` its tiles rank, rank + C, ...
struct WaveRow {
  int C, rank, row, h, hr;
};

__device__ __forceinline__ WaveRow wave_row(int Bh, int half0) {
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  WaveRow w;
  w.C = static_cast<int>(cluster.num_blocks());
  w.rank = static_cast<int>(cluster.block_rank());
  const int cr = blockIdx.x / w.C;
  w.row = cr % Bh;
  w.h = half0 + cr / Bh;
  w.hr = w.h * Bh + w.row;
  return w;
}

// Tile t > 0 takes slot s's carry, and where `tail` is given the tail the
// slot carries, from its mailbox: thread 0 waits, then copies. No barrier
// follows: the other threads first read the carry inside the slot's scan,
// after its first barrier, and only thread 0 reads a tail (upwind_value,
// after the next barrier); the copy overwrites state last read C tiles ago.
template <int F, int S>
__device__ __forceinline__ void take(SegShared& sm, Mailbox<F, S>& mb, int s,
                                     float* tail, uint32_t parity) {
  if (threadIdx.x == 0) {
    const float* m = wait_mail(mb, s, parity);
    sm.carry[s] = m[0];
    if constexpr (F > 1) {
      if (tail) *tail = m[1];
    }
  }
}

// Slot s's carry, by the thread that wrote it in substep_tile (the owner of
// the full tile's last cell, which also holds the tile's last cell of every
// plane), and the tail if the slot carries one, into block `next`'s
// mailbox.
template <int F, int S>
__device__ __forceinline__ void give(const SegShared& sm, Mailbox<F, S>& mb,
                                     int s, uint32_t next, float tail,
                                     bool has_tail) {
  float m[F];
  m[0] = sm.carry[s];
  if constexpr (F > 1) m[1] = tail;
  send_mail(mb, s, next, m, has_tail ? F : 1);
}

// bdf2_wave's record hook for B1: nothing is kept.
struct NoRecords {
  __device__ __forceinline__ void input(int, int, int,
                                        const float (&)[kSegCells],
                                        const float (&)[kSegCells]) const {}
  __device__ __forceinline__ void carry(int, int, float) const {}
  __device__ __forceinline__ void edges(int, int, float, float) const {}
};

// K whole BDF2 steps, each BE(dt/2), CN(dt/2), BE(dt/2) and the BDF
// corrector, over the N cells of one row (pointers are the row's), as this
// block's share of the row's wavefront: tiles rank, rank + C, ... of the
// cluster's C blocks. The carries and tails in shared memory start as
// init_row left them (they serve tile 0; the mailboxes, opened before,
// bring every later tile's). The half snapshot is the CN output where
// snap_cn, else the phase-0 BE output. At tile t it hands `rec` step k's
// input cells (k >= 1: input(k, j0, N, x0, x1), every thread), each (step,
// phase) slot's carry entering the tile (carry(t, slot, c), every thread,
// the same value, read inside the slot's scan) and step k's upwind e1 and
// hs1 edges (edges(t, k, e1, hs1), every thread; thread 0's are the values
// upwind of the tile). The block that runs the row's last tile holds the
// outflow carries and writes them to `outflow` (one a slot) unless it is
// null.
template <class Rec = NoRecords>
__device__ __forceinline__ void bdf2_wave(
    const Coef& kbe, const Coef& kcn, const Coef& kbdf, bool snap_cn,
    const float* __restrict__ e0g, const float* __restrict__ e1g,
    float* __restrict__ o0g, float* __restrict__ o1g,
    float* __restrict__ oh0g, float* __restrict__ oh1g,
    float* __restrict__ op0g, float* __restrict__ op1g, int N, int K,
    SegShared& sm, WaveMail& mb, int C, int rank, float* outflow,
    const Rec& rec = Rec()) {
  const int tile = blockDim.x * kSegCells;
  const int T = (N + tile - 1) / tile;
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = t * tile;
    const int j0 = t0 + threadIdx.x * kSegCells;
    const int owner = tile_owner(t0, j0, tile, N, kSegCells);
    const bool first = t == 0;
    const bool sender = t + 1 < T && owner >= 0;
    float x0[kSegCells], x1[kSegCells], hs0[kSegCells], hs1[kSegCells];
    load_cells(x0, e0g, j0, N);
    load_cells(x1, e1g, j0, N);
    for (int k = 0; k < K; ++k) {
      const int s = 4 * k;
      float* cs = sm.carry + s;
      if (k > 0) rec.input(k, j0, N, x0, x1);
      if (!first) take(sm, mb, s, &sm.etail[k], parity);
      // prev = the step's input ends; its upwind edge feeds CN and BDF.
      const float x1_up =
          upwind_value(x1[kSegCells - 1], &sm.etail[k], sm.edge_p);
      float b0[kSegCells], b1[kSegCells];
      rec.carry(t, s,
                substep_tile<kBE>(kbe, x0, x1, x0, x1, x0, x1, 0.f, 0.f,
                                  cs + 0, owner, sm, buf, b0, b1));
      if (sender) give(sm, mb, s, next, x1[kSegCells - 1], true);
      if (!first) take(sm, mb, s + 1, &sm.htail[k], parity);
      float c0[kSegCells], c1[kSegCells];
      rec.carry(t, s + 1,
                substep_tile<kCN>(kcn, b0, b1, x0, x1, x0, x1, x1_up, 0.f,
                                  cs + 1, owner, sm, buf, c0, c1));
#pragma unroll
      for (int c = 0; c < kSegCells; ++c) {
        hs0[c] = snap_cn ? c0[c] : b0[c];
        hs1[c] = snap_cn ? c1[c] : b1[c];
      }
      if (sender) give(sm, mb, s + 1, next, hs1[kSegCells - 1], true);
      if (!first) take(sm, mb, s + 2, nullptr, parity);
      const float hs1_up =
          upwind_value(hs1[kSegCells - 1], &sm.htail[k], sm.edge_h);
      rec.edges(t, k, x1_up, hs1_up);
      float d0[kSegCells], d1[kSegCells];
      rec.carry(t, s + 2,
                substep_tile<kBE>(kbe, c0, c1, x0, x1, hs0, hs1, 0.f, 0.f,
                                  cs + 2, owner, sm, buf, d0, d1));
      if (sender) give(sm, mb, s + 2, next, 0.f, false);
      if (!first) take(sm, mb, s + 3, nullptr, parity);
      float f0[kSegCells], f1[kSegCells];
      rec.carry(t, s + 3,
                substep_tile<kBDF>(kbdf, d0, d1, x0, x1, hs0, hs1, x1_up,
                                   hs1_up, cs + 3, owner, sm, buf, f0, f1));
      if (sender) give(sm, mb, s + 3, next, 0.f, false);
      if (k == K - 1) {
        // prev of the final state = the LAST step's input.
        store_cells(op0g, j0, N, x0);
        store_cells(op1g, j0, N, x1);
      }
      copy_cells(x0, f0);
      copy_cells(x1, f1);
    }
    store_cells(o0g, j0, N, x0);
    store_cells(o1g, j0, N, x1);
    store_cells(oh0g, j0, N, hs0);
    store_cells(oh1g, j0, N, hs1);
    if (!first) parity ^= 1u;
  }
  if (outflow && rank == (T - 1) % C) write_record(sm, 4 * K, outflow);
}

}  // namespace
