// The cluster wavefronts over (tile, slot) of sweep.cu's f32 kernels and
// the K-fused adjoint forward: the K-step BDF2 wavefront (bdf2_wave) that B1
// (sweep.cu bdf2_kernel), B11 (adjoint.cu fwd_record_k_kernel) and B4
// (sweep.cu halo_bdf2_kernel) share, the K-step BE or CN wavefront, one slot
// a step (multistep_wave), that B2 (sweep.cu multistep_kernel) and B5
// (sweep.cu halo_multistep_kernel) share, and the take and give of one
// slot's mail.
//
// A row's tiles run on the C blocks of a thread block cluster, tile t on
// block t mod C, and each slot's carry goes from tile t to tile t+1 through
// cluster.cuh's mailboxes: in bdf2_wave a slot a (step, phase), step k's
// upwind p1 edge with slot 4k and its h1 edge with slot 4k+1; in
// multistep_wave a slot a step, under CN step k's p1 edge with slot k. The
// tiles, slots and arithmetic are those of the one-block walks these
// kernels ran before them (a loop over the tiles, every slot's carry and
// tail in shared memory), so the planes are those walks' planes to the
// bit. A record hook sees each slot's carry entering the tile, each step's
// upwind edges and the inputs of steps 1..K-1: NoRecords for B1 and B4,
// B11's KRecords, so B11's six planes are B1's to the bit and its records
// those of K chained B9 launches. A layout hook gives the row's tiles:
// OneChain (cluster.cuh) for B1, B2 and B11, HaloChains for B4 and B5,
// whose seeded chain's first tile takes its mail and reseeds.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster.cuh"
#include "segments.cuh"

namespace {

// Per slot the mail is the carry leaving the tile (field 0) and, where the
// slot carries one, a tail (field 1).
using WaveMail = Mailbox<2, kMaxSlots>;

// The row a cluster block of a B1, B2, B4, B5 or B11 launch works on: the
// cluster of C blocks at blockIdx.x / C owns row `row` of half h (hr = h * Bh +
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
// slot carries, from its mailbox: thread 0 waits, then copies. Where `seed`
// is given (the seeded chain's first tile of a halo row) it waits all the
// same, then sets the carry to seed[s] and the tail to 0 instead: the mail
// is discarded, the wait keeps cluster.cuh's chain whole. No barrier
// follows: the other threads first read the carry inside the slot's scan,
// after its first barrier, and only thread 0 reads a tail (upwind_value,
// after the next barrier); the copy overwrites state last read C tiles ago.
template <int F, int S>
__device__ __forceinline__ void take(SegShared& sm, Mailbox<F, S>& mb, int s,
                                     float* tail, uint32_t parity,
                                     const float* seed = nullptr) {
  if (threadIdx.x == 0) {
    // The seed's load is issued before the wait and lands during it.
    const float sd = seed ? seed[s] : 0.f;
    const float* m = wait_mail(mb, s, parity);
    sm.carry[s] = seed ? sd : m[0];
    if constexpr (F > 1) {
      if (tail) *tail = seed ? 0.f : m[1];
    }
  }
}

// Slot s's carry, by the thread that wrote it in substep_tile (the owner of
// the tile's last cell, which in a full tile also holds the tile's last
// cell of every plane, the tail), and the tail if the slot carries one,
// into block `next`'s mailbox. The one ragged tile that sends, a halo
// chain's last, sends its owner's last cell as the tail, past the chain's
// end; the reseeding tile that takes it discards the mail.
template <int F, int S>
__device__ __forceinline__ void give(const SegShared& sm, Mailbox<F, S>& mb,
                                     int s, uint32_t next, float tail,
                                     bool has_tail) {
  float m[F];
  m[0] = sm.carry[s];
  if constexpr (F > 1) m[1] = tail;
  send_mail(mb, s, next, m, has_tail ? F : 1);
}

// bdf2_wave's record hook for B1 and B4: nothing is kept.
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
// cluster's C blocks, laid out by `chains` (OneChain: one chain from cell
// 0; HaloChains: B4's halo chain, then its seeded chain, whose first tile
// takes its mail and starts from seeds[slot] with zero tails). The carries
// and tails in shared memory start as the kernel left them (they serve tile
// 0; the mailboxes, opened before, bring every later tile's). The half
// snapshot is the CN output where snap_cn, else the phase-0 BE output. At
// tile t it hands `rec` step k's input cells (k >= 1: input(k, j0, s1, x0,
// x1), every thread, s1 the end of the tile's chain), each (step, phase)
// slot's carry entering the tile (carry(t, slot, c), every thread, the same
// value, read inside the slot's scan) and step k's upwind e1 and hs1 edges
// (edges(t, k, e1, hs1), every thread; thread 0's are the values upwind of
// the tile). Every tile but the row's last sends its mail, a ragged one
// (the halo chain's last) too. The block that runs the row's last tile
// holds the outflow carries and writes them to `outflow` (one a slot)
// unless it is null.
template <class Rec = NoRecords, class Chains = OneChain>
__device__ __forceinline__ void bdf2_wave(
    const Coef& kbe, const Coef& kcn, const Coef& kbdf, bool snap_cn,
    const float* __restrict__ e0g, const float* __restrict__ e1g,
    float* __restrict__ o0g, float* __restrict__ o1g,
    float* __restrict__ oh0g, float* __restrict__ oh1g,
    float* __restrict__ op0g, float* __restrict__ op1g, int N, int K,
    SegShared& sm, WaveMail& mb, int C, int rank, float* outflow,
    const Rec& rec = Rec(), const Chains& chains = Chains(),
    const float* seeds = nullptr) {
  const int tile = blockDim.x * kSegCells;
  const int T = chains.tiles(N, tile);
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = chains.start(t, tile);
    const int s1 = chains.end(t, N);
    const int j0 = t0 + threadIdx.x * kSegCells;
    const int owner = tile_owner(t0, j0, tile, s1, kSegCells);
    const bool first = t == 0;
    const bool sender = t + 1 < T && owner >= 0;
    const float* seed = chains.reseeds(t) ? seeds : nullptr;
    float x0[kSegCells], x1[kSegCells], hs0[kSegCells], hs1[kSegCells];
    load_cells(x0, e0g, j0, s1);
    load_cells(x1, e1g, j0, s1);
    for (int k = 0; k < K; ++k) {
      const int s = 4 * k;
      float* cs = sm.carry + s;
      if (k > 0) rec.input(k, j0, s1, x0, x1);
      if (!first) take(sm, mb, s, &sm.etail[k], parity, seed);
      // prev = the step's input ends; its upwind edge feeds CN and BDF.
      const float x1_up =
          upwind_value(x1[kSegCells - 1], &sm.etail[k], sm.edge_p);
      float b0[kSegCells], b1[kSegCells];
      rec.carry(t, s,
                substep_tile<kBE>(kbe, x0, x1, x0, x1, x0, x1, 0.f, 0.f,
                                  cs + 0, owner, sm, buf, b0, b1));
      if (sender) give(sm, mb, s, next, x1[kSegCells - 1], true);
      if (!first) take(sm, mb, s + 1, &sm.htail[k], parity, seed);
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
      if (!first) take(sm, mb, s + 2, nullptr, parity, seed);
      const float hs1_up =
          upwind_value(hs1[kSegCells - 1], &sm.htail[k], sm.edge_h);
      rec.edges(t, k, x1_up, hs1_up);
      float d0[kSegCells], d1[kSegCells];
      rec.carry(t, s + 2,
                substep_tile<kBE>(kbe, c0, c1, x0, x1, hs0, hs1, 0.f, 0.f,
                                  cs + 2, owner, sm, buf, d0, d1));
      if (sender) give(sm, mb, s + 2, next, 0.f, false);
      if (!first) take(sm, mb, s + 3, nullptr, parity, seed);
      float f0[kSegCells], f1[kSegCells];
      rec.carry(t, s + 3,
                substep_tile<kBDF>(kbdf, d0, d1, x0, x1, hs0, hs1, x1_up,
                                   hs1_up, cs + 3, owner, sm, buf, f0, f1));
      if (sender) give(sm, mb, s + 3, next, 0.f, false);
      if (k == K - 1) {
        // prev of the final state = the LAST step's input.
        store_cells(op0g, j0, s1, x0);
        store_cells(op1g, j0, s1, x1);
      }
      copy_cells(x0, f0);
      copy_cells(x1, f1);
    }
    store_cells(o0g, j0, s1, x0);
    store_cells(o1g, j0, s1, x1);
    store_cells(oh0g, j0, s1, hs0);
    store_cells(oh1g, j0, s1, hs1);
    if (!first) parity ^= 1u;
  }
  if (outflow && rank == (T - 1) % C) write_record(sm, 4 * K, outflow);
}

// multistep_wave's mailbox: per slot (step) the carry leaving the tile and,
// under CN, the step's upwind p1 edge.
template <int KIND>
using StepMail = Mailbox<KIND == kCN ? 2 : 1, kMaxSteps>;

// K whole BE or CN steps over the N cells of one row (pointers are the
// row's), one slot a step, as this block's share of the row's wavefront:
// tiles rank, rank + C, ... of the cluster's C blocks, laid out by
// `chains` (OneChain: B2's one chain from cell 0; HaloChains: B5's halo
// chain, then its seeded chain, whose first tile takes its mail and starts
// from seeds[k] with zero tails). Slot k of tile t needs only slot k of
// tile t-1 and slot k-1 of tile t, so tile t runs step k while tile t+1
// runs step k-1. The carries and tails in shared memory start as the kernel
// left them (they serve tile 0; the mailboxes, opened before, bring every
// later tile's). Every tile but the row's last sends its mail, a ragged one
// (the halo chain's last) too; under CN the tail is the owner's last cell,
// past the chain's end in a ragged tile, and the reseeding tile discards
// it. prev = each step's input. Returns whether this block ran the row's
// last tile, whose slots then hold the row's outflow carries.
template <int KIND, class Chains = OneChain>
__device__ __forceinline__ bool multistep_wave(
    const Coef& kc, const float* __restrict__ e0g,
    const float* __restrict__ e1g, float* __restrict__ o0g,
    float* __restrict__ o1g, float* __restrict__ op0g,
    float* __restrict__ op1g, int N, int K, SegShared& sm,
    StepMail<KIND>& mb, int C, int rank, const Chains& chains = Chains(),
    const float* seeds = nullptr) {
  constexpr bool kTail = KIND == kCN;
  const int tile = blockDim.x * kSegCells;
  const int T = chains.tiles(N, tile);
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = chains.start(t, tile);
    const int s1 = chains.end(t, N);
    const int j0 = t0 + threadIdx.x * kSegCells;
    const int owner = tile_owner(t0, j0, tile, s1, kSegCells);
    const bool waits = t > 0;
    const bool sender = t + 1 < T && owner >= 0;
    const float* seed = chains.reseeds(t) ? seeds : nullptr;
    float x0[kSegCells], x1[kSegCells];
    load_cells(x0, e0g, j0, s1);
    load_cells(x1, e1g, j0, s1);
    for (int k = 0; k < K; ++k) {
      if (waits) take(sm, mb, k, kTail ? &sm.etail[k] : nullptr, parity, seed);
      float x1_up = 0.f;
      if constexpr (kTail)
        x1_up = upwind_value(x1[kSegCells - 1], &sm.etail[k], sm.edge_p);
      float f0[kSegCells], f1[kSegCells];
      substep_tile<KIND>(kc, x0, x1, x0, x1, x0, x1, x1_up, 0.f,
                         sm.carry + k, owner, sm, buf, f0, f1);
      if (sender) give(sm, mb, k, next, x1[kSegCells - 1], kTail);
      if (k == K - 1) {
        store_cells(op0g, j0, s1, x0);
        store_cells(op1g, j0, s1, x1);
      }
      copy_cells(x0, f0);
      copy_cells(x1, f1);
    }
    store_cells(o0g, j0, s1, x0);
    store_cells(o1g, j0, s1, x1);
    if (waits) parity ^= 1u;
  }
  return T > 0 && rank == (T - 1) % C;
}

}  // namespace
