// Hand-written Hopper (sm_90a) kernels for the kernel-rate adjoint.
//
// Replaces the Pallas TPU kernel factories of
// radiative_transfer_tpu/ops/pallas_adjoint.py:
//   rt_adj_fwd_record   <- _make_fwd_record_kernel (B9: one whole BE, CN or
//                          BDF2 step, plus per-tile entry records)
//   rt_adj_bwd          <- _make_bwd_kernel        (B10: the transposed step)
//   rt_adj_fwd_record_k <- _make_fwd_record_kernel_bdf2_k (B11: K whole BDF2
//                          steps in one launch, plus per-(step, phase) entry
//                          records and the intermediate steps' inputs)
//   rt_adj_bwd_k        <- _make_bwd_kernel_bdf2_k (B12: the transposed K-step
//                          launch)
// The wrappers are ops/cuda_adjoint.py fwd_record_launch, bwd_launch,
// fwd_record_k_launch and bwd_k_launch; the plain PyTorch versions beside
// them keep the JAX blocks and truncated scans.
//
// What is computed. A step is one sub-step (BE, CN) or the BDF2 cycle of four
// (BE, CN, BE, BDF). Per row (direction half h, batch r) and per sub-step:
// right-hand sides r0, r1 of every cell, the recurrence
// carry_j = a*carry_{j-1} + b_j along the row in sweep order, the 2x2
// reconstruction (ops/cuda_sweep.py _substep_block). B9 runs the step and
// records, at the entry of each of its tiles, each phase's carry and the
// upwind e1 and hs1 edges: (2, nph, Bh, ntiles) and (2, Bh, ntiles); B11 runs
// K BDF2 steps and records the same per step, (2, 4K, Bh, ntiles) and
// (2, K, Bh, ntiles), and the inputs of steps 1..K-1, (K-1, 2, Bh, N). B10
// and B12 take the cotangents of the outputs and return those of the input
// planes, of the boundary values and of the ten packed coefficients
// [w, T0, q, idet, a, Sb, c1, c0, kee, kp] of each kind (summed over the
// row's cells and the steps): a step is affine in the state, so the state
// adjoint is the transposed cycle; the coefficient gradients need the primal
// values, which B10/B12 recompute per tile from each step's input plane and
// the records.
//
// Design. Each phase's scan is exact (serial over a thread's cells, a
// warp-shuffle scan of affine maps, one cross-warp pass: tiles.cuh).
// * B9 follows the one-block walk (segments.cuh): ONE thread block owns ONE
//   row and walks it in tiles with a loop inside the block. B9 tiles a row
//   as B1 does (8 cells a thread, at most 512 threads, so 4096-cell tiles)
//   and runs B1's own sub-step routine (tiles.cuh substep_tile), so its
//   step is B1's at K = 1; it skips the prev planes (the inputs by
//   definition) and, for BE/CN, the half planes. Thread 0 writes each
//   record as it reads it: the carry entering the tile in each phase's
//   scan, the upwind edges in the exchanges.
// * B11 is B1's K-step wavefront itself (wave.cuh bdf2_wave: a row's tiles
//   on the C blocks of a thread block cluster, each (step, phase) slot's
//   carry and tails mailed from tile t to tile t+1, cluster.cuh) with a
//   record hook, on B1's tiles, which are the record tiles: its six planes
//   are B1's at the same K to the bit and its records those of K chained
//   B9 launches, which B9's thread 0 writes the same way. C = min(16, 4K,
//   tiles), shrunk until every row's cluster of the launch is resident
//   (rt_adj_fwd_record_k_geometry).
// * B10 and B12 share one row body (bwd_row; K = 1 at compile time for B10)
//   and run each row on the C blocks of a thread block cluster
//   (cluster.cuh), in sub-tiles of blockDim*4 cells (half B1's cells a
//   thread, at most 256 threads: 1024-cell sub-tiles, four to a 4096-cell
//   record tile of B9/B11):
//   - A prologue (bwd_prologue): block rank r takes the record tiles r,
//     r + C, ... and runs every step's forward over each tile's sub-tiles
//     in order, from the step's input plane and the tile's records; it
//     writes each sub-tile's entering carries (one a (step, phase) slot)
//     and hs1 edges (one a step) to a device scratch the wrapper allocates
//     (2, Bh, sub-tiles, slots + K). A cluster barrier with release and
//     acquire at cluster scope ends it.
//   - A wavefront over (sub-tile, slot) from the row's end (bwd_wave): the
//     u-th sub-tile from the row's end runs on block u mod C. There the
//     steps run newest to oldest: step k's input is loaded, its forward
//     phases are recomputed from the scratch's carries and edges, then its
//     adjoint phases run in reverse order (phase_adj); step k's input
//     cotangent, kept in registers, is step k-1's output cotangent. The
//     adjoint of the carry scan is the same scan of maps lambda -> a*lambda
//     + x run right to left (block_exclusive_scan_rev: __shfl_down_sync and
//     a mirrored cross-warp pass). Each (step, phase) slot, in the
//     backward's order (step K-1 down to 0, phases 3, 2, 1, 0), takes its
//     lambda from the downstream sub-tile's block just before its phase and
//     hands the lambda entering the sub-tile to the upstream sub-tile's
//     block just after: a mailbox and an mbarrier a slot in distributed
//     shared memory, one mailbox read and one parity bit a block (as B1,
//     cluster.cuh). The cotangents of the CN/BDF upwind shifts flow one
//     cell upstream (downwind_value); at a sub-tile's last cell they come
//     from the downstream sub-tile's first cell, with the mail: step k's
//     hs1-shift cotangent with slot (k, 3), complete after the BDF phase,
//     and its e1-shift cotangent with slot (k, 1) (BDF2; CN: slot k),
//     complete after the CN phase. Thread 0 runs every wait and send.
//   So B10/B12 run the forward twice and the adjoint once. The sub-tiles,
//   scans, carries and arithmetic are those of one block walking the row's
//   record tiles last to first (a forward pass over a tile's sub-tiles,
//   then the sub-tiles last to first), so the state cotangents equal that
//   walk's to the bit; only who runs a sub-tile and how its slots' state
//   arrives differ. The recomputed primals round as 1024-cell tiles do,
//   which moves only the coefficient gradients, at f32 roundoff (and the
//   packs sum in another order than such a walk's). C = min(16, slots,
//   sub-tiles), shrunk until every row's cluster of the launch is resident
//   (rt_adj_bwd_geometry): at most one sub-tile a slot is in flight.
// * Coefficient gradients: each thread sums its cells' terms over its
//   sub-tiles and steps in registers (BE phases 0 and 2, CN phase 1, BDF
//   phase 3); at the row's end each block reduces them (warp shuffles,
//   then per warp in shared memory) to one partial a column and, after a
//   cluster barrier, rank 0 adds the C partials in rank order through
//   distributed shared memory and writes each column once: no atomics, the
//   same sums launch to launch. This sums in another order than Pallas's
//   per-block sums.
// * Reflective left boundary: forward, the mu<0 launch records its outflow
//   carries and the mu>0 launch reads them through `flip` (B1's scheme).
//   Backward, the order is reversed: the mu>0 launch records each slot's
//   inflow cotangent and the mu<0 launch starts its lambdas from s_p times
//   that record, gathered through `flip`; only the mu<0 half's cotangent
//   goes to bc. The block that ran the row's first sub-tile holds those
//   lambdas and writes the record or bc. With a source boundary both halves
//   share one launch.
// * Registers: B10/B12 hold the step input, the three phase outputs they
//   need and four phases' entering carries for 4 cells a thread (48 values),
//   plus the cotangents and 27 gradient sums; coefficients sit in shared
//   memory. Hence 4 cells and at most 256 threads (up to 255 registers).
// * Cells past N in a row's last tile load as 0; forward they lie
//   downstream of every real cell; backward their maps are the identity and
//   their cotangents are forced to 0, so the cotangents chained from step to
//   step stay 0 there.
//
// What bounds it on this card: the serial carry chain of each row. B9 runs
// 4 scans (BDF2) per 4096 cells and step, one block a row, on 2*Bh blocks
// (Bh at a time for a reflective slab); B11 spreads a row's T tiles x 4K
// slots of such scans over C blocks, so a launch is bound by the larger of
// T*4K/C tile-phases and the handoff chain (~T hops of a tile-phase and a
// mail's latency) plus the last tile's slots, as B1. B10/B12 run 48 (four
// sub-tiles of 8 forward and 4 reversed) and 16 neighbour exchanges, each
// with block barriers, spread over C blocks a row: a launch is bound by the
// larger of the row's sub-tile-phases over C and its handoff chain (one
// adjoint phase and a mail's latency a sub-tile), plus the prologue's
// quarter of the forward work. Device-memory traffic is small beside that:
// B9 reads 2 planes and writes 4, B10 reads 6 and writes 2; a K-step B11
// reads 2 and writes 6 + 2(K-1), B12 reads 8 + 2(K-1) and writes 2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "segments.cuh"
#include "wave.cuh"

namespace {

// B9 and B11 tile a row as B1 does (segments.cuh): kFwdCells consecutive
// cells a thread, at most kFwdThreads threads; their records are per such
// tile. B10 and B12 walk each record tile as sub-tiles of blockDim*kCells
// cells, with half B9's threads (at least a warp) and half its cells a
// thread.
constexpr int kFwdCells = kSegCells;
constexpr int kFwdThreads = kSegThreads;
constexpr int kCells = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNGrad = 9;          // w T0 q idet a S(=Sb=c0) c1 kee kp

// Per-slot arrays hold one entry per (step, phase) slot (4 a BDF2 step, K <=
// kMaxSteps steps: B12), per-step arrays one per step; B9 and B10 use the
// first nph slots and step 0.
struct Shared {
  Coef kc[3];                  // BE, CN, BDF coefficients of this row
  float carry[kMaxSlots];      // B9: each phase's carry entering the tile;
                               // B10/B12: each slot's lambda from downstream
  float fcarry[kMaxSlots];     // B10/B12: the forward carries entering the
                               // sub-tile (the prologue's chain, then the
                               // wavefront's copy of the scratch)
  float htail[kMaxSteps];      // the hs1 edge upwind of the (sub-)tile
  float cet[kMaxSteps];        // B10/B12: each step's shift cotangents from
  float cht[kMaxSteps];        // the downstream sub-tile (its mail)
  float scanA[2][32];          // cross-warp scan, double-buffered
  float scanB[2][32];
  float edge_p[32], edge_h[32];    // upwind exchanges
  float edge_dp[32], edge_dh[32];  // downwind exchanges
  float red[3 * kNGrad][kMaxWarps];  // row-end gradient reduction
  float part[3 * kNGrad];      // B10/B12: the block's gradient partials
};

// B10's and B12's mail a slot: the lambda entering the sub-tile and, with
// slot (k, 3) and (k, 1) of BDF2 (slot k of CN), a shift cotangent.
using BwdMail = Mailbox<2, kMaxSlots>;

// Inclusive scan over a warp, right to left, of the maps x -> A*x + B:
// lane i ends with f_i o f_{i+1} o ... o f_31 (f_31 applied first).
__device__ __forceinline__ void warp_inclusive_scan_rev(float& A, float& B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pA = __shfl_down_sync(kFull, A, d);
    const float pB = __shfl_down_sync(kFull, B, d);
    if (lane + d < 32) {
      B = A * pB + B;
      A = A * pA;
    }
  }
}

// The mirror of tiles.cuh block_exclusive_scan: the composition of the maps
// of every thread AFTER this one (in thread order), applied to the value
// entering the tile from the right, *carry. *carry is read between the two
// barriers; `buf` alternates with the forward scans' buffers.
__device__ __forceinline__ float block_exclusive_scan_rev(
    float A, float B, const float* carry, Shared& sm, int& buf, float& exA,
    float& exB) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_inclusive_scan_rev(A, B);
  if (lane == 0) {
    sm.scanA[buf][warp] = A;
    sm.scanB[buf][warp] = B;
  }
  __syncthreads();
  const float c_in = *carry;
  if (warp == 0) {
    float wA = lane < nwarps ? sm.scanA[buf][lane] : 1.f;
    float wB = lane < nwarps ? sm.scanB[buf][lane] : 0.f;
    warp_inclusive_scan_rev(wA, wB);
    float xA = __shfl_down_sync(kFull, wA, 1);
    float xB = __shfl_down_sync(kFull, wB, 1);
    if (lane == 31) {
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
  float tA = __shfl_down_sync(kFull, A, 1);
  float tB = __shfl_down_sync(kFull, B, 1);
  if (lane == 31) {
    tA = 1.f;
    tB = 0.f;
  }
  exA = tA * wA;
  exB = tA * wB + tB;
  buf ^= 1;
  return c_in;
}

// The value of x at the cell just downstream of this thread's last cell: the
// next thread's first cell, or *tile_tail (from the downstream tile) for the
// block's last thread. *tile_tail is read after the barrier.
__device__ __forceinline__ float downwind_value(float my_first,
                                                const float* tile_tail,
                                                float* edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float v = __shfl_down_sync(kFull, my_first, 1);
  if (lane == 0) edge[warp] = my_first;
  __syncthreads();
  if (lane == 31) v = (warp + 1 < nwarps) ? edge[warp + 1] : *tile_tail;
  return v;
}

// One adjoint phase over this thread's cells (_substep_adj). Inputs: the
// phase's input planes (e = the sub-step's own state, p/h its history), the
// upwind edges the forward used, each cell's entering carry, the cotangents
// of the phase's outputs, and *lam, the cotangent of the carry leaving the
// tile, replaced (by thread 0, after the scan) by that of the carry
// entering it. Outputs: e0c/e1c, the cotangents of e (assigned); for CN and
// BDF the shift sources p1s_c (and h1s_c for BDF) and for BDF the direct
// p/h cotangents, accumulated; g, this thread's gradient sums.
template <int KIND>
__device__ __forceinline__ void phase_adj(
    const Coef& k, const float (&e0)[kCells], const float (&e1)[kCells],
    const float (&p0)[kCells], const float (&p1)[kCells],
    const float (&h0)[kCells], const float (&h1)[kCells], float p1_up,
    float h1_up, const float (&cin)[kCells], const float (&o0c)[kCells],
    const float (&o1c)[kCells], float* lam, int j0, int N, Shared& sm,
    int& buf, float (&e0c)[kCells], float (&e1c)[kCells],
    float (&p0c)[kCells], float (&p1c)[kCells], float (&h0c)[kCells],
    float (&h1c)[kCells], float (&p1s_c)[kCells], float (&h1s_c)[kCells],
    float (&g)[kNGrad]) {
  float u_c[kCells], cin_c[kCells];
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int c = kCells - 1; c >= 0; --c) {
    u_c[c] = k.idet * (k.T0 * o0c[c] + k.q * o1c[c]);
    cin_c[c] = k.w * u_c[c];
    if (j0 + c < N) {
      B = k.a * B + cin_c[c];
      A = A * k.a;
    }
  }
  float exA, exB;
  const float lam_in = block_exclusive_scan_rev(A, B, lam, sm, buf, exA, exB);
  float R = exA * lam_in + exB;  // lambda of the carry leaving the last cell
#pragma unroll
  for (int c = kCells - 1; c >= 0; --c) {
    const bool real = j0 + c < N;
    const float b_c = real ? R : 0.f;  // cotangent of b_c = of carry_c
    if (real) R = k.a * R + cin_c[c];
    const float sp = c ? p1[c - 1] : p1_up;
    const float sh = c ? h1[c - 1] : h1_up;
    float r0, r1;
    rhs<KIND>(k, e0[c], e1[c], p0[c], p1[c], h0[c], h1[c], sp, sh, r0, r1);
    const float psi = 0.5f * (e0[c] + e1[c]);
    const float u = r0 + k.w * cin[c];
    const float r0_c = u_c[c] + k.idet * k.q * b_c;
    const float r1_c = k.idet * (k.T0 * o1c[c] - k.q * o0c[c]) +
                       k.idet * k.T0 * b_c;
    const float S_c = r0_c + r1_c;
    const float half = 0.5f * k.c1 * S_c;
    if constexpr (KIND == kBE) {
      e0c[c] = k.kee * r0_c + half;
      e1c[c] = k.kee * r1_c + half;
      g[7] += e0[c] * r0_c + e1[c] * r1_c;
    } else if constexpr (KIND == kCN) {
      e0c[c] = k.kee * r0_c + k.q * r1_c + half;
      e1c[c] = -k.q * r0_c + k.kee * r1_c + half;
      p1s_c[c] += k.w * r0_c;
      g[7] += e0[c] * r0_c + e1[c] * r1_c;
      g[0] += sp * r0_c;
      g[2] += -e1[c] * r0_c + e0[c] * r1_c;
    } else {
      e0c[c] = half;
      e1c[c] = half;
      h0c[c] += k.kee * r0_c + 2.f * k.w * r1_c;
      h1c[c] += -2.f * k.w * r0_c + k.kee * r1_c;
      p0c[c] += -k.kp * r0_c + k.q * r1_c;
      p1c[c] += -k.q * r0_c - k.kp * r1_c;
      p1s_c[c] += k.w * r0_c;
      h1s_c[c] += 4.f * k.w * r0_c;
      g[7] += h0[c] * r0_c + h1[c] * r1_c;
      g[8] += -p0[c] * r0_c - p1[c] * r1_c;
      g[0] += (-2.f * h1[c] + 4.f * sh + sp) * r0_c + 2.f * h0[c] * r1_c;
      g[2] += -p1[c] * r0_c + p0[c] * r1_c;
    }
    const float P0 = k.T0 * u - k.q * r1;
    const float P1 = k.q * u + k.T0 * r1;
    const float qr = k.q * r0 + k.T0 * r1;
    g[3] += P0 * o0c[c] + P1 * o1c[c] + qr * b_c;
    g[1] += k.idet * (u * o0c[c] + r1 * o1c[c] + r1 * b_c);
    g[2] += k.idet * (-r1 * o0c[c] + u * o1c[c] + r0 * b_c);
    g[4] += cin[c] * b_c;
    g[5] += S_c;
    g[6] += psi * S_c;
    g[0] += cin[c] * u_c[c];
  }
  if (threadIdx.x == 0) *lam = R;  // after the scan's barriers
}

// The phase's s: BE, CN, BE, BDF for BDF2, else the one kind's.
template <int TS>
__device__ __forceinline__ float phase_s(int p, float s_be, float s_cn,
                                         float s_bdf) {
  if constexpr (TS == 3) return p == 1 ? s_cn : (p == 3 ? s_bdf : s_be);
  return TS == 1 ? s_be : s_cn;
}

// Loads the row's coefficients into shared memory (no barrier).
__device__ __forceinline__ void load_row_coefs(Shared& sm,
                                               const float* __restrict__ cbe,
                                               const float* __restrict__ ccn,
                                               const float* __restrict__ cbdf,
                                               int hr) {
  if (threadIdx.x == 0) {
    sm.kc[0] = load_coef(cbe + hr * kNCoef);
    sm.kc[1] = load_coef(ccn + hr * kNCoef);
    sm.kc[2] = load_coef(cbdf + hr * kNCoef);
  }
}

// B9, replaces _make_fwd_record_kernel (pallas_adjoint.py:266): one row in
// B1's tiles. TS is the step (1 BE, 2 CN, 3 BDF2), SNAP whether the half
// snapshot is the CN output (mu<0, or symmetric) rather than the phase-0
// BE output.
template <int TS, bool SNAP>
__device__ __forceinline__ void fwd_record_row(
    Shared& sm, int h, int row, int Bh, int N, int ntiles,
    const float* __restrict__ e0g, const float* __restrict__ e1g,
    float* __restrict__ o0g, float* __restrict__ o1g,
    float* __restrict__ oh0g, float* __restrict__ oh1g, float* rc,
    float* ret, float* rht) {
  constexpr int nph = TS == 3 ? 4 : 1;
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  const int tile = blockDim.x * kFwdCells;
  const size_t base = static_cast<size_t>(h * Bh + row) * N;
  // Record index of (phase p, tile t) and of the edge records.
  const size_t rbase = (static_cast<size_t>(h) * nph * Bh + row) * ntiles;
  const size_t ebase = (static_cast<size_t>(h) * Bh + row) * ntiles;
  int buf = 0;
  for (int t = 0, t0 = 0; t0 < N; ++t, t0 += tile) {
    const int j0 = t0 + threadIdx.x * kFwdCells;
    const int owner = tile_owner(t0, j0, tile, N, kFwdCells);
    float x0[kFwdCells], x1[kFwdCells], o0[kFwdCells], o1[kFwdCells];
    load_cells(x0, e0g + base, j0, N);
    load_cells(x1, e1g + base, j0, N);
    // The e1 edge upwind of the tile: an input value.
    const float et = (threadIdx.x == 0 && t0 > 0) ? e1g[base + t0 - 1] : 0.f;
    const bool lead = threadIdx.x == 0;
    if (lead) ret[ebase + t] = et;
    auto record = [&](int p, float c_in) {
      if (lead) rc[rbase + static_cast<size_t>(p) * Bh * ntiles + t] = c_in;
    };
    if constexpr (TS == 3) {
      const float x1_up = upwind_value(x1[kFwdCells - 1], &et, sm.edge_p);
      float b0[kFwdCells], b1[kFwdCells], c0[kFwdCells], c1[kFwdCells];
      record(0, substep_tile<kBE>(sm.kc[0], x0, x1, x0, x1, x0, x1, 0.f, 0.f,
                                  &sm.carry[0], owner, sm, buf, b0, b1));
      record(1, substep_tile<kCN>(sm.kc[1], b0, b1, x0, x1, x0, x1, x1_up,
                                  0.f, &sm.carry[1], owner, sm, buf, c0, c1));
      const auto& hs0 = SNAP ? c0 : b0;
      const auto& hs1 = SNAP ? c1 : b1;
      const float hs1_up = upwind_value(hs1[kFwdCells - 1], sm.htail,
                                        sm.edge_h);
      if (lead) rht[ebase + t] = hs1_up;
      float d0[kFwdCells], d1[kFwdCells];
      record(2, substep_tile<kBE>(sm.kc[0], c0, c1, x0, x1, hs0, hs1, 0.f,
                                  0.f, &sm.carry[2], owner, sm, buf, d0, d1));
      record(3, substep_tile<kBDF>(sm.kc[2], d0, d1, x0, x1, hs0, hs1, x1_up,
                                   hs1_up, &sm.carry[3], owner, sm, buf, o0,
                                   o1));
      if (tail_thread) sm.htail[0] = hs1[kFwdCells - 1];
      store_cells(oh0g + base, j0, N, hs0);
      store_cells(oh1g + base, j0, N, hs1);
    } else {
      constexpr int KIND = TS == 1 ? kBE : kCN;
      float x1_up = 0.f;
      if constexpr (KIND == kCN)
        x1_up = upwind_value(x1[kFwdCells - 1], &et, sm.edge_p);
      if (lead) rht[ebase + t] = 0.f;
      record(0, substep_tile<KIND>(sm.kc[KIND - 1], x0, x1, x0, x1, x0, x1,
                                   x1_up, 0.f, &sm.carry[0], owner, sm, buf,
                                   o0, o1));
    }
    store_cells(o0g + base, j0, N, o0);
    store_cells(o1g + base, j0, N, o1);
  }
}

template <int TS>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_record_kernel(const float* __restrict__ cbe,
                      const float* __restrict__ ccn,
                      const float* __restrict__ cbdf,
                      const float* __restrict__ bc,
                      const int* __restrict__ flip, float* rec,
                      const float* __restrict__ e0g,
                      const float* __restrict__ e1g, float* __restrict__ o0g,
                      float* __restrict__ o1g, float* __restrict__ oh0g,
                      float* __restrict__ oh1g, float* rc, float* ret,
                      float* rht, int Bh, int N, int ntiles, float s_be,
                      float s_cn, float s_bdf, int symmetric, int reflective,
                      int half0) {
  __shared__ Shared sm;
  constexpr int nph = TS == 3 ? 4 : 1;
  const int row = blockIdx.x % Bh;
  const int h = half0 + blockIdx.x / Bh;
  const int hr = h * Bh + row;
  load_row_coefs(sm, cbe, ccn, cbdf, hr);
  // Carries entering the row: s_p * the boundary value, or for the mu>0
  // half of a reflective slab s_p * the mu<0 outflow of the flipped row.
  if (threadIdx.x < nph) {
    const int p = threadIdx.x;
    const float in =
        (h == 1 && reflective) ? rec[flip[row] * nph + p] : bc[hr];
    sm.carry[p] = phase_s<TS>(p, s_be, s_cn, s_bdf) * in;
  }
  if (threadIdx.x == 0) sm.htail[0] = 0.f;
  __syncthreads();
  if (TS == 3 && !(symmetric || h == 0))
    fwd_record_row<TS, false>(sm, h, row, Bh, N, ntiles, e0g, e1g, o0g, o1g,
                              oh0g, oh1g, rc, ret, rht);
  else
    fwd_record_row<TS, true>(sm, h, row, Bh, N, ntiles, e0g, e1g, o0g, o1g,
                             oh0g, oh1g, rc, ret, rht);
  if (h == 0 && reflective) {  // the mu<0 outflow, for the mu>0 launch
    __syncthreads();
    if (threadIdx.x < nph) rec[row * nph + threadIdx.x] = sm.carry[threadIdx.x];
  }
}

// B11's records (bdf2_wave's hook), pointers at the row's first entry:
// rc[slot * stride + t], ret/rht[k * stride + t] (stride = Bh * ntiles),
// and step k's input planes ri0/ri1 at (k - 1) * plane (plane = 2 * Bh * N).
struct KRecords {
  float* rc;
  float* ret;
  float* rht;
  float* ri0;
  float* ri1;
  size_t stride, plane;

  __device__ __forceinline__ void input(int k, int j0, int N,
                                        const float (&x0)[kSegCells],
                                        const float (&x1)[kSegCells]) const {
    store_cells(ri0 + (k - 1) * plane, j0, N, x0);
    store_cells(ri1 + (k - 1) * plane, j0, N, x1);
  }
  __device__ __forceinline__ void carry(int t, int slot, float c) const {
    if (threadIdx.x == 0) rc[slot * stride + t] = c;
  }
  __device__ __forceinline__ void edges(int t, int k, float e1,
                                        float hs1) const {
    if (threadIdx.x == 0) {
      ret[k * stride + t] = e1;
      rht[k * stride + t] = hs1;
    }
  }
};

// B11, replaces _make_fwd_record_kernel_bdf2_k (pallas_adjoint.py:571): K
// whole BDF2 steps in ONE launch, B1's bdf2_kernel with records: the
// wavefront over (tile, slot) is wave.cuh bdf2_wave itself, on B1's tiles
// (the record tiles), its hook writing each (step, phase) slot's carry and
// each step's upwind e1/hs1 edges at tile entry (thread 0, the values it
// read between the scans' and exchanges' barriers: the carry and tails
// that init_row set for tile 0, that the slot's mail brought for a later
// tile) and the input planes of steps 1..K-1 (every thread, its own cells).
__global__ void __launch_bounds__(kFwdThreads)
    fwd_record_k_kernel(const float* __restrict__ cbe,
                        const float* __restrict__ ccn,
                        const float* __restrict__ cbdf,
                        const float* __restrict__ bc,
                        const int* __restrict__ flip, float* rec,
                        const float* __restrict__ e0g,
                        const float* __restrict__ e1g,
                        float* __restrict__ o0g, float* __restrict__ o1g,
                        float* __restrict__ oh0g, float* __restrict__ oh1g,
                        float* __restrict__ op0g, float* __restrict__ op1g,
                        float* rc, float* ret, float* rht, float* ri0,
                        float* ri1, int Bh, int N, int K, int ntiles,
                        float s_be, float s_cn, float s_bdf, int symmetric,
                        int reflective, int half0) {
  __shared__ SegShared sm;
  __shared__ WaveMail mb;
  const WaveRow w = wave_row(Bh, half0);
  const float s_of[4] = {s_be, s_cn, s_be, s_bdf};
  const int slots = 4 * K;
  open_mailboxes(mb, slots);
  init_row(sm, slots, K, s_of, 4, bc, flip, rec, w.h, w.row, w.hr,
           reflective);
  const size_t base = static_cast<size_t>(w.hr) * N;
  const size_t stride = static_cast<size_t>(Bh) * ntiles;
  const size_t rrow = static_cast<size_t>(w.row) * ntiles;
  const KRecords r{rc + static_cast<size_t>(w.h) * slots * stride + rrow,
                   ret + static_cast<size_t>(w.h) * K * stride + rrow,
                   rht + static_cast<size_t>(w.h) * K * stride + rrow,
                   ri0 + base, ri1 + base, stride,
                   static_cast<size_t>(2) * Bh * N};
  bdf2_wave(load_coef(cbe + w.hr * kNCoef), load_coef(ccn + w.hr * kNCoef),
            load_coef(cbdf + w.hr * kNCoef), symmetric || w.h == 0,
            e0g + base, e1g + base, o0g + base, o1g + base, oh0g + base,
            oh1g + base, op0g + base, op1g + base, N, K, sm, mb, w.C, w.rank,
            w.h == 0 && reflective ? rec + w.row * slots : nullptr, r);
  close_mailboxes();
}

// One forward pass of the BDF2 step (TS 3) or the BE/CN sub-step over this
// thread's cells of a B10 sub-tile, each phase seeded from carry[p] and, if
// `owner` >= 0, leaving its outflow there: the planes of every phase (b, c,
// d) and each phase's entering carries, for the adjoint. c_in gets the
// carries entering the sub-tile; x1_up/hs1_up are the upwind edges it used
// (*et / *ht the values upwind of the sub-tile, read by thread 0).
template <int TS, bool SNAP>
struct Fwd {
  float b0[kCells], b1[kCells], c0[kCells], c1[kCells], d0[kCells],
      d1[kCells], cin[4][kCells];
  float x1_up, hs1_up, c_in[4];

  __device__ __forceinline__ void run(Shared& sm, int& buf,
                                      const float (&x0)[kCells],
                                      const float (&x1)[kCells],
                                      float* carry, int owner,
                                      const float* et, const float* ht) {
    float f0[kCells], f1[kCells];
    if constexpr (TS == 3) {
      x1_up = upwind_value(x1[kCells - 1], et, sm.edge_p);
      c_in[0] = substep_tile<kBE>(sm.kc[0], x0, x1, x0, x1, x0, x1, 0.f, 0.f,
                                  carry + 0, owner, sm, buf, b0, b1, cin[0]);
      c_in[1] = substep_tile<kCN>(sm.kc[1], b0, b1, x0, x1, x0, x1, x1_up,
                                  0.f, carry + 1, owner, sm, buf, c0, c1,
                                  cin[1]);
      const auto& hs0 = SNAP ? c0 : b0;
      const auto& hs1 = SNAP ? c1 : b1;
      hs1_up = upwind_value(hs1[kCells - 1], ht, sm.edge_h);
      c_in[2] = substep_tile<kBE>(sm.kc[0], c0, c1, x0, x1, hs0, hs1, 0.f,
                                  0.f, carry + 2, owner, sm, buf, d0, d1,
                                  cin[2]);
      c_in[3] = substep_tile<kBDF>(sm.kc[2], d0, d1, x0, x1, hs0, hs1, x1_up,
                                   hs1_up, carry + 3, owner, sm, buf, f0, f1,
                                   cin[3]);
    } else {
      constexpr int KIND = TS == 1 ? kBE : kCN;
      x1_up = 0.f;
      if constexpr (KIND == kCN)
        x1_up = upwind_value(x1[kCells - 1], et, sm.edge_p);
      c_in[0] = substep_tile<KIND>(sm.kc[KIND - 1], x0, x1, x0, x1, x0, x1,
                                   x1_up, 0.f, carry, owner, sm, buf, f0, f1,
                                   cin[0]);
    }
  }
};

// One row of a B10/B12 launch: its planes, records, outputs and prologue
// scratch, and the row's geometry. Planes are the launch's (the row's
// offset `base` applied on access), records and scratch the row's own.
struct BwdRow {
  const float* e0;     // step 0's input
  const float* e1;
  const float* ri0;    // step k's input at (k - 1) * plane (k >= 1)
  const float* ri1;
  const float* co0;    // cotangents of the ends, the half snapshot and
  const float* co1;    // (B12) prev
  const float* coh0;
  const float* coh1;
  const float* cop0;
  const float* cop1;
  const float* rc;     // the row's records: slot or step i at tile t is
  const float* ret;    // [i * stride + t]
  const float* rht;
  float* ce0;
  float* ce1;
  float* scr;          // the row's scratch: (sub-tiles, slots + K)
  size_t base, plane, stride;
  int N, K, slots, ntiles, rtile, sub, G;  // G: sub-tiles a row

  __device__ __forceinline__ const float* in0(int k) const {
    return (k ? ri0 + (k - 1) * plane : e0) + base;
  }
  __device__ __forceinline__ const float* in1(int k) const {
    return (k ? ri1 + (k - 1) * plane : e1) + base;
  }
  // Step k's e1 edge upwind of the sub-tile at s0: the record for a record
  // tile's first, an input value otherwise.
  __device__ __forceinline__ float et(int k, int s0) const {
    const int t = s0 / rtile;
    return s0 == t * rtile ? ret[k * stride + t] : in1(k)[s0 - 1];
  }
  // The scratch entries of the sub-tile at s0.
  __device__ __forceinline__ float* sub_scratch(int s0) const {
    return scr + static_cast<size_t>(s0 / sub) * (slots + K);
  }
};

// B10's and B12's prologue: block `rank` of the row's C runs every step's
// forward over the sub-tiles of its record tiles (rank, rank + C, ...) in
// order, from each step's input plane and the tile's records, and writes
// each sub-tile's entering carries (slot nph*k + p) and hs1 edges (entry
// slots + k) to the scratch (thread 0). The tiles are independent given
// their records.
template <int TS, bool SNAP>
__device__ __forceinline__ void bwd_prologue(Shared& sm, int& buf,
                                             const BwdRow& w, int rank,
                                             int C) {
  constexpr int nph = TS == 3 ? 4 : 1;
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  for (int t = rank; t < w.ntiles; t += C) {
    const int t0 = t * w.rtile;
    const int t1 = min(t0 + w.rtile, w.N);
    // The previous tile's last reads of these slots precede the first
    // barrier.
    __syncthreads();
    for (int i = threadIdx.x; i < w.slots; i += blockDim.x)
      sm.fcarry[i] = w.rc[i * w.stride + t];
    for (int k = threadIdx.x; k < w.K; k += blockDim.x)
      sm.htail[k] = TS == 3 ? w.rht[k * w.stride + t] : 0.f;
    __syncthreads();
    for (int s0 = t0; s0 < t1; s0 += w.sub) {
      const int j0 = s0 + threadIdx.x * kCells;
      const int owner = tile_owner(s0, j0, w.sub, w.N, kCells);
      float* out = w.sub_scratch(s0);
      for (int k = 0; k < w.K; ++k) {
        float x0[kCells], x1[kCells];
        load_cells(x0, w.in0(k), j0, w.N);
        load_cells(x1, w.in1(k), j0, w.N);
        const float et = threadIdx.x == 0 ? w.et(k, s0) : 0.f;
        Fwd<TS, SNAP> f;
        f.run(sm, buf, x0, x1, sm.fcarry + nph * k, owner, &et,
              &sm.htail[k]);
        if (threadIdx.x == 0) {
          for (int p = 0; p < nph; ++p) out[nph * k + p] = f.c_in[p];
          out[w.slots + k] = TS == 3 ? f.hs1_up : 0.f;
        }
        if constexpr (TS == 3) {
          if (tail_thread)
            sm.htail[k] = SNAP ? f.c1[kCells - 1] : f.b1[kCells - 1];
        }
      }
    }
  }
}

// Sub-tile u > 0 takes slot s's lambda (into sm.carry[s]) and, where `tail`
// is given, the shift cotangent the slot carries, from its mailbox: thread
// 0 waits, then copies. No barrier follows: the other threads first read
// the lambda inside the slot's reversed scan, after its first barrier, and
// a tail is read in a downwind exchange after later barriers; the copies
// overwrite state this block last read C sub-tiles ago, before barriers
// thread 0 has passed.
__device__ __forceinline__ void take(Shared& sm, BwdMail& mb, int s,
                                     float* tail, uint32_t parity) {
  if (threadIdx.x == 0) {
    const float* m = wait_mail(mb, s, parity);
    sm.carry[s] = m[0];
    if (tail) *tail = m[1];
  }
}

// Thread 0 (`sender`: not the row's first sub-tile) hands slot s's lambda
// entering the sub-tile, which phase_adj left in sm.carry[s], and where
// has_tail a shift cotangent of the sub-tile's first cell, to block `next`,
// which runs the next sub-tile upstream.
__device__ __forceinline__ void give(const Shared& sm, BwdMail& mb, int s,
                                     uint32_t next, float tail,
                                     bool has_tail) {
  const float m[2] = {sm.carry[s], tail};
  send_mail(mb, s, next, m, has_tail ? 2 : 1);
}

// B10's and B12's wavefront: block `rank` of the row's C runs the sub-tiles
// rank, rank + C, ... counted from the row's end. At each, for k = K-1 down
// to 0, step k's forward is recomputed from its input plane and the
// scratch's carries and edges, then its adjoint phases run in reverse
// order, each slot's lambda taken from the downstream sub-tile's block and
// handed on upstream. The external cotangents enter at step K-1 (JAX's
// order): co (ends) and coh (half) as its outputs', cop (prev, which is
// step K-1's input) added to its input's; the half cotangent of the steps
// before is zero. Step k-1 at a sub-tile reads step k's input cotangent
// complete, its last cell's share from the downstream sub-tile (the mail
// of slots (k, 1) and (k, 3)) included. g holds this thread's gradient
// sums, kNGrad per kind (BE, CN, BDF for BDF2; the one kind otherwise).
template <int TS, bool SNAP>
__device__ __forceinline__ void bwd_wave(Shared& sm, BwdMail& mb, int& buf,
                                         const BwdRow& w, int rank, int C,
                                         float (&g)[3][kNGrad]) {
  constexpr int nph = TS == 3 ? 4 : 1;
  const int G = w.G;
  const uint32_t next = (rank + 1) % C;
  uint32_t parity = 0;
  float scratch[kCells];  // unused outputs
  for (int u = rank; u < G; u += C) {
    const int s0 = (G - 1 - u) * w.sub;
    const int j0 = s0 + threadIdx.x * kCells;
    const bool first = u == 0;  // the row's last sub-tile: no mail comes in
    const bool sender = s0 > 0 && threadIdx.x == 0;
    // The sub-tile's entering carries and hs1 edges: read inside the
    // recompute's scans and thread 0's upwind exchange, after barriers; the
    // previous sub-tile's reads preceded its adjoint phases' barriers.
    const float* in = w.sub_scratch(s0);
    for (int i = threadIdx.x; i < w.slots + w.K; i += blockDim.x) {
      if (i < w.slots)
        sm.fcarry[i] = in[i];
      else
        sm.htail[i - w.slots] = in[i];
    }
    // Step k's output cotangent: the launch's ends' for k = K-1 (loaded
    // after the recompute), then step k+1's input cotangent.
    float oc0[kCells], oc1[kCells];
    for (int k = w.K - 1; k >= 0; --k) {
      const int sl = nph * k;
      float x0[kCells], x1[kCells];
      load_cells(x0, w.in0(k), j0, w.N);
      load_cells(x1, w.in1(k), j0, w.N);
      const float et = threadIdx.x == 0 ? w.et(k, s0) : 0.f;
      Fwd<TS, SNAP> f;
      f.run(sm, buf, x0, x1, sm.fcarry + sl, -1, &et, &sm.htail[k]);
      if (k == w.K - 1) {
        load_cells(oc0, w.co0 + w.base, j0, w.N);
        load_cells(oc1, w.co1 + w.base, j0, w.N);
      }
      float* lam = sm.carry + sl;
      float x0c[kCells], x1c[kCells], pshift[kCells];
#pragma unroll
      for (int c = 0; c < kCells; ++c) x0c[c] = x1c[c] = pshift[c] = 0.f;
      if constexpr (TS == 3) {
        const auto& hs0 = SNAP ? f.c0 : f.b0;
        const auto& hs1 = SNAP ? f.c1 : f.b1;
        float hs0c[kCells], hs1c[kCells], hshift[kCells];
        if (k == w.K - 1) {
          load_cells(hs0c, w.coh0 + w.base, j0, w.N);
          load_cells(hs1c, w.coh1 + w.base, j0, w.N);
        } else {
#pragma unroll
          for (int c = 0; c < kCells; ++c) hs0c[c] = hs1c[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < kCells; ++c) hshift[c] = 0.f;
        float dc0[kCells], dc1[kCells];
        if (!first) take(sm, mb, sl + 3, &sm.cht[k], parity);
        phase_adj<kBDF>(sm.kc[2], f.d0, f.d1, x0, x1, hs0, hs1, f.x1_up,
                        f.hs1_up, f.cin[3], oc0, oc1, lam + 3, j0, w.N, sm,
                        buf, dc0, dc1, x0c, x1c, hs0c, hs1c, pshift, hshift,
                        g[2]);
        if (sender) give(sm, mb, sl + 3, next, hshift[0], true);
        float cc0[kCells], cc1[kCells];
        if (!first) take(sm, mb, sl + 2, nullptr, parity);
        phase_adj<kBE>(sm.kc[0], f.c0, f.c1, x0, x1, hs0, hs1, 0.f, 0.f,
                       f.cin[2], dc0, dc1, lam + 2, j0, w.N, sm, buf, cc0,
                       cc1, scratch, scratch, scratch, scratch, scratch,
                       scratch, g[0]);
        if (sender) give(sm, mb, sl + 2, next, 0.f, false);
        // hs1 feeds the BDF phase one cell downstream too.
        const float hnext = downwind_value(hshift[0], &sm.cht[k], sm.edge_dh);
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          hs1c[c] += c < kCells - 1 ? hshift[c + 1] : hnext;
        float bc0[kCells], bc1[kCells];
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          if constexpr (SNAP) {  // hs = the CN output
            cc0[c] += hs0c[c];
            cc1[c] += hs1c[c];
            bc0[c] = bc1[c] = 0.f;
          } else {               // hs = the phase-0 BE output
            bc0[c] = hs0c[c];
            bc1[c] = hs1c[c];
          }
        }
        float e0c[kCells], e1c[kCells];
        if (!first) take(sm, mb, sl + 1, &sm.cet[k], parity);
        phase_adj<kCN>(sm.kc[1], f.b0, f.b1, x0, x1, x0, x1, f.x1_up, 0.f,
                       f.cin[1], cc0, cc1, lam + 1, j0, w.N, sm, buf, e0c,
                       e1c, scratch, scratch, scratch, scratch, pshift,
                       scratch, g[1]);
        if (sender) give(sm, mb, sl + 1, next, pshift[0], true);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          bc0[c] += e0c[c];
          bc1[c] += e1c[c];
        }
        if (!first) take(sm, mb, sl, nullptr, parity);
        phase_adj<kBE>(sm.kc[0], x0, x1, x0, x1, x0, x1, 0.f, 0.f, f.cin[0],
                       bc0, bc1, lam, j0, w.N, sm, buf, e0c, e1c, scratch,
                       scratch, scratch, scratch, scratch, scratch, g[0]);
        if (sender) give(sm, mb, sl, next, 0.f, false);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          x0c[c] += e0c[c];
          x1c[c] += e1c[c];
        }
      } else {
        constexpr int KIND = TS == 1 ? kBE : kCN;
        float e0c[kCells], e1c[kCells];
        if (!first)
          take(sm, mb, sl, KIND == kCN ? &sm.cet[k] : nullptr, parity);
        phase_adj<KIND>(sm.kc[KIND - 1], x0, x1, x0, x1, x0, x1, f.x1_up,
                        0.f, f.cin[0], oc0, oc1, lam, j0, w.N, sm, buf, e0c,
                        e1c, scratch, scratch, scratch, scratch, pshift,
                        scratch, g[0]);
        if (sender) give(sm, mb, sl, next, pshift[0], KIND == kCN);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          x0c[c] += e0c[c];
          x1c[c] += e1c[c];
        }
      }
      if constexpr (TS != 1) {
        // The e1 plane (the prev history of CN and BDF) feeds the cell
        // downstream: its cotangent flows one cell upstream.
        const float pnext =
            downwind_value(pshift[0], &sm.cet[k], sm.edge_dp);
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          x1c[c] += c < kCells - 1 ? pshift[c + 1] : pnext;
      }
      if (k == w.K - 1 && w.cop0) {
        // The launch's prev output is step K-1's input.
        float q0[kCells], q1[kCells];
        load_cells(q0, w.cop0 + w.base, j0, w.N);
        load_cells(q1, w.cop1 + w.base, j0, w.N);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          x0c[c] += q0[c];
          x1c[c] += q1[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        oc0[c] = x0c[c];
        oc1[c] = x1c[c];
      }
    }
    store_cells(w.ce0 + w.base, j0, w.N, oc0);
    store_cells(w.ce1 + w.base, j0, w.N, oc1);
    if (!first) parity ^= 1u;
  }
}

// B10 and B12, replacing _make_bwd_kernel (pallas_adjoint.py:374) and
// _make_bwd_kernel_bdf2_k (:687): one row of the transposed launch of K
// steps (K = 1 for B10) on the cluster's C blocks, the prologue, then the
// wavefront.
template <int TS, bool SNAP>
__device__ __forceinline__ void bwd_row(Shared& sm, BwdMail& mb,
                                        const BwdRow& w, int rank, int C,
                                        float (&g)[3][kNGrad]) {
  int buf = 0;
  bwd_prologue<TS, SNAP>(sm, buf, w, rank, C);
  cluster_barrier();
  bwd_wave<TS, SNAP>(sm, mb, buf, w, rank, C, g);
}

// Sums column `col` of every thread's gradient sums over the block into
// sm.red (per warp); the caller reads sm.red after a barrier.
__device__ __forceinline__ void warp_sum_to(Shared& sm, int col, float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) sm.red[col][threadIdx.x >> 5] = v;
}

// The whole of a B10/B12 cluster block: the row's lambdas and shift
// cotangents entering its last sub-tile, the mailboxes, bwd_row, the
// boundary cotangent and the row's gradient packs. The cluster of C blocks
// at blockIdx.x / C owns one row.
template <int TS>
__device__ __forceinline__ void bwd_block(
    Shared& sm, BwdMail& mb, const float* __restrict__ cbe,
    const float* __restrict__ ccn, const float* __restrict__ cbdf,
    const int* __restrict__ flip, float* rec, const float* e0g,
    const float* e1g, const float* ri0g, const float* ri1g,
    const float* co0g, const float* co1g, const float* coh0g,
    const float* coh1g, const float* cop0g, const float* cop1g,
    const float* rc, const float* ret, const float* rht, float* ce0g,
    float* ce1g, float* scr, float* __restrict__ cbc,
    float* __restrict__ gbe, float* __restrict__ gcn,
    float* __restrict__ gbdf, int Bh, int N, int K, int ntiles, int rtile,
    float s_be, float s_cn, float s_bdf, int symmetric, int reflective,
    int half0) {
  constexpr int nph = TS == 3 ? 4 : 1;
  constexpr int nkinds = TS == 3 ? 3 : 1;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cr = blockIdx.x / C;
  const int row = cr % Bh;
  const int h = half0 + cr / Bh;
  const int hr = h * Bh + row;
  const int slots = nph * K;
  const int sub = blockDim.x * kCells;
  const int G = (N + sub - 1) / sub;
  load_row_coefs(sm, cbe, ccn, cbdf, hr);
  // Lambdas entering the row's last sub-tile: 0, or for the mu<0 half of a
  // reflective slab s_p * the flipped row's mu>0 inflow cotangent; shift
  // cotangents 0. The mailboxes' cluster-wide sync orders these before
  // every read.
  for (int i = threadIdx.x; i < slots; i += blockDim.x)
    sm.carry[i] = (h == 0 && reflective)
                      ? phase_s<TS>(i % nph, s_be, s_cn, s_bdf) *
                            rec[flip[row] * slots + i]
                      : 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    sm.cet[k] = sm.cht[k] = 0.f;
  open_mailboxes(mb, slots);
  const size_t stride = static_cast<size_t>(Bh) * ntiles;
  const BwdRow w{e0g, e1g, ri0g, ri1g, co0g, co1g, coh0g, coh1g, cop0g,
                 cop1g,
                 rc + static_cast<size_t>(h) * slots * stride + row * ntiles,
                 ret + static_cast<size_t>(h) * K * stride + row * ntiles,
                 rht + static_cast<size_t>(h) * K * stride + row * ntiles,
                 ce0g, ce1g,
                 scr + static_cast<size_t>(hr) * G * (slots + K),
                 static_cast<size_t>(hr) * N,
                 static_cast<size_t>(2) * Bh * N, stride, N, K, slots,
                 ntiles, rtile, sub, G};
  float g[3][kNGrad];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kNGrad; ++i) g[k][i] = 0.f;
  if (TS == 3 && !(symmetric || h == 0))
    bwd_row<TS, false>(sm, mb, w, rank, C, g);
  else
    bwd_row<TS, true>(sm, mb, w, rank, C, g);

  // The row's start reached: thread 0 of the block that ran the first
  // sub-tile holds (wrote) every slot's inflow cotangent. They fold into bc
  // with each phase's s; for a reflective slab bc feeds the mu<0 half only
  // and the mu>0 ones go to the record.
  if (rank == (G - 1) % C && threadIdx.x == 0) {
    if (h == 1 && reflective) {
      for (int i = 0; i < slots; ++i) rec[row * slots + i] = sm.carry[i];
    } else {
      float acc = 0.f;
      for (int i = 0; i < slots; ++i)
        acc = acc + phase_s<TS>(i % nph, s_be, s_cn, s_bdf) * sm.carry[i];
      cbc[hr] = acc;
    }
  }
  // The packs: each block's partials, then rank 0 adds them in rank order.
  for (int k = 0; k < nkinds; ++k)
#pragma unroll
    for (int i = 0; i < kNGrad; ++i) warp_sum_to(sm, k * kNGrad + i, g[k][i]);
  __syncthreads();
  if (threadIdx.x < nkinds * kNGrad) {
    float v = 0.f;
    for (int wp = 0; wp < (int)(blockDim.x >> 5); ++wp)
      v += sm.red[threadIdx.x][wp];
    sm.part[threadIdx.x] = v;
  }
  cluster_barrier();
  if (rank == 0 && threadIdx.x < nkinds * kNGrad) {
    const int k = threadIdx.x / kNGrad, i = threadIdx.x % kNGrad;
    float v = 0.f;
    for (int r = 0; r < C; ++r)
      v += *cluster.map_shared_rank(&sm.part[threadIdx.x], r);
    float* out = TS == 3 ? (k == 0 ? gbe : (k == 1 ? gcn : gbdf))
                         : (TS == 1 ? gbe : gcn);
    out += hr * kNCoef;
    // Columns [w, T0, q, idet, a, Sb, c1, c0, kee, kp]; Sb and c0 share S.
    out[i < 7 ? i : i + 1] = v;
    if (i == 5) out[7] = v;
  }
  // No block leaves while rank 0 reads its partials or a peer may still
  // address its mailboxes.
  close_mailboxes();
}

// B10: one BE, CN or BDF2 step (K = 1 at compile time).
template <int TS>
__global__ void __launch_bounds__(kMaxThreads)
    bwd_kernel(const float* __restrict__ cbe, const float* __restrict__ ccn,
               const float* __restrict__ cbdf, const int* __restrict__ flip,
               float* rec, const float* e0g, const float* e1g,
               const float* co0g, const float* co1g, const float* coh0g,
               const float* coh1g, const float* rc, const float* ret,
               const float* rht, float* ce0g, float* ce1g, float* scr,
               float* __restrict__ cbc, float* __restrict__ gbe,
               float* __restrict__ gcn, float* __restrict__ gbdf, int Bh,
               int N, int ntiles, int rtile, float s_be, float s_cn,
               float s_bdf, int symmetric, int reflective, int half0) {
  __shared__ Shared sm;
  __shared__ BwdMail mb;
  bwd_block<TS>(sm, mb, cbe, ccn, cbdf, flip, rec, e0g, e1g, nullptr,
                nullptr, co0g, co1g, coh0g, coh1g, nullptr, nullptr, rc, ret,
                rht, ce0g, ce1g, scr, cbc, gbe, gcn, gbdf, Bh, N, 1, ntiles,
                rtile, s_be, s_cn, s_bdf, symmetric, reflective, half0);
}

// B12: K BDF2 steps, newest to oldest at every sub-tile, in ONE launch.
__global__ void __launch_bounds__(kMaxThreads)
    bwd_k_kernel(const float* __restrict__ cbe, const float* __restrict__ ccn,
                 const float* __restrict__ cbdf, const int* __restrict__ flip,
                 float* rec, const float* e0g, const float* e1g,
                 const float* ri0g, const float* ri1g, const float* co0g,
                 const float* co1g, const float* coh0g, const float* coh1g,
                 const float* cop0g, const float* cop1g, const float* rc,
                 const float* ret, const float* rht, float* ce0g,
                 float* ce1g, float* scr, float* __restrict__ cbc,
                 float* __restrict__ gbe, float* __restrict__ gcn,
                 float* __restrict__ gbdf, int Bh, int N, int K, int ntiles,
                 int rtile, float s_be, float s_cn, float s_bdf,
                 int symmetric, int reflective, int half0) {
  __shared__ Shared sm;
  __shared__ BwdMail mb;
  bwd_block<3>(sm, mb, cbe, ccn, cbdf, flip, rec, e0g, e1g, ri0g, ri1g, co0g,
               co1g, coh0g, coh1g, cop0g, cop1g, rc, ret, rht, ce0g, ce1g,
               scr, cbc, gbe, gcn, gbdf, Bh, N, K, ntiles, rtile, s_be, s_cn,
               s_bdf, symmetric, reflective, half0);
}

// B9's and B11's threads a row block (B1's), and whether ntiles is B9's
// tile count for N.
inline int fwd_threads(int N) {
  return pick_threads(N, kFwdCells, kFwdThreads);
}
inline bool tiles_ok(int N, int ntiles) {
  const int tile = fwd_threads(N) * kFwdCells;
  return ntiles == (N + tile - 1) / tile;
}

// B10's and B12's threads a block: half of B9's rounded up to a warp (256
// for a row of several record tiles: 1024-cell sub-tiles split a 4096-cell
// record tile exactly; a row of fewer cells is one record tile), at most
// max_threads, a power of two, so that the sub-tiles still split a record
// tile.
inline int bwd_threads(int N, int max_threads) {
  const int t = 32 * ((fwd_threads(N) + 63) / 64);
  return t < max_threads ? t : max_threads;
}

// launch_halves_ex (cluster.cuh) in the backward's reversed order: the mu>0
// half records its inflow cotangents, which the mu<0 half's lambdas start
// from. A refused first half skips the second and its error is returned.
template <typename Launch>
int launch_halves_rev(int Bh, int reflective, Launch launch) {
  cudaError_t err = reflective ? launch(Bh, 1) : launch(2 * Bh, 0);
  if (err == cudaSuccess && reflective) err = launch(Bh, 0);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// it refuses (ntiles other than this file's tile count for N among them).
// Planes are contiguous (2, Bh, N) float32 (the h planes and their
// cotangents only for BDF2, else null), coefficients (2, Bh, 10), bc
// (2, Bh, 1), flip (Bh,) int32, rc (2, nph, Bh, ntiles), ret/rht
// (2, Bh, ntiles), rec a (Bh, nph) scratch record, nph = 4 for BDF2 else 1.

int rt_adj_fwd_record(int ts_method, const float* cbe, const float* ccn,
                      const float* cbdf, const float* bc, const int* flip,
                      float* rec, const float* e0, const float* e1, float* o0,
                      float* o1, float* oh0, float* oh1, float* rc,
                      float* ret, float* rht, int Bh, int N, int ntiles,
                      float s_be, float s_cn, float s_bdf, int symmetric,
                      int reflective, void* stream) {
  if (Bh < 1 || N < 1 || ts_method < 1 || ts_method > 3 ||
      !tiles_ok(N, ntiles) || (ts_method == 3 && (!oh0 || !oh1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = fwd_threads(N);
  return launch_halves(Bh, reflective, [&](int grid, int half0) {
    if (ts_method == 1)
      fwd_record_kernel<1><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, bc, flip, rec, e0, e1, o0, o1, oh0, oh1, rc, ret,
          rht, Bh, N, ntiles, s_be, s_cn, s_bdf, symmetric, reflective,
          half0);
    else if (ts_method == 2)
      fwd_record_kernel<2><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, bc, flip, rec, e0, e1, o0, o1, oh0, oh1, rc, ret,
          rht, Bh, N, ntiles, s_be, s_cn, s_bdf, symmetric, reflective,
          half0);
    else
      fwd_record_kernel<3><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, bc, flip, rec, e0, e1, o0, o1, oh0, oh1, rc, ret,
          rht, Bh, N, ntiles, s_be, s_cn, s_bdf, symmetric, reflective,
          half0);
  });
}

// B10's and B12's launch shape for rows of N cells at K steps of
// slots_per_step slots each (4: BDF2, B10 at K = 1 or B12; 1: B10 at BE or
// CN, K = 1), at most max_threads threads a block (a power of two from 32
// to 256) and max_cluster blocks a row, `rows` rows a launch (Bh for a
// reflective boundary, else 2*Bh): out = (threads a block, blocks a row
// (the cluster), sub-tiles a row). The wrapper's scratch is (2, Bh,
// sub-tiles, slots + K) floats.
int rt_adj_bwd_geometry(int N, int K, int slots_per_step, int max_threads,
                        int max_cluster, int rows, int* out) {
  if (N < 1 || K < 1 || K > kMaxSteps ||
      (slots_per_step != 4 && slots_per_step != 1) ||
      (slots_per_step == 1 && K != 1) || max_threads < 32 ||
      max_threads > kMaxThreads || (max_threads & (max_threads - 1)) ||
      max_cluster < 1 || max_cluster > kMaxCluster || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = bwd_threads(N, max_threads);
  const int subs = (N + threads * kCells - 1) / (threads * kCells);
  out[0] = threads;
  out[1] = slots_per_step == 4
               ? wave_cluster(subs, 4 * K, threads, max_cluster, rows,
                              {reinterpret_cast<const void*>(&bwd_kernel<3>),
                               reinterpret_cast<const void*>(&bwd_k_kernel)})
               : wave_cluster(subs, 1, threads, max_cluster, rows,
                              {reinterpret_cast<const void*>(&bwd_kernel<1>),
                               reinterpret_cast<const void*>(&bwd_kernel<2>)});
  out[2] = subs;
  return 0;
}

// scr: the (2, Bh, sub-tiles, slots + K) float32 prologue scratch of
// rt_adj_bwd_geometry's shape; max_threads and max_cluster as there.
int rt_adj_bwd(int ts_method, const float* cbe, const float* ccn,
               const float* cbdf, const int* flip, float* rec,
               const float* e0, const float* e1, const float* co0,
               const float* co1, const float* coh0, const float* coh1,
               const float* rc, const float* ret, const float* rht,
               float* scr, float* ce0, float* ce1, float* cbc, float* gbe,
               float* gcn, float* gbdf, int Bh, int N, int ntiles,
               float s_be, float s_cn, float s_bdf, int symmetric,
               int reflective, int max_threads, int max_cluster,
               void* stream) {
  if (Bh < 1 || N < 1 || ts_method < 1 || ts_method > 3 ||
      !tiles_ok(N, ntiles) || (ts_method == 3 && (!coh0 || !coh1)) || !scr)
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_adj_bwd_geometry(N, 1, ts_method == 3 ? 4 : 1,
                                      max_threads, max_cluster,
                                      reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rtile = fwd_threads(N) * kFwdCells;
  auto* kernel = ts_method == 1   ? &bwd_kernel<1>
                 : ts_method == 2 ? &bwd_kernel<2>
                                  : &bwd_kernel<3>;
  // A refused cluster launch returns its error, and the second half is not
  // launched.
  return launch_halves_rev(Bh, reflective, [&](int rows, int half0) {
    return launch_clusters(kernel, rows, geo[1], geo[0], st, cbe, ccn, cbdf,
                           flip, rec, e0, e1, co0, co1, coh0, coh1, rc, ret,
                           rht, ce0, ce1, scr, cbc, gbe, gcn, gbdf, Bh, N,
                           ntiles, rtile, s_be, s_cn, s_bdf, symmetric,
                           reflective, half0);
  });
}

// The K-fused pair (B11, B12): BDF2 only, 1 <= K <= kMaxSteps; rc is
// (2, 4K, Bh, ntiles), ret/rht (2, K, Bh, ntiles), ri0/ri1 (K-1, 2, Bh, N)
// (step k's input at k-1; null at K = 1), rec a (Bh, 4K) scratch record;
// B11 also writes op0/op1, the last step's input; B12 takes its cotangent
// cop0/cop1 beside those of the ends (co) and the half snapshot (coh).

// B11's launch shape for rows of N cells at K steps, at most max_cluster
// blocks a row, `rows` rows a launch (Bh for a reflective boundary, else
// 2*Bh): out = (threads a block, blocks a row (the cluster), tiles a row).
// The tiles are B9's record tiles (B1's at 512 threads at most).
int rt_adj_fwd_record_k_geometry(int N, int K, int max_cluster, int rows,
                                 int* out) {
  if (N < 1 || K < 1 || K > kMaxSteps || max_cluster < 1 ||
      max_cluster > kMaxCluster || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = fwd_threads(N);
  const int tiles = (N + threads * kFwdCells - 1) / (threads * kFwdCells);
  out[0] = threads;
  out[1] = wave_cluster(tiles, 4 * K, threads, max_cluster, rows,
                        {reinterpret_cast<const void*>(&fwd_record_k_kernel)});
  out[2] = tiles;
  return 0;
}

// max_cluster as rt_adj_fwd_record_k_geometry's.
int rt_adj_fwd_record_k(const float* cbe, const float* ccn, const float* cbdf,
                        const float* bc, const int* flip, float* rec,
                        const float* e0, const float* e1, float* o0,
                        float* o1, float* oh0, float* oh1, float* op0,
                        float* op1, float* rc, float* ret, float* rht,
                        float* ri0, float* ri1, int Bh, int N, int K,
                        int ntiles, float s_be, float s_cn, float s_bdf,
                        int symmetric, int reflective, int max_cluster,
                        void* stream) {
  if (Bh < 1 || !tiles_ok(N, ntiles) || (K > 1 && (!ri0 || !ri1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_adj_fwd_record_k_geometry(
      N, K, max_cluster, reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A refused cluster launch returns its error, and the second half is not
  // launched.
  return launch_halves_ex(Bh, reflective, [&](int grid, int half0) {
    return launch_clusters(fwd_record_k_kernel, grid, geo[1], geo[0], st, cbe,
                           ccn, cbdf, bc, flip, rec, e0, e1, o0, o1, oh0, oh1,
                           op0, op1, rc, ret, rht, ri0, ri1, Bh, N, K, ntiles,
                           s_be, s_cn, s_bdf, symmetric, reflective, half0);
  });
}

int rt_adj_bwd_k(const float* cbe, const float* ccn, const float* cbdf,
                 const int* flip, float* rec, const float* e0,
                 const float* e1, const float* ri0, const float* ri1,
                 const float* co0, const float* co1, const float* coh0,
                 const float* coh1, const float* cop0, const float* cop1,
                 const float* rc, const float* ret, const float* rht,
                 float* scr, float* ce0, float* ce1, float* cbc, float* gbe,
                 float* gcn, float* gbdf, int Bh, int N, int K, int ntiles,
                 float s_be, float s_cn, float s_bdf, int symmetric,
                 int reflective, int max_threads, int max_cluster,
                 void* stream) {
  if (Bh < 1 || N < 1 || K < 1 || K > kMaxSteps || !tiles_ok(N, ntiles) ||
      (K > 1 && (!ri0 || !ri1)) || !coh0 || !coh1 || !cop0 || !cop1 || !scr)
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_adj_bwd_geometry(N, K, 4, max_threads, max_cluster,
                                      reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rtile = fwd_threads(N) * kFwdCells;
  return launch_halves_rev(Bh, reflective, [&](int rows, int half0) {
    return launch_clusters(bwd_k_kernel, rows, geo[1], geo[0], st, cbe, ccn,
                           cbdf, flip, rec, e0, e1, ri0, ri1, co0, co1, coh0,
                           coh1, cop0, cop1, rc, ret, rht, ce0, ce1, scr, cbc,
                           gbe, gcn, gbdf, Bh, N, K, ntiles, rtile, s_be,
                           s_cn, s_bdf, symmetric, reflective, half0);
  });
}

}  // extern "C"
