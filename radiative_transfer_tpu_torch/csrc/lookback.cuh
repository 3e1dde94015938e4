// The single-pass chained scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016)
// that B3 (sweep.cu substep_kernel, one slot), B9 (adjoint.cu
// fwd_record_kernel) and B13 (fused.cu fused_step_kernel) run: one thread
// block a tile of a row, S scan slots a tile (the sub-steps of a step, in
// order), each slot's carries chained across the row's tiles by its own
// status words. B8 (sharded.cu) runs the one-slot case with its own copy of
// the words and is left as it is.
//
// Why it fits. `a` is constant along a row, so a full tile's map of a slot's
// carry is x -> a^L * x + B_t and only the one float B_t has to travel
// between tiles. Across tiles a slot depends on two things only: the same
// slot's carry, which the look-back resolves, and a one-cell upwind edge (the
// CN/BDF shifts), which is the predecessor tile's output of an EARLIER slot.
// So a launch's serial depth is about the slots times one look-back, not the
// tiles times one hop.
//
// The protocol, per block:
// * Tickets. Thread 0 takes the block's ticket from a per-launch counter
//   (lb_ticket); B3 and B9 map it tile-major across a group of rows
//   (lb_tile), B13 across its packed rows, so every tile's predecessors in
//   its row took smaller tickets. A block waits only on words of smaller
//   tickets (its row's earlier tiles; B3's and B9's mu>0 row start on the
//   mu<0 half, whose tickets all come first), and a ticket is only handed
//   to a block that is running: no block waits on one that has not
//   started.
// * Status words. One 64-bit word a (slot, row, tile): the flag in the high
//   half, the float in the low, stored and loaded as one access (B8's
//   words), so a reader that sees a flag sees its value. Warp 0, which runs
//   the tile scan's cross-warp pass, publishes (AGGREGATE, B_t) as soon as
//   that pass has the tile's map, then, once its look-back has resolved the
//   carry entering the tile, (INCLUSIVE, a^L * carry_in + B_t). Tile 0
//   knows its carry at once (the row's inflow, which need not be zero) and
//   publishes only INCLUSIVE, so every look-back ends at tile 0 at the
//   latest: a lane before the row's start reads as a ready AGGREGATE 0 and
//   never ends one. The row's last tile (perhaps ragged; no tile looks back
//   through it) publishes only INCLUSIVE, from the owner of its last real
//   cell after the reconstruction: the carry leaving the row (B3's and
//   B9's mu<0 outflow, lb_row_inflow).
// * Edge words. The one-cell edges a successor's shift reads (a slot's
//   last-cell output) are words of their own, (EDGE, value), written by the
//   thread that holds the tile's last cell after the slot's reconstruction
//   with st.release.gpu and read by the successor's thread 0 with
//   ld.acquire.gpu, spinning until the flag is set. Each carries its own
//   flag: no reader infers an edge's presence from another word. B3 reads
//   its edges from its input planes and has none.
// * Scratch. The status and edge words and the counter live in one scratch
//   the entry point zeroes on the stream before each launch.
//
// The scan is exact over each tile; across tiles it composes the tiles' maps
// in an order that depends on timing, which is rounding, not truncation:
// repeated launches need not agree to the bit.

#pragma once

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

// A word's flag; 0 is "not yet written".
constexpr unsigned kLbAggregate = 1u, kLbInclusive = 2u, kLbEdge = 3u;

// A spinning warp backs off between reads of an unwritten word: it sleeps
// from kLbSleepMin ns, doubling up to kLbSleepMax, so that spinning warps do
// not load L2 for everyone.
constexpr unsigned kLbSleepMin = 32u, kLbSleepMax = 1024u;

__device__ __forceinline__ void lb_backoff(unsigned& ns) {
  __nanosleep(ns);
  if (ns < kLbSleepMax) ns *= 2;
}

// Per-block shared state of a look-back kernel (upwind_value reads the edge
// arrays by these names).
struct LookbackShared {
  float scanA[2][32];  // cross-warp scan, double-buffered
  float scanB[2][32];
  float edge_p[32];    // last cell of each warp, for the p1 shift
  float edge_h[32];    // last cell of each warp, for the h1 shift
  float c_in;          // the carry entering the tile, once resolved
  float ptail, htail;  // thread 0's upwind p1/h1 values of the tile
  int ticket;
};

__device__ __forceinline__ unsigned long long lb_pack(unsigned flag,
                                                      float v) {
  return (static_cast<unsigned long long>(flag) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void lb_publish(unsigned long long* w,
                                           unsigned flag, float v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(w),
               "l"(lb_pack(flag, v))
               : "memory");
}

__device__ __forceinline__ unsigned long long lb_peek(
    const unsigned long long* w) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(word)
               : "l"(w)
               : "memory");
  return word;
}

// Thread 0 of a block: the block's ticket from the counter at `counter`,
// into sm.ticket (read by every thread after the caller's barrier).
__device__ __forceinline__ void lb_ticket(LookbackShared& sm,
                                          unsigned long long* counter) {
  if (threadIdx.x == 0)
    sm.ticket = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(counter), 1u));
}

// The value of an INCLUSIVE word, spinning until it is written (one
// thread).
__device__ __forceinline__ float lb_wait_inclusive(
    const unsigned long long* w) {
  for (unsigned ns = kLbSleepMin;; lb_backoff(ns)) {
    const unsigned long long word = lb_peek(w);
    if (static_cast<unsigned>(word >> 32) == kLbInclusive)
      return __uint_as_float(static_cast<unsigned>(word));
  }
}

// An edge word: written once, with release, by the thread that holds the
// tile's last cell; read by the successor's thread 0, with acquire,
// spinning until it is written.
__device__ __forceinline__ void lb_publish_edge(unsigned long long* w,
                                                float v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(w),
               "l"(lb_pack(kLbEdge, v))
               : "memory");
}

__device__ __forceinline__ float lb_wait_edge(const unsigned long long* w) {
  for (unsigned ns = kLbSleepMin;; lb_backoff(ns)) {
    unsigned long long word;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(word)
                 : "l"(w)
                 : "memory");
    if (static_cast<unsigned>(word >> 32) == kLbEdge)
      return __uint_as_float(static_cast<unsigned>(word));
  }
}

// The tile a ticket stands for: tickets run tile-major across the rows of a
// group, both halves' rows for a source boundary, else the mu<0 half's rows
// first and then the mu>0 half's, whose row starts wait on the mu<0 outflow
// (lb_row_inflow), so every word a block waits on has a smaller ticket.
struct LbTile {
  int h, row, t;
};

__device__ __forceinline__ LbTile lb_tile(int ticket, int Bh, int T,
                                          int reflective) {
  const int group = reflective ? Bh : 2 * Bh;
  const int per = group * T;
  const int g = ticket / per, rem = ticket - g * per;
  const int t = rem / group;
  const int hr = g * group + rem - t * group;
  const int h = hr / Bh;
  return {h, hr - h * Bh, t};
}

// Tile 0's carry in for row `row` of half h (hr = h * Bh + row) of a slot
// whose status words of the launch, (2 * Bh, T), start at `st`: s times the
// boundary value, or for the mu>0 half of a reflective slab s times the
// mu<0 outflow of the flipped row, the INCLUSIVE word of that row's last
// tile, waited on (one thread).
__device__ __forceinline__ float lb_row_inflow(
    float s, const unsigned long long* st, int h, int row, int hr, int T,
    int reflective, const float* __restrict__ bc,
    const int* __restrict__ flip) {
  const float in =
      (h == 1 && reflective)
          ? lb_wait_inclusive(st + static_cast<size_t>(flip[row]) * T + T - 1)
          : bc[hr];
  return s * in;
}

// The carry entering tile t > 0 of a slot whose status words of the row
// start at `st`, by one whole warp: lane i reads the word of tile j - i,
// spinning until every lane up to the nearest INCLUSIVE one holds a word;
// then the lanes' values, weighted (a^L)^i, are summed. Every tile before
// the row's last is full, so each has the map x -> a_tile * x + B. Tile 0
// is INCLUSIVE once written, so a lane before the row's start (a ready
// AGGREGATE 0) is never the nearest INCLUSIVE one.
__device__ __forceinline__ float lb_look_back(const unsigned long long* st,
                                              int t, float a_tile) {
  const int lane = threadIdx.x & 31;
  float wl = lane ? a_tile : 1.f;  // a_tile^lane, by a product scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, wl, d);
    if (lane >= d) wl *= o;
  }
  const float a32 = __shfl_sync(kFull, wl, 31) * a_tile;
  float acc = 0.f, mult = 1.f;
  for (int j = t - 1;; j -= 32) {
    const int jt = j - lane;
    unsigned long long word;
    unsigned incl;
    for (unsigned ns = kLbSleepMin;; lb_backoff(ns)) {
      word = jt >= 0 ? lb_peek(st + jt)
                     : static_cast<unsigned long long>(kLbAggregate) << 32;
      const unsigned flag = static_cast<unsigned>(word >> 32);
      incl = __ballot_sync(kFull, flag == kLbInclusive);
      const unsigned ready = __ballot_sync(kFull, flag != 0u);
      // Lanes 0 .. the nearest INCLUSIVE one (all 32 if there is none).
      const unsigned need = incl ? ((incl & (0u - incl)) << 1) - 1u : kFull;
      if ((ready & need) == need) break;
    }
    const int last = incl ? __ffs(incl) - 1 : 31;
    float v = lane <= last
                  ? wl * __uint_as_float(static_cast<unsigned>(word))
                  : 0.f;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    acc += mult * v;
    if (incl) return acc;
    mult *= a32;
  }
}

// One slot of kind KIND over this thread's C cells of tile t of a row of T
// tiles (the tile's last real cell is the thread's cell `owner`, or -1):
// the right-hand sides (substep_rhs), the tile's scan from a zero carry
// with the look-back folded into its cross-warp pass, and the 2x2
// reconstruction of every cell from its carry (substep_out). Warp 0, which
// runs the cross-warp pass, holds the tile's whole map (a^L, B_t) at its
// end: it publishes (AGGREGATE, B_t), looks back (or, at tile 0, thread 0
// calls `inflow()`), publishes (INCLUSIVE, a^L * carry_in + B_t) and hands
// the carry to the block through one barrier, so a slot costs two block
// barriers. The row's last tile, which may be ragged, publishes no
// aggregate (no tile looks back through it) and its INCLUSIVE word from
// the owner of its last real cell after the reconstruction: the carry
// leaving that cell. `st`: the slot's status words of the row. Returns the
// carry entering the tile; the owner also gets the carry leaving the
// tile's last real cell in `c_out`.
template <int KIND, int C, class Inflow>
__device__ __forceinline__ float lb_substep(
    const Coef& k, const float (&e0)[C], const float (&e1)[C],
    const float (&p0)[C], const float (&p1)[C], const float (&h0)[C],
    const float (&h1)[C], float p1_up, float h1_up, int t, int T, int owner,
    unsigned long long* st, Inflow inflow, LookbackShared& sm, int& buf,
    float (&o0)[C], float (&o1)[C], float& c_out) {
  float r0[C], r1[C], b[C], A, B;
  substep_rhs<KIND>(k, e0, e1, p0, p1, h0, h1, p1_up, h1_up, r0, r1, b, A, B);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // block_exclusive_scan's passes (tiles.cuh), the look-back between them.
  warp_inclusive_scan(A, B);
  if (lane == 31) {
    sm.scanA[buf][warp] = A;
    sm.scanB[buf][warp] = B;
  }
  __syncthreads();
  if (warp == 0) {
    float wA = lane < nwarps ? sm.scanA[buf][lane] : 1.f;
    float wB = lane < nwarps ? sm.scanB[buf][lane] : 0.f;
    warp_inclusive_scan(wA, wB);
    // The tile's map over all its cells: a^L and B_t.
    const float tA = __shfl_sync(kFull, wA, nwarps - 1);
    const float tB = __shfl_sync(kFull, wB, nwarps - 1);
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
    const bool full = t + 1 < T;  // every tile but the row's last is full
    if (t && full && lane == 0) lb_publish(st + t, kLbAggregate, tB);
    float c_in = 0.f;
    if (t)
      c_in = lb_look_back(st, t, tA);
    else if (lane == 0)
      c_in = inflow();
    if (lane == 0) {
      if (full) lb_publish(st + t, kLbInclusive, tA * c_in + tB);
      sm.c_in = c_in;
    }
  }
  __syncthreads();
  const float wA = sm.scanA[buf][warp], wB = sm.scanB[buf][warp];
  float xA = __shfl_up_sync(kFull, A, 1);
  float xB = __shfl_up_sync(kFull, B, 1);
  if (lane == 0) {
    xA = 1.f;
    xB = 0.f;
  }
  buf ^= 1;
  const float c_in = sm.c_in;
  // xA * wA, xA * wB + xB: the map from the tile's carry in to this
  // thread's first cell.
  substep_out(k, r0, r1, b, (xA * wA) * c_in + (xA * wB + xB), &c_out, owner,
              o0, o1);
  if (t + 1 == T && owner >= 0) lb_publish(st + t, kLbInclusive, c_out);
  return c_in;
}

// Whether lb_geometry takes rows of N cells at most max_threads threads a
// block: N >= 1 and max_threads a power of two from 32 to cap.
inline bool lb_shape_ok(int N, int max_threads, int cap) {
  return N >= 1 && max_threads >= 32 && max_threads <= cap &&
         !(max_threads & (max_threads - 1));
}

// The launch shape of a look-back kernel for rows of N cells, C cells a
// thread, at most max_threads threads (a power of two): (threads, tiles).
inline void lb_geometry(int N, int cells, int max_threads, int* out) {
  const int threads = pick_threads(N, cells, max_threads);
  out[0] = threads;
  out[1] = (N + threads * cells - 1) / (threads * cells);
}

}  // namespace
