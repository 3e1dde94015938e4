// Hand-written Hopper (sm_90a) kernels for the kernel-rate adjoint at K = 1.
//
// Replaces the Pallas TPU kernel factories of
// radiative_transfer_tpu/ops/pallas_adjoint.py:
//   rt_adj_fwd_record <- _make_fwd_record_kernel (B9: one whole BE, CN or
//                        BDF2 step, plus per-tile entry records)
//   rt_adj_bwd        <- _make_bwd_kernel        (B10: the transposed step)
// The wrappers are ops/cuda_adjoint.py fwd_record_launch and bwd_launch; the
// plain PyTorch versions beside them keep the JAX blocks and truncated scans.
//
// What is computed. A step is one sub-step (BE, CN) or the BDF2 cycle of four
// (BE, CN, BE, BDF). Per row (direction half h, batch r) and per sub-step:
// right-hand sides r0, r1 of every cell, the recurrence
// carry_j = a*carry_{j-1} + b_j along the row in sweep order, the 2x2
// reconstruction (ops/cuda_sweep.py _substep_block). B9 runs the step and
// records, at the entry of each of its tiles, each phase's carry and the
// upwind e1 and hs1 edges: (2, nph, Bh, ntiles) and (2, Bh, ntiles). B10
// takes the cotangents of the step's outputs and returns those of its input
// planes, of the boundary values and of the ten packed coefficients
// [w, T0, q, idet, a, Sb, c1, c0, kee, kp] of each kind (summed over the
// row's cells): the step is affine in the state, so the state adjoint is
// the transposed cycle; the coefficient gradients need the primal values,
// which B10 recomputes per tile from the input planes and B9's records.
//
// Design. Both follow B1 (sweep.cu): ONE thread block owns ONE row and walks
// it in tiles with a loop inside the block; each phase's scan is exact
// (serial over a thread's cells, a warp-shuffle scan of affine maps, one
// cross-warp pass: tiles.cuh).
// * B9 tiles a row as B1 does (8 cells a thread, at most 512 threads, so
//   4096-cell tiles) and runs B1's own sub-step routine (tiles.cuh
//   substep_tile), so its step is B1's at K = 1; it skips the prev planes
//   (the inputs by definition) and, for BE/CN, the half planes. Thread 0
//   writes each record as it reads it: the carry entering the tile in each
//   phase's scan, the upwind edges in the exchanges.
// * B10 walks each row's record tiles last to first, each in two passes
//   over sub-tiles of blockDim*4 cells (half B1's cells a thread, at most
//   256 threads: 1024-cell sub-tiles, four to a 4096-cell record tile).
//   Pass 1 runs the forward over the sub-tiles in order from the tile's
//   records and keeps each sub-tile's entering carries and hs1 edge in
//   shared memory. Pass 2 visits the sub-tiles last to first: it loads e0,
//   e1 and the output cotangents, recomputes the forward phases from the
//   kept values, then runs the adjoint phases in reverse order
//   (phase_adj). The adjoint of the carry scan is the same scan of maps
//   lambda -> a*lambda + x run right to left (block_exclusive_scan_rev:
//   __shfl_down_sync and a mirrored cross-warp pass); each phase's lambda
//   enters from the downstream sub-tile, visited before, through a shared
//   slot. The cotangents of the CN/BDF upwind shifts flow one cell
//   upstream (downwind_value); at a sub-tile's last cell they come from
//   the downstream sub-tile's first cell, kept in shared memory
//   double-buffered by visit parity. So B10 runs the forward twice and the
//   adjoint once; its recomputed primals round as 1024-cell tiles do,
//   which moves only the coefficient gradients, at f32 roundoff.
// * Coefficient gradients: each thread sums its cells' terms over all its
//   sub-tiles in registers (BE phases 0 and 2, CN phase 1, BDF phase 3);
//   at the row's end a warp-shuffle and shared-memory reduction writes each
//   column once. This sums in another order than Pallas's per-block sums.
// * Reflective left boundary: forward, the mu<0 launch records its outflow
//   carries and the mu>0 launch reads them through `flip` (B1's scheme).
//   Backward, the order is reversed: the mu>0 launch records each phase's
//   inflow cotangent and the mu<0 launch starts its lambdas from s_p times
//   that record, gathered through `flip`; only the mu<0 half's cotangent
//   goes to bc. With a source boundary both halves share one launch.
// * Registers: B10 holds the step input, the three phase outputs it needs
//   and four phases' entering carries for 4 cells a thread (48 values),
//   plus the cotangents and 27 gradient sums; coefficients sit in shared
//   memory. Hence 4 cells and at most 256 threads (up to 255 registers).
// * Cells past N in a row's last tile load as 0; forward they lie
//   downstream of every real cell; backward their maps are the identity and
//   their cotangents are forced to 0.
//
// What bounds it on this card: the serial carry chain of each row, as for B1
// (sweep.cu header): per 4096 cells B9 runs 4 scans (BDF2) and B10 48 (four
// sub-tiles of 8 forward and 4 reversed) and 16 neighbour exchanges, each
// with block barriers, on 2*Bh blocks (Bh at a time for a reflective
// slab). Device-memory traffic is small beside that:
// B9 reads 2 planes and writes 4, B10 reads 6 and writes 2.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

// B9 tiles a row as B1 does (sweep.cu): kFwdCells consecutive cells a
// thread, at most kFwdThreads threads; its records are per such tile. B10
// walks each record tile as sub-tiles of blockDim*kCells cells, with half
// B9's threads (at least a warp) and half its cells a thread.
constexpr int kFwdCells = 8;
constexpr int kFwdThreads = 512;
constexpr int kCells = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSub = 4;         // sub-tiles of a record tile
constexpr int kNGrad = 9;          // w T0 q idet a S(=Sb=c0) c1 kee kp

struct Shared {
  Coef kc[3];                  // BE, CN, BDF coefficients of this row
  float carry[4];              // B9: each phase's carry entering the tile;
                               // B10: each phase's lambda from downstream
  float fcarry[4];             // B10: the forward carries of its first pass
  float sub_carry[kMaxSub][4];  // B10: each sub-tile's entering carries
  float sub_ht[kMaxSub];       // B10: the hs1 edge upwind of each sub-tile
  float htail;                 // hs1 of the previous (sub-)tile's last cell
  float cet[2], cht[2];        // B10: shift cotangents from downstream,
                               // double-buffered by tile parity
  float scanA[2][32];          // cross-warp scan, double-buffered
  float scanB[2][32];
  float edge_p[32], edge_h[32];    // upwind exchanges
  float edge_dp[32], edge_dh[32];  // downwind exchanges
  float red[3 * kNGrad][kMaxWarps];  // row-end gradient reduction
};

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
      const float hs1_up = upwind_value(hs1[kFwdCells - 1], &sm.htail,
                                        sm.edge_h);
      if (lead) rht[ebase + t] = hs1_up;
      float d0[kFwdCells], d1[kFwdCells];
      record(2, substep_tile<kBE>(sm.kc[0], c0, c1, x0, x1, hs0, hs1, 0.f,
                                  0.f, &sm.carry[2], owner, sm, buf, d0, d1));
      record(3, substep_tile<kBDF>(sm.kc[2], d0, d1, x0, x1, hs0, hs1, x1_up,
                                   hs1_up, &sm.carry[3], owner, sm, buf, o0,
                                   o1));
      if (tail_thread) sm.htail = hs1[kFwdCells - 1];
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
  if (threadIdx.x == 0) sm.htail = 0.f;
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

// B10, replaces _make_bwd_kernel (pallas_adjoint.py:374): one row of the
// transposed step. B9's record tiles (rtile cells) are visited last to
// first; each in two passes over its sub-tiles of blockDim*kCells cells:
// first in order, the forward from the tile's records, keeping each
// sub-tile's entering carries and hs1 edge in shared memory; then last to
// first, the forward recomputed from those and the adjoint phases in
// reverse order. g holds this thread's gradient sums, kNGrad per kind
// (BE, CN, BDF for BDF2; the one kind otherwise).
template <int TS, bool SNAP>
__device__ __forceinline__ void bwd_row(
    Shared& sm, int h, int row, int Bh, int N, int ntiles, int rtile,
    const float* __restrict__ e0g, const float* __restrict__ e1g,
    const float* __restrict__ co0g, const float* __restrict__ co1g,
    const float* __restrict__ coh0g, const float* __restrict__ coh1g,
    const float* __restrict__ rc, const float* __restrict__ ret,
    const float* __restrict__ rht, float* __restrict__ ce0g,
    float* __restrict__ ce1g, float (&g)[3][kNGrad]) {
  constexpr int nph = TS == 3 ? 4 : 1;
  const int sub = blockDim.x * kCells;
  const int nsub = (rtile + sub - 1) / sub;  // <= kMaxSub; a record tile
  // longer than one sub-tile is a whole 4096-cell tile, split exactly
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  const size_t base = static_cast<size_t>(h * Bh + row) * N;
  const size_t rbase = (static_cast<size_t>(h) * nph * Bh + row) * ntiles;
  const size_t ebase = (static_cast<size_t>(h) * Bh + row) * ntiles;
  int buf = 0;
  int par = 0;  // sub-tile visits of pass 2 alternate the cet/cht buffers
  float scratch[kCells];  // unused outputs
  for (int t = ntiles - 1; t >= 0; --t) {
    const int t0 = t * rtile;
    // The e1 and hs1 edges upwind of sub-tile s: the records for s = 0;
    // e1 is an input, hs1 comes from the first pass.
    auto et_of = [&](int s0) {
      return s0 == t0 ? ret[ebase + t] : e1g[base + s0 - 1];
    };
    // Pass 1 (the previous tile's last reads of these slots precede the
    // first barrier).
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int p = 0; p < nph; ++p)
        sm.fcarry[p] = rc[rbase + static_cast<size_t>(p) * Bh * ntiles + t];
      sm.htail = TS == 3 ? rht[ebase + t] : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < nsub; ++s) {
      const int s0 = t0 + s * sub;
      if (s0 >= N) break;
      const int j0 = s0 + threadIdx.x * kCells;
      const int owner = tile_owner(s0, j0, sub, N, kCells);
      float x0[kCells], x1[kCells];
      load_cells(x0, e0g + base, j0, N);
      load_cells(x1, e1g + base, j0, N);
      const float et = threadIdx.x == 0 ? et_of(s0) : 0.f;
      Fwd<TS, SNAP> f;
      f.run(sm, buf, x0, x1, sm.fcarry, owner, &et, &sm.htail);
      if (threadIdx.x == 0) {
        for (int p = 0; p < nph; ++p) sm.sub_carry[s][p] = f.c_in[p];
        sm.sub_ht[s] = f.hs1_up;
      }
      if constexpr (TS == 3) {
        if (tail_thread) sm.htail = SNAP ? f.c1[kCells - 1] : f.b1[kCells - 1];
      }
    }
    // Pass 2.
    for (int s = nsub - 1; s >= 0; --s) {
      const int s0 = t0 + s * sub;
      if (s0 >= N) continue;
      const int j0 = s0 + threadIdx.x * kCells;
      float x0[kCells], x1[kCells], o0c[kCells], o1c[kCells];
      load_cells(x0, e0g + base, j0, N);
      load_cells(x1, e1g + base, j0, N);
      load_cells(o0c, co0g + base, j0, N);
      load_cells(o1c, co1g + base, j0, N);
      const float et = threadIdx.x == 0 ? et_of(s0) : 0.f;
      Fwd<TS, SNAP> f;
      f.run(sm, buf, x0, x1, sm.sub_carry[s], -1, &et, &sm.sub_ht[s]);
      float x0c[kCells], x1c[kCells], pshift[kCells];
#pragma unroll
      for (int c = 0; c < kCells; ++c) x0c[c] = x1c[c] = pshift[c] = 0.f;
      if constexpr (TS == 3) {
        const auto& hs0 = SNAP ? f.c0 : f.b0;
        const auto& hs1 = SNAP ? f.c1 : f.b1;
        float hs0c[kCells], hs1c[kCells], hshift[kCells];
        load_cells(hs0c, coh0g + base, j0, N);
        load_cells(hs1c, coh1g + base, j0, N);
#pragma unroll
        for (int c = 0; c < kCells; ++c) hshift[c] = 0.f;
        float dc0[kCells], dc1[kCells];
        phase_adj<kBDF>(sm.kc[2], f.d0, f.d1, x0, x1, hs0, hs1, f.x1_up,
                        f.hs1_up, f.cin[3], o0c, o1c, &sm.carry[3], j0, N, sm,
                        buf, dc0, dc1, x0c, x1c, hs0c, hs1c, pshift, hshift,
                        g[2]);
        float cc0[kCells], cc1[kCells];
        phase_adj<kBE>(sm.kc[0], f.c0, f.c1, x0, x1, hs0, hs1, 0.f, 0.f,
                       f.cin[2], dc0, dc1, &sm.carry[2], j0, N, sm, buf, cc0,
                       cc1, scratch, scratch, scratch, scratch, scratch,
                       scratch, g[0]);
        // hs1 feeds the BDF phase one cell downstream too.
        const float hnext =
            downwind_value(hshift[0], &sm.cht[par], sm.edge_dh);
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          hs1c[c] += c < kCells - 1 ? hshift[c + 1] : hnext;
        if (threadIdx.x == 0) sm.cht[par ^ 1] = hshift[0];
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
        phase_adj<kCN>(sm.kc[1], f.b0, f.b1, x0, x1, x0, x1, f.x1_up, 0.f,
                       f.cin[1], cc0, cc1, &sm.carry[1], j0, N, sm, buf, e0c,
                       e1c, scratch, scratch, scratch, scratch, pshift,
                       scratch, g[1]);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          bc0[c] += e0c[c];
          bc1[c] += e1c[c];
        }
        phase_adj<kBE>(sm.kc[0], x0, x1, x0, x1, x0, x1, 0.f, 0.f, f.cin[0],
                       bc0, bc1, &sm.carry[0], j0, N, sm, buf, e0c, e1c,
                       scratch, scratch, scratch, scratch, scratch, scratch,
                       g[0]);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          x0c[c] += e0c[c];
          x1c[c] += e1c[c];
        }
      } else {
        constexpr int KIND = TS == 1 ? kBE : kCN;
        float e0c[kCells], e1c[kCells];
        phase_adj<KIND>(sm.kc[KIND - 1], x0, x1, x0, x1, x0, x1, f.x1_up, 0.f,
                        f.cin[0], o0c, o1c, &sm.carry[0], j0, N, sm, buf, e0c,
                        e1c, scratch, scratch, scratch, scratch, pshift,
                        scratch, g[0]);
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
            downwind_value(pshift[0], &sm.cet[par], sm.edge_dp);
#pragma unroll
        for (int c = 0; c < kCells; ++c)
          x1c[c] += c < kCells - 1 ? pshift[c + 1] : pnext;
        if (threadIdx.x == 0) sm.cet[par ^ 1] = pshift[0];
      }
      par ^= 1;
      store_cells(ce0g + base, j0, N, x0c);
      store_cells(ce1g + base, j0, N, x1c);
    }
  }
}

// Sums column `col` of every thread's gradient sums over the block into
// sm.red (per warp); the caller reads sm.red after a barrier.
__device__ __forceinline__ void warp_sum_to(Shared& sm, int col, float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) sm.red[col][threadIdx.x >> 5] = v;
}

template <int TS>
__global__ void __launch_bounds__(kMaxThreads)
    bwd_kernel(const float* __restrict__ cbe, const float* __restrict__ ccn,
               const float* __restrict__ cbdf, const int* __restrict__ flip,
               float* rec, const float* __restrict__ e0g,
               const float* __restrict__ e1g,
               const float* __restrict__ co0g,
               const float* __restrict__ co1g,
               const float* __restrict__ coh0g,
               const float* __restrict__ coh1g,
               const float* __restrict__ rc, const float* __restrict__ ret,
               const float* __restrict__ rht, float* __restrict__ ce0g,
               float* __restrict__ ce1g, float* __restrict__ cbc,
               float* __restrict__ gbe, float* __restrict__ gcn,
               float* __restrict__ gbdf, int Bh, int N, int ntiles,
               int rtile, float s_be, float s_cn, float s_bdf, int symmetric,
               int reflective, int half0) {
  __shared__ Shared sm;
  constexpr int nph = TS == 3 ? 4 : 1;
  constexpr int nkinds = TS == 3 ? 3 : 1;
  const int row = blockIdx.x % Bh;
  const int h = half0 + blockIdx.x / Bh;
  const int hr = h * Bh + row;
  load_row_coefs(sm, cbe, ccn, cbdf, hr);
  // Lambdas entering the row's last tile: 0, or for the mu<0 half of a
  // reflective slab s_p * the flipped row's mu>0 inflow cotangent.
  if (threadIdx.x < nph) {
    const int p = threadIdx.x;
    sm.carry[p] = (h == 0 && reflective)
                      ? phase_s<TS>(p, s_be, s_cn, s_bdf) *
                            rec[flip[row] * nph + p]
                      : 0.f;
  }
  if (threadIdx.x < 2) sm.cet[threadIdx.x] = sm.cht[threadIdx.x] = 0.f;
  __syncthreads();
  float g[3][kNGrad];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kNGrad; ++i) g[k][i] = 0.f;
  if (TS == 3 && !(symmetric || h == 0))
    bwd_row<TS, false>(sm, h, row, Bh, N, ntiles, rtile, e0g, e1g, co0g,
                       co1g, coh0g, coh1g, rc, ret, rht, ce0g, ce1g, g);
  else
    bwd_row<TS, true>(sm, h, row, Bh, N, ntiles, rtile, e0g, e1g, co0g, co1g,
                      coh0g, coh1g, rc, ret, rht, ce0g, ce1g, g);

  // The row's start reached: thread 0 holds (wrote) every phase's inflow
  // cotangent. They fold into bc with each phase's s; for a reflective slab
  // bc feeds the mu<0 half only and the mu>0 ones go to the record.
  if (threadIdx.x == 0) {
    if (h == 1 && reflective) {
      for (int p = 0; p < nph; ++p) rec[row * nph + p] = sm.carry[p];
    } else {
      float acc = 0.f;
      for (int p = 0; p < nph; ++p)
        acc = acc + phase_s<TS>(p, s_be, s_cn, s_bdf) * sm.carry[p];
      cbc[hr] = acc;
    }
  }
  for (int k = 0; k < nkinds; ++k)
#pragma unroll
    for (int i = 0; i < kNGrad; ++i) warp_sum_to(sm, k * kNGrad + i, g[k][i]);
  __syncthreads();
  if (threadIdx.x < nkinds * kNGrad) {
    const int k = threadIdx.x / kNGrad, i = threadIdx.x % kNGrad;
    float v = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += sm.red[threadIdx.x][w];
    float* out = TS == 3 ? (k == 0 ? gbe : (k == 1 ? gcn : gbdf))
                         : (TS == 1 ? gbe : gcn);
    out += hr * kNCoef;
    // Columns [w, T0, q, idet, a, Sb, c1, c0, kee, kp]; Sb and c0 share S.
    out[i < 7 ? i : i + 1] = v;
    if (i == 5) out[7] = v;
  }
}

// B9's threads a row block (B1's), B10's (half of them rounded up to a
// warp: 256 sub-tiles of 1024 cells split a 4096-cell record tile exactly;
// a row of fewer cells is one record tile of at most 4 sub-tiles), and
// whether ntiles is B9's tile count for N.
inline int fwd_threads(int N) {
  return pick_threads(N, kFwdCells, kFwdThreads);
}
inline int bwd_threads(int N) { return 32 * ((fwd_threads(N) + 63) / 64); }
inline bool tiles_ok(int N, int ntiles) {
  const int tile = fwd_threads(N) * kFwdCells;
  return ntiles == (N + tile - 1) / tile;
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

int rt_adj_bwd(int ts_method, const float* cbe, const float* ccn,
               const float* cbdf, const int* flip, float* rec,
               const float* e0, const float* e1, const float* co0,
               const float* co1, const float* coh0, const float* coh1,
               const float* rc, const float* ret, const float* rht,
               float* ce0, float* ce1, float* cbc, float* gbe, float* gcn,
               float* gbdf, int Bh, int N, int ntiles, float s_be,
               float s_cn, float s_bdf, int symmetric, int reflective,
               void* stream) {
  if (Bh < 1 || N < 1 || ts_method < 1 || ts_method > 3 ||
      !tiles_ok(N, ntiles) || (ts_method == 3 && (!coh0 || !coh1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = bwd_threads(N);
  const int rtile = fwd_threads(N) * kFwdCells;
  auto launch = [&](int grid, int half0) {
    if (ts_method == 1)
      bwd_kernel<1><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, flip, rec, e0, e1, co0, co1, coh0, coh1, rc, ret,
          rht, ce0, ce1, cbc, gbe, gcn, gbdf, Bh, N, ntiles, rtile, s_be,
          s_cn, s_bdf, symmetric, reflective, half0);
    else if (ts_method == 2)
      bwd_kernel<2><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, flip, rec, e0, e1, co0, co1, coh0, coh1, rc, ret,
          rht, ce0, ce1, cbc, gbe, gcn, gbdf, Bh, N, ntiles, rtile, s_be,
          s_cn, s_bdf, symmetric, reflective, half0);
    else
      bwd_kernel<3><<<grid, threads, 0, st>>>(
          cbe, ccn, cbdf, flip, rec, e0, e1, co0, co1, coh0, coh1, rc, ret,
          rht, ce0, ce1, cbc, gbe, gcn, gbdf, Bh, N, ntiles, rtile, s_be,
          s_cn, s_bdf, symmetric, reflective, half0);
  };
  if (!reflective) {
    launch(2 * Bh, 0);
    return static_cast<int>(cudaGetLastError());
  }
  // Reversed half order: the mu>0 half records its inflow cotangents, which
  // the mu<0 half's outflow lambdas start from.
  launch(Bh, 1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch(Bh, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
