// Hand-written Hopper (sm_90a) kernel of the single-exchange mesh engine
// (parallel/fused_exchange_cuda.py).
//
// Replaces the Pallas TPU kernel factory of
// radiative_transfer_tpu/parallel/fused_exchange.py:
//   rt_fused_step <- _make_fused_step_kernel (B13: one whole BDF2 step a
//                    launch behind the previous step's linear correction)
//
// What is computed (fused_exchange.py:105-249). Per packed row (2*Bh_l rows,
// the mu<0 rows first) and per tile of the shard's cells, two four-phase
// BDF2 cycles (BE(dt/2), CN(dt/2), BE(dt/2), the BDF corrector):
// 1. the LINEAR correction cycle of the previous step: the cycle's response
//    to its seven boundary unknowns v = (4 phase inflows, the CN and BDF p1
//    fills, the h1 fill), with no sources (Sb = c0 = 0) and zero planes.
//    Its carries and its h1 fill start from v at the row's first cell; the
//    p1 fills are v's at the first cell and zero after it (the zero p1
//    plane's edge);
// 2. the true input ends e = z + that correction, and this step's
//    zero-boundary cycle on them (all carries and tails start at zero), the
//    half snapshot per row (the CN output for mu<0 rows, the phase-0 BE
//    output for mu>0, unless symmetric), and the row's (rows, 6) record
//    [4 phase carries leaving the row, the half snapshot's and the input
//    e1's last cell].
// With materialize_only only cycle 1 runs, and the kernel writes the
// corrected ends and the half-plane corrections.
//
// Design. One thread block a packed row walks the shard in tiles of
// blockDim*8 cells, 8 consecutive cells a thread (B1's tile, segments.cuh),
// every sub-step one substep_tile (tiles.cuh), so each cycle runs B1's
// arithmetic. The thirteen carry slots of the JAX kernel's scratch live in
// shared memory: four correction carries and its h1 fill, four step
// carries and the step's e1 and hs1 tails (the two p1 fills of cycle 1 are
// read from v by thread 0 at the first cell). CUDA blocks run in no order;
// the inter-tile carries are the in-order tile loop inside one block, as in
// B1-B5. bdf2_segment (segments.cuh) is not reused: it loads its input
// cells itself and stores prev planes B13 does not write.

#include <cuda_runtime.h>

#include "segments.cuh"

namespace {

constexpr int kCells = kSegCells;
constexpr int kNV = 7;    // unknowns v of a row (parallel/step_response.py)
constexpr int kNRec = 6;  // the row's record
// v's components: four phase inflows, the CN and BDF p1 fills, the h1 fill.
constexpr int kVP1CN = 4, kVP1BDF = 5, kVFillH = 6;

struct FusedShared {
  float ccarry[4];   // the correction cycle's carry per phase
  float cfill_h;     // its h1 fill: v's, then the previous tile's hs1 edge
  float carry[4];    // this step's carry per phase
  float etail;       // the previous tile's input-e1 edge
  float htail;       // the previous tile's half-snapshot h1 edge
  float scanA[2][32];
  float scanB[2][32];
  float edge_p[32];
  float edge_h[32];
};

__device__ __forceinline__ Coef linear(Coef k) {
  k.Sb = 0.f;
  k.c0 = 0.f;
  return k;
}

// B13, replaces _make_fused_step_kernel (fused_exchange.py:149).
template <bool MATERIALIZE_ONLY>
__global__ void __launch_bounds__(kSegThreads)
    fused_step_kernel(const float* __restrict__ cbe,
                      const float* __restrict__ ccn,
                      const float* __restrict__ cbdf,
                      const float* __restrict__ v,
                      const float* __restrict__ z0g,
                      const float* __restrict__ z1g, float* __restrict__ o0g,
                      float* __restrict__ o1g, float* __restrict__ oh0g,
                      float* __restrict__ oh1g, float* __restrict__ rec,
                      int rows, int N, int symmetric) {
  __shared__ FusedShared sm;
  const int row = blockIdx.x;
  const Coef kbe = load_coef(cbe + row * kNCoef);
  const Coef kcn = load_coef(ccn + row * kNCoef);
  const Coef kbdf = load_coef(cbdf + row * kNCoef);
  const Coef lbe = linear(kbe), lcn = linear(kcn), lbdf = linear(kbdf);
  const float* vr = v + row * kNV;
  const bool snap_cn = symmetric || row < rows / 2;
  if (threadIdx.x == 0) {
    for (int p = 0; p < 4; ++p) {
      sm.ccarry[p] = vr[p];
      sm.carry[p] = 0.f;
    }
    sm.cfill_h = vr[kVFillH];
    sm.etail = 0.f;
    sm.htail = 0.f;
  }
  __syncthreads();
  const float p1cn0 = threadIdx.x == 0 ? vr[kVP1CN] : 0.f;
  const float p1bdf0 = threadIdx.x == 0 ? vr[kVP1BDF] : 0.f;

  const size_t base = static_cast<size_t>(row) * N;
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  const int tile = blockDim.x * kCells;
  const float Z[kCells] = {};
  int buf = 0;
  for (int t0 = 0; t0 < N; t0 += tile) {
    const int j0 = t0 + threadIdx.x * kCells;
    const int owner = tile_owner(t0, j0, tile, N, kCells);
    // -- 1. the previous step's linear correction cycle --------------------
    // The p1 fills: v's upwind of the row's first cell, else the zero p1
    // plane's values.
    const float p1cn_up = t0 == 0 ? p1cn0 : 0.f;
    const float p1bdf_up = t0 == 0 ? p1bdf0 : 0.f;
    float b0[kCells], b1[kCells], c0[kCells], c1[kCells];
    float hs0[kCells], hs1[kCells], d0[kCells], d1[kCells];
    float f0[kCells], f1[kCells];
    substep_tile<kBE>(lbe, Z, Z, Z, Z, Z, Z, 0.f, 0.f, &sm.ccarry[0], owner,
                      sm, buf, b0, b1);
    substep_tile<kCN>(lcn, b0, b1, Z, Z, Z, Z, p1cn_up, 0.f, &sm.ccarry[1],
                      owner, sm, buf, c0, c1);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      hs0[c] = snap_cn ? c0[c] : b0[c];
      hs1[c] = snap_cn ? c1[c] : b1[c];
    }
    const float hc1_up = upwind_value(hs1[kCells - 1], &sm.cfill_h,
                                      sm.edge_h);
    substep_tile<kBE>(lbe, c0, c1, Z, Z, Z, Z, 0.f, 0.f, &sm.ccarry[2],
                      owner, sm, buf, d0, d1);
    substep_tile<kBDF>(lbdf, d0, d1, Z, Z, hs0, hs1, p1bdf_up, hc1_up,
                       &sm.ccarry[3], owner, sm, buf, f0, f1);
    if (tail_thread) sm.cfill_h = hs1[kCells - 1];
    float x0[kCells], x1[kCells];
    load_cells(x0, z0g + base, j0, N);
    load_cells(x1, z1g + base, j0, N);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      x0[c] += f0[c];
      x1[c] += f1[c];
    }
    if constexpr (MATERIALIZE_ONLY) {
      store_cells(o0g + base, j0, N, x0);
      store_cells(o1g + base, j0, N, x1);
      store_cells(oh0g + base, j0, N, hs0);
      store_cells(oh1g + base, j0, N, hs1);
      continue;
    }
    // -- 2. this step's zero-boundary cycle on the true input ends ---------
    const float x1_up = upwind_value(x1[kCells - 1], &sm.etail, sm.edge_p);
    substep_tile<kBE>(kbe, x0, x1, x0, x1, x0, x1, 0.f, 0.f, &sm.carry[0],
                      owner, sm, buf, b0, b1);
    substep_tile<kCN>(kcn, b0, b1, x0, x1, x0, x1, x1_up, 0.f, &sm.carry[1],
                      owner, sm, buf, c0, c1);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      hs0[c] = snap_cn ? c0[c] : b0[c];
      hs1[c] = snap_cn ? c1[c] : b1[c];
    }
    const float hs1_up = upwind_value(hs1[kCells - 1], &sm.htail, sm.edge_h);
    substep_tile<kBE>(kbe, c0, c1, x0, x1, hs0, hs1, 0.f, 0.f, &sm.carry[2],
                      owner, sm, buf, d0, d1);
    substep_tile<kBDF>(kbdf, d0, d1, x0, x1, hs0, hs1, x1_up, hs1_up,
                       &sm.carry[3], owner, sm, buf, f0, f1);
    if (tail_thread) {
      sm.etail = x1[kCells - 1];
      sm.htail = hs1[kCells - 1];
    }
    if (owner >= 0 && t0 + tile >= N) {
      // The row's last cell: its half-snapshot and input-e1 edges.
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        if (c == owner) {
          rec[row * kNRec + 4] = hs1[c];
          rec[row * kNRec + 5] = x1[c];
        }
      }
    }
    store_cells(o0g + base, j0, N, f0);
    store_cells(o1g + base, j0, N, f1);
    store_cells(oh0g + base, j0, N, hs0);
    store_cells(oh1g + base, j0, N, hs1);
  }
  if constexpr (!MATERIALIZE_ONLY) {
    // The carries leaving the row's last cell, written by its owner after
    // the last scan.
    __syncthreads();
    if (threadIdx.x < 4) rec[row * kNRec + threadIdx.x] = sm.carry[threadIdx.x];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// Packed (rows, N) float32 planes, mu<0 rows first: coefficients (rows, 10)
// per kind, v (rows, 7), the previous step's zero-boundary ends z0, z1.
// Writes this step's zero-boundary ends (o0, o1), half snapshot (oh0, oh1)
// and record (rows, 6); with materialize_only the corrected ends (o0, o1)
// and half-plane corrections (oh0, oh1), and rec is not written.
int rt_fused_step(const float* cbe, const float* ccn, const float* cbdf,
                  const float* v, const float* z0, const float* z1, float* o0,
                  float* o1, float* oh0, float* oh1, float* rec, int rows,
                  int N, int symmetric, int materialize_only, void* stream) {
  if (rows < 2 || rows % 2 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = pick_threads(N, kCells, kSegThreads);
  if (materialize_only)
    fused_step_kernel<true><<<rows, threads, 0, st>>>(
        cbe, ccn, cbdf, v, z0, z1, o0, o1, oh0, oh1, rec, rows, N, symmetric);
  else
    fused_step_kernel<false><<<rows, threads, 0, st>>>(
        cbe, ccn, cbdf, v, z0, z1, o0, o1, oh0, oh1, rec, rows, N, symmetric);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
