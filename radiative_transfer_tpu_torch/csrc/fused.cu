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
// Design: a multi-slot look-back scan (lookback.cuh), one thread block a
// tile of blockDim*8 cells of a packed row, 8 consecutive cells a thread
// (B1's cell layout), every sub-step one lb_substep (B1's arithmetic:
// substep_rhs and substep_out of tiles.cuh). The eight scan slots are the
// correction cycle's BE, CN, BE and BDF, then this step's BE, CN, BE and
// BDF (materialize_only: the first four). Tile 0 starts the correction
// slots from v's four phase inflows and this step's slots from zero. The
// one-cell edges a tile's shifts read from its predecessor travel in edge
// words, each the predecessor's output of an earlier slot:
// * the correction cycle's hs1 at t0 - 1 (its BDF phase's h1 fill; v's fill
//   at the row's first cell), after the correction's CN slot;
// * the corrected input e1 = z1 + the correction's f1 at t0 - 1 (this
//   step's CN and BDF p1 shifts; zero at the row's first cell), after the
//   correction's BDF slot;
// * this step's hs1 at t0 - 1 (its BDF phase's h1 fill; zero at the row's
//   first cell), after this step's CN slot.
// The correction cycle's p1 fills are v's at the row's first cell and zero
// after it (the zero p1 plane's values). The owner of the row's last cell
// writes the (rows, 6) record: the carries leaving the row in slots 4-7
// and the half snapshot's and e1's last cell.
//
// What bounds it on this card: bytes. A step reads 2 planes and writes 4
// (about 2 BDF2 cycles of f32 arithmetic a cell against 24 bytes); the
// look-back adds 8 words a tile and 3 edge words. The row walk it replaced
// ran one block a row (32 SMs at the gray rung's shard), 8 scans a tile in
// order.

#include <cuda_runtime.h>

#include "lookback.cuh"
#include "segments.cuh"

namespace {

constexpr int kCells = kSegCells;
constexpr int kNV = 7;    // unknowns v of a row (parallel/step_response.py)
constexpr int kNRec = 6;  // the row's record
constexpr int kNEdge = 3; // edge words a tile: correction hs1, e1, hs1
// At most this many threads a block, with kMinBlocks blocks resident a
// multiprocessor (at most 64 registers a thread, a few spilled: the slots'
// latency, not the registers, binds, so more blocks in flight pay).
constexpr int kMaxThreads = 128, kMinBlocks = 8;
// v's components: four phase inflows, the CN and BDF p1 fills, the h1 fill.
constexpr int kVP1CN = 4, kVP1BDF = 5, kVFillH = 6;

__device__ __forceinline__ Coef linear(Coef k) {
  k.Sb = 0.f;
  k.c0 = 0.f;
  return k;
}

// B13, replaces _make_fused_step_kernel (fused_exchange.py:149): one block
// a (row, tile), from its ticket. `status` holds the slots' words (slots,
// rows, T), the edge words (3, rows, T) and the tile counter, all zeroed.
template <bool MATERIALIZE_ONLY>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    fused_step_kernel(const float* __restrict__ cbe,
                      const float* __restrict__ ccn,
                      const float* __restrict__ cbdf,
                      const float* __restrict__ v,
                      const float* __restrict__ z0g,
                      const float* __restrict__ z1g, float* __restrict__ o0g,
                      float* __restrict__ o1g, float* __restrict__ oh0g,
                      float* __restrict__ oh1g, float* __restrict__ rec,
                      int rows, int N, int T, int symmetric,
                      unsigned long long* status) {
  __shared__ LookbackShared sm;
  __shared__ Coef kc[6];  // BE, CN, BDF, then their linear versions
  constexpr int nslots = MATERIALIZE_ONLY ? 4 : 8;
  const size_t words = static_cast<size_t>(rows) * T;
  lb_ticket(sm, status + (nslots + kNEdge) * words);
  __syncthreads();
  // Tickets run tile-major across the rows: tile t - 1 of a row takes a
  // smaller ticket than tile t.
  const int t = sm.ticket / rows;
  const int row = sm.ticket - t * rows;
  if (threadIdx.x == 0) {
    kc[0] = load_coef(cbe + row * kNCoef);
    kc[1] = load_coef(ccn + row * kNCoef);
    kc[2] = load_coef(cbdf + row * kNCoef);
    for (int i = 0; i < 3; ++i) kc[3 + i] = linear(kc[i]);
  }
  __syncthreads();
  const float* vr = v + row * kNV;
  const bool snap_cn = symmetric || row < rows / 2;
  const int tile = blockDim.x * kCells;
  const int t0 = t * tile;
  const int j0 = t0 + threadIdx.x * kCells;
  const int owner = tile_owner(t0, j0, tile, N, kCells);
  const size_t base = static_cast<size_t>(row) * N;
  const bool lead = threadIdx.x == 0;
  const bool sender = threadIdx.x == blockDim.x - 1 && t + 1 < T;
  auto slot = [&](int s) { return status + s * words + row * T; };
  unsigned long long* edges = status + nslots * words + row * T;
  unsigned long long* e_cfill = edges;
  unsigned long long* e_etail = edges + words;
  unsigned long long* e_htail = edges + 2 * words;
  auto from_v = [&](int q) { return [=] { return vr[q]; }; };
  auto zero = [] { return 0.f; };
  const float Z[kCells] = {};
  float c_out[4];  // the owner's carries leaving the tile in slots 4-7
  int buf = 0;
  // -- 1. the previous step's linear correction cycle ----------------------
  // The p1 fills: v's upwind of the row's first cell, else the zero p1
  // plane's values.
  const float p1cn_up = (lead && t == 0) ? vr[kVP1CN] : 0.f;
  const float p1bdf_up = (lead && t == 0) ? vr[kVP1BDF] : 0.f;
  float b0[kCells], b1[kCells], c0[kCells], c1[kCells];
  float hs0[kCells], hs1[kCells], d0[kCells], d1[kCells];
  float f0[kCells], f1[kCells];
  lb_substep<kBE>(kc[3], Z, Z, Z, Z, Z, Z, 0.f, 0.f, t, T, owner, slot(0),
                  from_v(0), sm, buf, b0, b1, c_out[0]);
  lb_substep<kCN>(kc[4], b0, b1, Z, Z, Z, Z, p1cn_up, 0.f, t, T, owner,
                  slot(1), from_v(1), sm, buf, c0, c1, c_out[0]);
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    hs0[c] = snap_cn ? c0[c] : b0[c];
    hs1[c] = snap_cn ? c1[c] : b1[c];
  }
  if (sender) lb_publish_edge(e_cfill + t, hs1[kCells - 1]);
  lb_substep<kBE>(kc[3], c0, c1, Z, Z, Z, Z, 0.f, 0.f, t, T, owner, slot(2),
                  from_v(2), sm, buf, d0, d1, c_out[0]);
  if (lead) sm.htail = t ? lb_wait_edge(e_cfill + t - 1) : vr[kVFillH];
  const float hc1_up = upwind_value(hs1[kCells - 1], &sm.htail, sm.edge_h);
  lb_substep<kBDF>(kc[5], d0, d1, Z, Z, hs0, hs1, p1bdf_up, hc1_up, t, T,
                   owner, slot(3), from_v(3), sm, buf, f0, f1, c_out[0]);
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
    return;
  }
  if (sender) lb_publish_edge(e_etail + t, x1[kCells - 1]);
  // -- 2. this step's zero-boundary cycle on the true input ends -----------
  lb_substep<kBE>(kc[0], x0, x1, x0, x1, x0, x1, 0.f, 0.f, t, T, owner,
                  slot(4), zero, sm, buf, b0, b1, c_out[0]);
  // The e1 edge, which the BE slot does not read, waited on after it.
  if (lead) sm.ptail = t ? lb_wait_edge(e_etail + t - 1) : 0.f;
  const float x1_up = upwind_value(x1[kCells - 1], &sm.ptail, sm.edge_p);
  lb_substep<kCN>(kc[1], b0, b1, x0, x1, x0, x1, x1_up, 0.f, t, T, owner,
                  slot(5), zero, sm, buf, c0, c1, c_out[1]);
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    hs0[c] = snap_cn ? c0[c] : b0[c];
    hs1[c] = snap_cn ? c1[c] : b1[c];
  }
  if (sender) lb_publish_edge(e_htail + t, hs1[kCells - 1]);
  lb_substep<kBE>(kc[0], c0, c1, x0, x1, hs0, hs1, 0.f, 0.f, t, T, owner,
                  slot(6), zero, sm, buf, d0, d1, c_out[2]);
  if (lead) sm.htail = t ? lb_wait_edge(e_htail + t - 1) : 0.f;
  const float hs1_up = upwind_value(hs1[kCells - 1], &sm.htail, sm.edge_h);
  lb_substep<kBDF>(kc[2], d0, d1, x0, x1, hs0, hs1, x1_up, hs1_up, t, T,
                   owner, slot(7), zero, sm, buf, f0, f1, c_out[3]);
  if (t + 1 == T && owner >= 0) {
    // The row's record, by the owner of its last cell: the carries leaving
    // it, its half-snapshot and input-e1 edges.
    float* r = rec + row * kNRec;
#pragma unroll
    for (int p = 0; p < 4; ++p) r[p] = c_out[p];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (c == owner) {
        r[4] = hs1[c];
        r[5] = x1[c];
      }
    }
  }
  store_cells(o0g + base, j0, N, f0);
  store_cells(o1g + base, j0, N, f1);
  store_cells(oh0g + base, j0, N, hs0);
  store_cells(oh1g + base, j0, N, hs1);
}

}  // namespace

extern "C" {

// B13's launch shape for rows of N cells at most max_threads threads a
// block (a power of two from 32 to kMaxThreads): out = (threads a block, tiles a
// row, blocks of the step kernel a multiprocessor holds at once); the
// scratch the wrapper passes holds (slots + 3) * rows * tiles + 1 words,
// slots = 8 (4 with materialize_only).
int rt_fused_geometry(int N, int max_threads, int* out) {
  if (!lb_shape_ok(N, max_threads, kMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  lb_geometry(N, kCells, max_threads, out);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 2, fused_step_kernel<false>, out[0], 0));
}

// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// Packed (rows, N) float32 planes, mu<0 rows first: coefficients (rows, 10)
// per kind, v (rows, 7), the previous step's zero-boundary ends z0, z1.
// Writes this step's zero-boundary ends (o0, o1), half snapshot (oh0, oh1)
// and record (rows, 6); with materialize_only the corrected ends (o0, o1)
// and half-plane corrections (oh0, oh1), and rec is not written. status:
// the look-back scratch of rt_fused_geometry's size at the same
// max_threads, zeroed here before the launch.
int rt_fused_step(const float* cbe, const float* ccn, const float* cbdf,
                  const float* v, const float* z0, const float* z1, float* o0,
                  float* o1, float* oh0, float* oh1, float* rec,
                  unsigned long long* status, int rows, int N, int symmetric,
                  int materialize_only, int max_threads, void* stream) {
  int geo[2];
  if (rows < 2 || rows % 2 || !lb_shape_ok(N, max_threads, kMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  lb_geometry(N, kCells, max_threads, geo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = geo[0], T = geo[1];
  const size_t words =
      static_cast<size_t>((materialize_only ? 4 : 8) + kNEdge) * rows * T;
  const cudaError_t err =
      cudaMemsetAsync(status, 0, (words + 1) * sizeof(*status), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = rows * T;
  if (materialize_only)
    fused_step_kernel<true><<<grid, threads, 0, st>>>(
        cbe, ccn, cbdf, v, z0, z1, o0, o1, oh0, oh1, rec, rows, N, T,
        symmetric, status);
  else
    fused_step_kernel<false><<<grid, threads, 0, st>>>(
        cbe, ccn, cbdf, v, z0, z1, o0, o1, oh0, oh1, rec, rows, N, T,
        symmetric, status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
