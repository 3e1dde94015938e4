// Hand-written Hopper (sm_90a) kernels for the flat S_N transport sweep.
//
// Replaces the Pallas TPU kernel factories of
// radiative_transfer_tpu/ops/pallas_sweep.py:
//   rt_sweep_bdf2      <- _make_bdf2_kernel      (K whole BDF2 steps a launch)
//   rt_sweep_multistep <- _make_multistep_kernel (K whole BE or CN steps)
//   rt_sweep_substep   <- _make_kernel           (one BE, CN or BDF sub-step)
//   rt_sweep_halo_bdf2 <- _make_halo_bdf2_kernel (seeded K-step BDF2, packed
//                                                 rows, for the halo engine)
//   rt_sweep_halo_multistep <- _make_halo_multistep_kernel (seeded K-step
//                                                 BE or CN, packed rows)
// All run on one __device__ sub-step routine, substep_tile (the counterpart
// of _substep_block, in tiles.cuh, which the adjoint kernels of adjoint.cu
// share), and one block-wide scan of affine maps (the counterpart of
// _hillis_steele, in tiles.cuh, which the double-float kernels of
// df_sweep.cu share too). B1 and B2 walk each row as a cluster wavefront
// (cluster.cuh, which df_sweep.cu's B6 and B14 share; B1's walk is
// wave.cuh bdf2_wave, which the K-fused adjoint forward B11 of adjoint.cu
// runs too); B4 and B5 keep the one-block tile loops (bdf2_segment, in
// segments.cuh, and multistep_segment); B3 runs substep_segment (in
// segments.cuh), which the mesh engine's B8 (sharded.cu) runs too.
//
// What is computed. Per row (direction half h, batch r) of the (2, Bh, N)
// planes and per sub-step: the right-hand sides r0, r1 of every cell, the
// recurrence carry_j = a*carry_{j-1} + b_j along the N cells in sweep order
// (a constant per row), then the 2x2 reconstruction of both cell edges.
//
// Design.
// * The Pallas grid (half, block) runs in order on the TPU, so the carries,
//   the upwind tails and the reflective coupling live in VMEM scratch across
//   grid steps. CUDA blocks run in no order. Every kernel here cuts a row of
//   N cells into tiles of blockDim*kCells cells (kCells = 8 a thread, at most
//   512 threads) and runs all K steps (times 4 phases for BDF2) of a tile
//   before it leaves the tile: step k at tile t needs only step k at tile
//   t-1 (its carry and upwind tails) and step k-1 at tile t (in registers).
//   K is a runtime argument. Each (step, phase) is a slot, 4K of them for
//   BDF2 and K for BE or CN.
// * B1 and B2 run a row's tiles as a wavefront over (tile, slot) on a
//   thread block cluster of C blocks (bdf2_kernel, multistep_kernel): slot
//   s of tile t needs only slot s of tile t-1 and slot s-1 of tile t, so
//   block rank r of the row's cluster runs tiles r, r + C, ..., and tile t
//   runs slot s while tile t+1 runs slot s-1. Per slot the mail to the next
//   tile's block is the carry leaving the tile, plus the tail the slot
//   carries: B1 hands step k's upwind p1 edge on with slot 4k and its h1
//   edge with slot 4k+1, B2-CN step k's p1 edge with slot k, B2-BE nothing
//   more. The mail goes into the next block's mailbox in distributed shared
//   memory, one mbarrier a slot (cluster.cuh: the protocol and why it needs
//   no "free" signal). Only the row's last tile may be ragged, and it sends
//   nothing; the block that runs it writes the reflective outflow record.
//   C = min(16, slots, tiles), shrunk until every row's cluster of the
//   launch is resident on the card (rt_sweep_geometry). The tiles, slots
//   and arithmetic are those of the one-block walk, so the planes are the
//   same to the bit.
// * B3, B4 and B5 keep the one-block walk: ONE thread block owns ONE row and
//   loops over its tiles (bdf2_segment in segments.cuh; multistep_segment;
//   substep_segment), the carries and tails of every slot in shared memory.
// * Each thread holds kCells consecutive cells in registers. A tile's scan is
//   a serial scan over the thread's cells, a warp-shuffle scan of the
//   per-thread affine maps (a^kCells, local total), one cross-warp pass in
//   shared memory, and a serial fix-up of the thread's cells.
// * Reflective left boundary: the mu>0 inflow of row i is s_p times the mu<0
//   outflow of row flip[i] for the same (step, phase). The mu<0 half is
//   launched first and writes a (Bh, slots) outflow record; the mu>0 half is
//   launched second and reads it through `flip` (a gather: the TPU kernel's
//   permutation matmul exists only because Mosaic has no reverse). With a
//   source boundary the halves are independent and share one launch.
// * The scan is not truncated. The JAX kernels cut the in-block Hillis-Steele
//   scan to _scan_npass passes, whose neglected upwind tail is bounded by
//   scan_tol (1e-10 relative, pallas_sweep.py:97-117), far below f32
//   roundoff; this kernel runs the exact recurrence over its own tiles.
// * Cells past N in the last (ragged) tile load as 0 and are never stored.
//   They lie downstream of every real cell, so they cannot change one; the
//   row's outflow is taken at cell N-1.
// * The halo kernels (B4, B5) take both direction halves as 2*Bh packed
//   rows in one launch, with no reflective coupling inside (the engine runs
//   a fixup launch for that, parallel/halo_cuda.py). Each row is two
//   chains: cells [0, reset_cell) from zero carries, then
//   [reset_cell, X) from the per-(row, slot) `seeds` values with zero
//   upwind tails, each segment tiled from its own start (reset_cell is a
//   multiple of the JAX block, not of this kernel's tile). Every row
//   records its carries after the last cell. Because this kernel scans
//   exactly, a seed's influence does not stop at the creep bound the JAX
//   engine's truncated scan enforces: it decays as a^distance, so the
//   engine's splice of the fixup launch over the first H cells leaves an
//   error of order a^H beyond H (a < 1 the carry multiplier), not zero.
//
// What bounds it on this card: latency, not bytes. A tile-phase costs three
// block barriers and ten shuffle rounds (~1.8 us on an H100 at 512 threads),
// and device-memory traffic is small beside it: 2 planes read and 6 written
// per K-step BDF2 launch (4 for BE/CN), as on the TPU. In the one-block walk
// a row's T tiles x slots tile-phases run one after another on one SM, and
// only 2*Bh blocks exist (Bh at a time for a reflective boundary): 16 busy
// SMs of 132 at the gray S_32 bench shape, which made B1's launch 42x its
// byte bound. The wavefront puts C blocks on each row: a row's critical
// path becomes ~T handoffs (a tile-phase plus the mail's latency each) plus
// the last tile's slots, and the T x slots tile-phases spread over C SMs,
// so a launch is bound by the larger of T*slots/C tile-phases and the
// handoff chain. On an H100 at the bench shape (T = 256, C = 6) B1 takes
// 3.6 ms at K = 4, ~7 us a tile on the chain and 11x its byte bound; at
// K = 8 the tile-phases bind at ~1.8 us each (PERF.md). The mu>0 half of a
// reflective slab still waits for the whole mu<0 half. The halo kernels run all 2*Bh rows at once (8 SMs at
// gray S_8, against the plain kernels' 4 at a time there).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "segments.cuh"
#include "wave.cuh"

namespace {

// B1's tile (segments.cuh), which every kernel of this file shares.
constexpr int kCells = kSegCells;
constexpr int kMaxThreads = kSegThreads;
using Shared = SegShared;

// Starts a new chain: every slot's carry from seeds[slot] (0 where seeds is
// null), zero upwind tails. The first barrier orders this after every read
// and write of the previous chain's carries and tails.
__device__ __forceinline__ void seed_row(Shared& sm, int slots, int steps,
                                         const float* __restrict__ seeds) {
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += blockDim.x)
    sm.carry[i] = seeds ? seeds[i] : 0.f;
  for (int i = threadIdx.x; i < steps; i += blockDim.x) {
    sm.etail[i] = 0.f;
    sm.htail[i] = 0.f;
  }
  __syncthreads();
}

// K whole BE or CN steps over the cells [s0, s1) of one row, as
// bdf2_segment; prev = each step's input.
template <int KIND>
__device__ __forceinline__ void multistep_segment(
    const Coef& kc, const float* __restrict__ e0g,
    const float* __restrict__ e1g, float* __restrict__ o0g,
    float* __restrict__ o1g, float* __restrict__ op0g,
    float* __restrict__ op1g, int s0, int s1, int K, Shared& sm, int& buf) {
  const bool tail_thread = threadIdx.x == blockDim.x - 1;
  const int tile = blockDim.x * kCells;
  for (int t0 = s0; t0 < s1; t0 += tile) {
    const int j0 = t0 + threadIdx.x * kCells;
    const int owner = tile_owner(t0, j0, tile, s1, kCells);
    float x0[kCells], x1[kCells];
    load_cells(x0, e0g, j0, s1);
    load_cells(x1, e1g, j0, s1);
    for (int k = 0; k < K; ++k) {
      float x1_up = 0.f;
      if constexpr (KIND == kCN)
        x1_up = upwind_value(x1[kCells - 1], &sm.etail[k], sm.edge_p);
      float f0[kCells], f1[kCells];
      substep_tile<KIND>(kc, x0, x1, x0, x1, x0, x1, x1_up, 0.f,
                         sm.carry + k, owner, sm, buf, f0, f1);
      if (tail_thread) sm.etail[k] = x1[kCells - 1];
      if (k == K - 1) {
        store_cells(op0g, j0, s1, x0);
        store_cells(op1g, j0, s1, x1);
      }
      copy_cells(x0, f0);
      copy_cells(x1, f1);
    }
    store_cells(o0g, j0, s1, x0);
    store_cells(o1g, j0, s1, x1);
  }
}

// -- B1's and B2's wavefront: a row's tiles across a thread block cluster ---
//
// Per slot the mail is the carry leaving the tile and, where the slot
// carries one, a tail: B1's slot 4k step k's upwind p1 edge (etail[k]), its
// slot 4k+1 step k's h1 edge (htail[k]); B2-CN's slot k step k's p1 edge.
// B2-BE's mail is the carry alone (wave.cuh: take, give).

// B1, replaces _make_bdf2_kernel (pallas_sweep.py:444): K whole BDF2 steps,
// each BE(dt/2), CN(dt/2), BE(dt/2) and the BDF corrector, as a wavefront
// over (tile, slot) (wave.cuh bdf2_wave, which B11 runs with its records):
// the cluster of C blocks at blockIdx.x / C owns one row, block rank r its
// tiles r, r + C, ... The tiles, slots and arithmetic are bdf2_segment's
// (which B4 keeps); only who runs a tile and how a slot's state reaches the
// next tile differ, so the planes are bdf2_segment's to the bit.
__global__ void __launch_bounds__(kMaxThreads)
    bdf2_kernel(const float* __restrict__ cbe, const float* __restrict__ ccn,
                const float* __restrict__ cbdf, const float* __restrict__ bc,
                const int* __restrict__ flip, float* rec,
                const float* __restrict__ e0g, const float* __restrict__ e1g,
                float* __restrict__ o0g, float* __restrict__ o1g,
                float* __restrict__ oh0g, float* __restrict__ oh1g,
                float* __restrict__ op0g, float* __restrict__ op1g, int Bh,
                int N, int K, float s_be, float s_cn, float s_bdf,
                int symmetric, int reflective, int half0) {
  __shared__ Shared sm;
  __shared__ WaveMail mb;
  const WaveRow w = wave_row(Bh, half0);
  const float s_of[4] = {s_be, s_cn, s_be, s_bdf};
  const int slots = 4 * K;
  open_mailboxes(mb, slots);
  // Tails on every block; the slots' inflow serves tile 0 only.
  init_row(sm, slots, K, s_of, 4, bc, flip, rec, w.h, w.row, w.hr,
           reflective);
  const size_t base = static_cast<size_t>(w.hr) * N;
  // The half snapshot is the CN output for mu<0 and the phase-0 BE output
  // for mu>0 (reference quirk, solver.cpp:733 vs 784-787) unless symmetric;
  // the mu<0 half of a reflective slab records its outflow carries.
  bdf2_wave(load_coef(cbe + w.hr * kNCoef), load_coef(ccn + w.hr * kNCoef),
            load_coef(cbdf + w.hr * kNCoef), symmetric || w.h == 0,
            e0g + base, e1g + base, o0g + base, o1g + base, oh0g + base,
            oh1g + base, op0g + base, op1g + base, N, K, sm, mb, w.C, w.rank,
            w.h == 0 && reflective ? rec + w.row * slots : nullptr);
  close_mailboxes();
}

// B4, replaces _make_halo_bdf2_kernel (pallas_sweep.py:638): K whole seeded
// BDF2 steps over packed rows (mu<0 rows first), one thread block a row.
__global__ void __launch_bounds__(kMaxThreads)
    halo_bdf2_kernel(const float* __restrict__ cbe,
                     const float* __restrict__ ccn,
                     const float* __restrict__ cbdf,
                     const float* __restrict__ seeds, float* rec,
                     const float* __restrict__ e0g,
                     const float* __restrict__ e1g, float* __restrict__ o0g,
                     float* __restrict__ o1g, float* __restrict__ oh0g,
                     float* __restrict__ oh1g, float* __restrict__ op0g,
                     float* __restrict__ op1g, int rows, int X, int K,
                     int reset_cell, int symmetric) {
  __shared__ Shared sm;
  const int row = blockIdx.x;
  const int slots = 4 * K;
  const Coef kbe = load_coef(cbe + row * kNCoef);
  const Coef kcn = load_coef(ccn + row * kNCoef);
  const Coef kbdf = load_coef(cbdf + row * kNCoef);
  // The per-row blend of the half snapshot: both halves share the launch.
  const bool snap_cn = symmetric || row < rows / 2;
  const size_t base = static_cast<size_t>(row) * X;
  int buf = 0;
  seed_row(sm, slots, K, nullptr);
  bdf2_segment(kbe, kcn, kbdf, snap_cn, e0g + base, e1g + base, o0g + base,
               o1g + base, oh0g + base, oh1g + base, op0g + base, op1g + base,
               0, reset_cell, K, sm, buf);
  seed_row(sm, slots, K, seeds + static_cast<size_t>(row) * slots);
  bdf2_segment(kbe, kcn, kbdf, snap_cn, e0g + base, e1g + base, o0g + base,
               o1g + base, oh0g + base, oh1g + base, op0g + base, op1g + base,
               reset_cell, X, K, sm, buf);
  write_record(sm, slots, rec + static_cast<size_t>(row) * slots);
}

// B2, replaces _make_multistep_kernel (pallas_sweep.py:387): K whole BE or
// CN steps, prev = each step's input, as a wavefront over (tile, slot) as in
// bdf2_kernel, one slot a step; the tiles, slots and arithmetic are
// multistep_segment's (which B5 keeps).
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    multistep_kernel(const float* __restrict__ coef,
                     const float* __restrict__ bc,
                     const int* __restrict__ flip, float* rec,
                     const float* __restrict__ e0g,
                     const float* __restrict__ e1g, float* __restrict__ o0g,
                     float* __restrict__ o1g, float* __restrict__ op0g,
                     float* __restrict__ op1g, int Bh, int N, int K, float s,
                     int reflective, int half0) {
  constexpr bool kTail = KIND == kCN;
  __shared__ Shared sm;
  __shared__ Mailbox<kTail ? 2 : 1, kMaxSteps> mb;
  const WaveRow w = wave_row(Bh, half0);
  const int C = w.C, rank = w.rank;
  const float s_of[1] = {s};
  open_mailboxes(mb, K);
  init_row(sm, K, K, s_of, 1, bc, flip, rec, w.h, w.row, w.hr, reflective);
  const Coef kc = load_coef(coef + w.hr * kNCoef);
  const size_t base = static_cast<size_t>(w.hr) * N;
  const int tile = blockDim.x * kCells;
  const int T = (N + tile - 1) / tile;
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = t * tile;
    const int j0 = t0 + threadIdx.x * kCells;
    const int owner = tile_owner(t0, j0, tile, N, kCells);
    const bool first = t == 0;
    const bool sender = t + 1 < T && owner >= 0;
    float x0[kCells], x1[kCells];
    load_cells(x0, e0g + base, j0, N);
    load_cells(x1, e1g + base, j0, N);
    for (int k = 0; k < K; ++k) {
      if (!first) take(sm, mb, k, kTail ? &sm.etail[k] : nullptr, parity);
      float x1_up = 0.f;
      if constexpr (kTail)
        x1_up = upwind_value(x1[kCells - 1], &sm.etail[k], sm.edge_p);
      float f0[kCells], f1[kCells];
      substep_tile<KIND>(kc, x0, x1, x0, x1, x0, x1, x1_up, 0.f,
                         sm.carry + k, owner, sm, buf, f0, f1);
      if (sender) give(sm, mb, k, next, x1[kCells - 1], kTail);
      if (k == K - 1) {
        store_cells(op0g + base, j0, N, x0);
        store_cells(op1g + base, j0, N, x1);
      }
      copy_cells(x0, f0);
      copy_cells(x1, f1);
    }
    store_cells(o0g + base, j0, N, x0);
    store_cells(o1g + base, j0, N, x1);
    if (!first) parity ^= 1u;
  }
  if (rank == (T - 1) % C) record_row(sm, K, rec, w.h, w.row, reflective);
  close_mailboxes();
}

// B5, replaces _make_halo_multistep_kernel (pallas_sweep.py:568): K whole
// seeded BE or CN steps over packed rows, as halo_bdf2_kernel.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    halo_multistep_kernel(const float* __restrict__ coef,
                          const float* __restrict__ seeds, float* rec,
                          const float* __restrict__ e0g,
                          const float* __restrict__ e1g,
                          float* __restrict__ o0g, float* __restrict__ o1g,
                          float* __restrict__ op0g, float* __restrict__ op1g,
                          int X, int K, int reset_cell) {
  __shared__ Shared sm;
  const int row = blockIdx.x;
  const Coef kc = load_coef(coef + row * kNCoef);
  const size_t base = static_cast<size_t>(row) * X;
  int buf = 0;
  seed_row(sm, K, K, nullptr);
  multistep_segment<KIND>(kc, e0g + base, e1g + base, o0g + base, o1g + base,
                          op0g + base, op1g + base, 0, reset_cell, K, sm, buf);
  seed_row(sm, K, K, seeds + static_cast<size_t>(row) * K);
  multistep_segment<KIND>(kc, e0g + base, e1g + base, o0g + base, o1g + base,
                          op0g + base, op1g + base, reset_cell, X, K, sm, buf);
  write_record(sm, K, rec + static_cast<size_t>(row) * K);
}

// B3's loads: the planes of kind KIND as they are.
template <int KIND>
struct PlainLoad {
  const float *e0, *e1, *p0, *p1, *h0, *h1;
  int N;
  __device__ __forceinline__ void operator()(
      int j0, float (&x0)[kCells], float (&x1)[kCells], float (&q0p)[kCells],
      float (&q1p)[kCells], float (&q0h)[kCells],
      float (&q1h)[kCells]) const {
    load_cells(x0, e0, j0, N);
    load_cells(x1, e1, j0, N);
    if constexpr (KIND == kCN) load_cells(q1p, p1, j0, N);
    if constexpr (KIND == kBDF) {
      load_cells(q0p, p0, j0, N);
      load_cells(q1p, p1, j0, N);
      load_cells(q0h, h0, j0, N);
      load_cells(q1h, h1, j0, N);
    }
  }
};

// B3, replaces _make_kernel (pallas_sweep.py:229): one sub-step. BE reads
// (e0, e1), CN also p1, BDF all six planes.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    substep_kernel(const float* __restrict__ coef,
                   const float* __restrict__ bc, const int* __restrict__ flip,
                   float* rec, const float* __restrict__ e0g,
                   const float* __restrict__ e1g,
                   const float* __restrict__ p0g,
                   const float* __restrict__ p1g,
                   const float* __restrict__ h0g,
                   const float* __restrict__ h1g, float* __restrict__ o0g,
                   float* __restrict__ o1g, int Bh, int N, float s,
                   int reflective, int half0) {
  __shared__ Shared sm;
  const int row = blockIdx.x % Bh;
  const int h = half0 + blockIdx.x / Bh;
  const int hr = h * Bh + row;
  const float s_of[1] = {s};
  init_row(sm, 1, 1, s_of, 1, bc, flip, rec, h, row, hr, reflective);
  const size_t base = static_cast<size_t>(hr) * N;
  const PlainLoad<KIND> load{e0g + base, e1g + base, p0g + base,
                             p1g + base, h0g + base, h1g + base, N};
  int buf = 0;
  substep_segment<KIND>(load_coef(coef + hr * kNCoef), load, o0g + base,
                        o1g + base, N, sm, buf);
  record_row(sm, 1, rec, h, row, reflective);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// the launch's error (0 on success). Planes are contiguous (2, Bh, N)
// float32, coefficients (2, Bh, 10) float32, bc (2, Bh, 1) float32, flip
// (Bh,) int32, rec a (Bh, slots) float32 scratch record.

// B1's and B2's launch shape for rows of N cells at K steps of
// slots_per_step slots each (4: B1; 1: B2, both kinds), at most max_threads
// threads a block and max_cluster blocks a row, `rows` rows a launch (Bh for
// a reflective boundary, else 2*Bh): out = (threads a block, blocks a row
// (the cluster), tiles a row).
int rt_sweep_geometry(int N, int K, int slots_per_step, int max_threads,
                      int max_cluster, int rows, int* out) {
  if (N < 1 || K < 1 || K > kMaxSteps ||
      (slots_per_step != 4 && slots_per_step != 1) || max_threads < 32 ||
      max_threads > kMaxThreads || max_threads % 32 || max_cluster < 1 ||
      max_cluster > kMaxCluster || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pick_threads(N, kCells, max_threads);
  const int tiles = (N + threads * kCells - 1) / (threads * kCells);
  out[0] = threads;
  out[1] = slots_per_step == 4
               ? wave_cluster(tiles, 4 * K, threads, max_cluster, rows,
                              {reinterpret_cast<const void*>(&bdf2_kernel)})
               : wave_cluster(
                     tiles, K, threads, max_cluster, rows,
                     {reinterpret_cast<const void*>(&multistep_kernel<kBE>),
                      reinterpret_cast<const void*>(&multistep_kernel<kCN>)});
  out[2] = tiles;
  return 0;
}

int rt_sweep_bdf2(const float* cbe, const float* ccn, const float* cbdf,
                  const float* bc, const int* flip, float* rec,
                  const float* e0, const float* e1, float* o0, float* o1,
                  float* oh0, float* oh1, float* op0, float* op1, int Bh,
                  int N, int K, float s_be, float s_cn, float s_bdf,
                  int symmetric, int reflective, int max_threads,
                  int max_cluster, void* stream) {
  if (Bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_sweep_geometry(N, K, 4, max_threads, max_cluster,
                                    reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A refused cluster launch returns its error, and the second half is not
  // launched.
  return launch_halves_ex(Bh, reflective, [&](int grid, int half0) {
    return launch_clusters(bdf2_kernel, grid, geo[1], geo[0], st, cbe, ccn,
                           cbdf, bc, flip, rec, e0, e1, o0, o1, oh0, oh1,
                           op0, op1, Bh, N, K, s_be, s_cn, s_bdf, symmetric,
                           reflective, half0);
  });
}

int rt_sweep_multistep(int kind, const float* coef, const float* bc,
                       const int* flip, float* rec, const float* e0,
                       const float* e1, float* o0, float* o1, float* op0,
                       float* op1, int Bh, int N, int K, float s,
                       int reflective, int max_threads, int max_cluster,
                       void* stream) {
  if (Bh < 1 || (kind != kBE && kind != kCN))
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_sweep_geometry(N, K, 1, max_threads, max_cluster,
                                    reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_halves_ex(Bh, reflective, [&](int grid, int half0) {
    return launch_clusters(
        kind == kBE ? &multistep_kernel<kBE> : &multistep_kernel<kCN>, grid,
        geo[1], geo[0], st, coef, bc, flip, rec, e0, e1, o0, o1, op0, op1,
        Bh, N, K, s, reflective, half0);
  });
}

int rt_sweep_substep(int kind, const float* coef, const float* bc,
                     const int* flip, float* rec, const float* e0,
                     const float* e1, const float* p0, const float* p1,
                     const float* h0, const float* h1, float* o0, float* o1,
                     int Bh, int N, float s, int reflective, void* stream) {
  if (Bh < 1 || N < 1 || kind < kBE || kind > kBDF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = pick_threads(N, kCells, kMaxThreads);
  return launch_halves(Bh, reflective, [&](int grid, int half0) {
    if (kind == kBE)
      substep_kernel<kBE><<<grid, threads, 0, st>>>(
          coef, bc, flip, rec, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, s,
          reflective, half0);
    else if (kind == kCN)
      substep_kernel<kCN><<<grid, threads, 0, st>>>(
          coef, bc, flip, rec, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, s,
          reflective, half0);
    else
      substep_kernel<kBDF><<<grid, threads, 0, st>>>(
          coef, bc, flip, rec, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, s,
          reflective, half0);
  });
}

// The halo kernels take packed (rows, X) planes, rows = 2*Bh with the mu<0
// rows first, coefficients (rows, 10), seeds and rec (rows, slots), and the
// cell reset_cell in [0, X) where the seeded chain starts.

int rt_sweep_halo_bdf2(const float* cbe, const float* ccn, const float* cbdf,
                       const float* seeds, float* rec, const float* e0,
                       const float* e1, float* o0, float* o1, float* oh0,
                       float* oh1, float* op0, float* op1, int rows, int X,
                       int K, int reset_cell, int symmetric, void* stream) {
  if (K < 1 || K > kMaxSteps || rows < 2 || rows % 2 || X < 1 ||
      reset_cell < 0 || reset_cell >= X)
    return static_cast<int>(cudaErrorInvalidValue);
  halo_bdf2_kernel<<<rows, pick_threads(X, kCells, kMaxThreads), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cbe, ccn, cbdf, seeds, rec, e0, e1, o0, o1, oh0, oh1, op0, op1, rows, X,
      K, reset_cell, symmetric);
  return static_cast<int>(cudaGetLastError());
}

int rt_sweep_halo_multistep(int kind, const float* coef, const float* seeds,
                            float* rec, const float* e0, const float* e1,
                            float* o0, float* o1, float* op0, float* op1,
                            int rows, int X, int K, int reset_cell,
                            void* stream) {
  if (K < 1 || K > kMaxSteps || rows < 2 || rows % 2 || X < 1 ||
      reset_cell < 0 || reset_cell >= X || (kind != kBE && kind != kCN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = pick_threads(X, kCells, kMaxThreads);
  if (kind == kBE)
    halo_multistep_kernel<kBE><<<rows, threads, 0, st>>>(
        coef, seeds, rec, e0, e1, o0, o1, op0, op1, X, K, reset_cell);
  else
    halo_multistep_kernel<kCN><<<rows, threads, 0, st>>>(
        coef, seeds, rec, e0, e1, o0, o1, op0, op1, X, K, reset_cell);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
