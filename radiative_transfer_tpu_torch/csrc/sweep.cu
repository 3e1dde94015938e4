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
// share; B3 on its two stages, substep_rhs and substep_out, with the
// look-back between them, lookback.cuh lb_substep), and one block-wide
// scan of affine maps (the counterpart of _hillis_steele, in tiles.cuh,
// which the double-float kernels of df_sweep.cu share too). B1, B2, B4 and
// B5 walk each row as a cluster wavefront (cluster.cuh, which df_sweep.cu's
// B6, B7, B14 and B15 share; B1's walk is wave.cuh bdf2_wave, which the
// K-fused adjoint forward B11 of adjoint.cu and B4 run too, and B2's is
// wave.cuh multistep_wave, which B5 runs too). B3 runs one sub-step as a
// one-slot look-back scan, one block a tile (lookback.cuh, which B9 of
// adjoint.cu and B13 of fused.cu share); no kernel here walks a row on one
// block.
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
// * B1, B2, B4 and B5 run a row's tiles as a wavefront over (tile, slot) on a
//   thread block cluster of C blocks (bdf2_kernel, multistep_kernel,
//   halo_bdf2_kernel, halo_multistep_kernel): slot s of tile t needs only slot
//   s of tile t-1 and slot s-1 of tile t, so block rank r of the row's cluster
//   runs tiles r, r + C, ..., and tile t runs slot s while tile t+1 runs slot
//   s-1. Per slot the mail to the next tile's block is the carry leaving the
//   tile, plus the tail the slot carries: B1 and B4 hand step k's upwind p1
//   edge on with slot 4k and its h1 edge with slot 4k+1, B2-CN and B5-CN step
//   k's p1 edge with slot k, B2-BE and B5-BE nothing more. The mail goes into
//   the next block's mailbox in distributed shared memory, one mbarrier a slot
//   (cluster.cuh: the protocol and why it needs no "free" signal). Only a
//   chain's last tile may be ragged; the row's last sends nothing, and the
//   block that runs it writes the outflow record. C = min(16, slots, tiles),
//   shrunk until every row's cluster of the launch is resident on the card
//   (rt_sweep_geometry, rt_sweep_halo_bdf2_geometry,
//   rt_sweep_halo_multistep_geometry). The tiles, slots and arithmetic are
//   those of the one-block walk, so the planes are the same to the bit.
// * B3 has one slot, so it needs no wavefront: one thread block a tile of
//   blockDim*kCells cells (SUBSTEP_THREADS threads, ops/cuda_sweep.py),
//   every tile of both halves in one launch, each tile's carry in resolved
//   by decoupled look-back over its row's earlier tiles (substep_kernel).
// * Each thread holds kCells consecutive cells in registers. A tile's scan is
//   a serial scan over the thread's cells, a warp-shuffle scan of the
//   per-thread affine maps (a^kCells, local total), one cross-warp pass in
//   shared memory, and a serial fix-up of the thread's cells.
// * Reflective left boundary: the mu>0 inflow of row i is s_p times the mu<0
//   outflow of row flip[i] for the same (step, phase). In B1 and B2 the mu<0
//   half is launched first and writes a (Bh, slots) outflow record; the mu>0
//   half is launched second and reads it through `flip` (a gather: the TPU
//   kernel's permutation matmul exists only because Mosaic has no reverse).
//   B3 runs both halves in one launch, the mu>0 row starts waiting on the
//   flipped mu<0 rows' last look-back words. With a source boundary the
//   halves are independent and share one launch.
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
//   multiple of the JAX block, not of this kernel's tile). B4 and B5 run
//   both on the row's one cluster as one sequence of tiles, the seeded
//   chain's first tile taking its mail before it reseeds (cluster.cuh
//   HaloChains; the halo chain's last tile, ragged or not, sends). Every
//   row records its carries after the last cell, from the block that ran
//   its last tile. Because this kernel scans
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
// reflective slab still waits for the whole mu<0 half. The halo kernels run
// all 2*Bh rows at once, B4 and B5 each on 8 clusters of C blocks at gray
// S_8, the halo chain's tiles ahead of the seeded chain's on the same
// cluster. B3 puts all 2*Bh*T tiles of a sub-step in flight at once: its
// serial depth is one look-back a tile, not the row's T tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "lookback.cuh"
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

// -- the wavefronts: a row's tiles across a thread block cluster ------------
//
// Per slot the mail is the carry leaving the tile and, where the slot
// carries one, a tail: B1's and B4's slot 4k step k's upwind p1 edge
// (etail[k]), their slot 4k+1 step k's h1 edge (htail[k]); B2-CN's and
// B5-CN's slot k step k's p1 edge. B2-BE's and B5-BE's mail is the carry
// alone (wave.cuh: take, give).

// B1, replaces _make_bdf2_kernel (pallas_sweep.py:444): K whole BDF2 steps,
// each BE(dt/2), CN(dt/2), BE(dt/2) and the BDF corrector, as a wavefront
// over (tile, slot) (wave.cuh bdf2_wave, which B11 runs with its records):
// the cluster of C blocks at blockIdx.x / C owns one row, block rank r its
// tiles r, r + C, ... The tiles, slots and arithmetic are those of one
// block walking the row; only who runs a tile and how a slot's state
// reaches the next tile differ, so the planes are that walk's to the bit.
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
// BDF2 steps over packed rows (mu<0 rows first), each row a wavefront over
// (tile, slot) on a cluster of C blocks (wave.cuh bdf2_wave, B1's body):
// the row's halo chain [0, reset_cell) from zero carries and its seeded
// chain [reset_cell, X) run as ONE sequence of tiles (cluster.cuh
// HaloChains), and the seeded chain's first tile takes each slot's mail
// before it starts from seeds[slot] with zero tails (take-and-reseed), so
// the halo chain costs the launch no cluster. With reset_cell 0 the row is
// one chain from the seeds, B1's layout. The tiles, slots and arithmetic
// are those of the one-block walk this kernel ran before; every row records
// its carries after the last cell, from the block that ran its last tile.
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
  __shared__ WaveMail mb;
  const WaveRow w = wave_row(rows, 0);
  const int row = w.hr;
  const int slots = 4 * K;
  const float* sd = seeds + static_cast<size_t>(row) * slots;
  open_mailboxes(mb, slots);
  // Tails on every block; the slots' inflow (zero before a halo chain, else
  // the seeds) serves tile 0 only.
  seed_row(sm, slots, K, reset_cell > 0 ? nullptr : sd);
  const size_t base = static_cast<size_t>(row) * X;
  // The per-row blend of the half snapshot: both halves share the launch.
  bdf2_wave(load_coef(cbe + row * kNCoef), load_coef(ccn + row * kNCoef),
            load_coef(cbdf + row * kNCoef), symmetric || row < rows / 2,
            e0g + base, e1g + base, o0g + base, o1g + base, oh0g + base,
            oh1g + base, op0g + base, op1g + base, X, K, sm, mb, w.C, w.rank,
            rec + static_cast<size_t>(row) * slots, NoRecords(),
            HaloChains(reset_cell, blockDim.x * kCells), sd);
  close_mailboxes();
}

// B2, replaces _make_multistep_kernel (pallas_sweep.py:387): K whole BE or
// CN steps, prev = each step's input, as a wavefront over (tile, slot) as in
// bdf2_kernel, one slot a step (wave.cuh multistep_wave, which B5 shares).
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
  __shared__ Shared sm;
  __shared__ StepMail<KIND> mb;
  const WaveRow w = wave_row(Bh, half0);
  const float s_of[1] = {s};
  open_mailboxes(mb, K);
  // Tails on every block; the slots' inflow serves tile 0 only.
  init_row(sm, K, K, s_of, 1, bc, flip, rec, w.h, w.row, w.hr, reflective);
  const size_t base = static_cast<size_t>(w.hr) * N;
  // The block that ran the row's last tile holds the outflow carries.
  if (multistep_wave<KIND>(load_coef(coef + w.hr * kNCoef), e0g + base,
                           e1g + base, o0g + base, o1g + base, op0g + base,
                           op1g + base, N, K, sm, mb, w.C, w.rank))
    record_row(sm, K, rec, w.h, w.row, reflective);
  close_mailboxes();
}

// B5, replaces _make_halo_multistep_kernel (pallas_sweep.py:568): K whole
// seeded BE or CN steps over packed rows (mu<0 rows first), each row a
// wavefront over (tile, slot) on a cluster of C blocks (wave.cuh
// multistep_wave, B2's body), laid out as halo_bdf2_kernel's: the row's
// halo chain [0, reset_cell) from zero carries and its seeded chain
// [reset_cell, X) as ONE sequence of tiles (cluster.cuh HaloChains), the
// seeded chain's first tile taking each slot's mail before it starts from
// seeds[k] with a zero tail (take-and-reseed). With reset_cell 0 the row is
// one chain from the seeds. Every row records its carries after the last
// cell, from the block that ran its last tile.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    halo_multistep_kernel(const float* __restrict__ coef,
                          const float* __restrict__ seeds, float* rec,
                          const float* __restrict__ e0g,
                          const float* __restrict__ e1g,
                          float* __restrict__ o0g, float* __restrict__ o1g,
                          float* __restrict__ op0g, float* __restrict__ op1g,
                          int rows, int X, int K, int reset_cell) {
  __shared__ Shared sm;
  __shared__ StepMail<KIND> mb;
  const WaveRow w = wave_row(rows, 0);
  const int row = w.hr;
  const float* sd = seeds + static_cast<size_t>(row) * K;
  open_mailboxes(mb, K);
  // Tails on every block; the slots' inflow (zero before a halo chain, else
  // the seeds) serves tile 0 only.
  seed_row(sm, K, K, reset_cell > 0 ? nullptr : sd);
  const size_t base = static_cast<size_t>(row) * X;
  if (multistep_wave<KIND>(load_coef(coef + row * kNCoef), e0g + base,
                           e1g + base, o0g + base, o1g + base, op0g + base,
                           op1g + base, X, K, sm, mb, w.C, w.rank,
                           HaloChains(reset_cell, blockDim.x * kCells), sd))
    write_record(sm, K, rec + static_cast<size_t>(row) * K);
  close_mailboxes();
}

// B3, replaces _make_kernel (pallas_sweep.py:229): one BE, CN or BDF
// sub-step as a one-slot look-back scan (lookback.cuh lb_substep), one
// thread block a tile of blockDim*kCells cells, both halves in one launch
// (lb_tile: every mu<0 ticket first for a reflective boundary; tile 0's
// carry in from lb_row_inflow). BE reads (e0, e1), CN also p1, BDF all six
// planes. A tile's upwind p1/h1 edges are the input planes' values at cell
// t0 - 1, and 0 at a half's start, where JAX zeroes its tails
// (pallas_sweep.py:244-266): no block waits on another for an edge.
// `status` holds the words (2*Bh, T), then the tile counter, all zeroed.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    substep_kernel(const float* __restrict__ coef,
                   const float* __restrict__ bc, const int* __restrict__ flip,
                   const float* __restrict__ e0g,
                   const float* __restrict__ e1g,
                   const float* __restrict__ p0g,
                   const float* __restrict__ p1g,
                   const float* __restrict__ h0g,
                   const float* __restrict__ h1g, float* __restrict__ o0g,
                   float* __restrict__ o1g, int Bh, int N, int T, float s,
                   int reflective, unsigned long long* status) {
  __shared__ LookbackShared sm;
  lb_ticket(sm, status + static_cast<size_t>(2 * Bh) * T);
  __syncthreads();
  const LbTile w = lb_tile(sm.ticket, Bh, T, reflective);
  const int hr = w.h * Bh + w.row;
  const int tile = blockDim.x * kCells;
  const int t0 = w.t * tile;
  const int j0 = t0 + threadIdx.x * kCells;
  const int owner = tile_owner(t0, j0, tile, N, kCells);
  const size_t base = static_cast<size_t>(hr) * N;
  const Coef kc = load_coef(coef + hr * kNCoef);
  float x0[kCells], x1[kCells], p0[kCells], p1[kCells], q0[kCells],
      q1[kCells], o0[kCells], o1[kCells], c_out;
  load_cells(x0, e0g + base, j0, N);
  load_cells(x1, e1g + base, j0, N);
  // Thread 0's upwind values of the tile (t0 - 1 lies inside the row).
  if constexpr (KIND != kBE) {
    load_cells(p1, p1g + base, j0, N);
    if (threadIdx.x == 0) sm.ptail = t0 ? p1g[base + t0 - 1] : 0.f;
  }
  if constexpr (KIND == kBDF) {
    load_cells(p0, p0g + base, j0, N);
    load_cells(q0, h0g + base, j0, N);
    load_cells(q1, h1g + base, j0, N);
    if (threadIdx.x == 0) sm.htail = t0 ? h1g[base + t0 - 1] : 0.f;
  }
  unsigned long long* st = status + static_cast<size_t>(hr) * T;
  auto inflow = [=] {
    return lb_row_inflow(s, status, w.h, w.row, hr, T, reflective, bc, flip);
  };
  int buf = 0;
  if constexpr (KIND == kBE) {
    lb_substep<kBE>(kc, x0, x1, x0, x1, x0, x1, 0.f, 0.f, w.t, T, owner, st,
                    inflow, sm, buf, o0, o1, c_out);
  } else if constexpr (KIND == kCN) {
    const float p1_up = upwind_value(p1[kCells - 1], &sm.ptail, sm.edge_p);
    lb_substep<kCN>(kc, x0, x1, x0, p1, x0, x1, p1_up, 0.f, w.t, T, owner,
                    st, inflow, sm, buf, o0, o1, c_out);
  } else {
    const float p1_up = upwind_value(p1[kCells - 1], &sm.ptail, sm.edge_p);
    const float h1_up = upwind_value(q1[kCells - 1], &sm.htail, sm.edge_h);
    lb_substep<kBDF>(kc, x0, x1, p0, p1, q0, q1, p1_up, h1_up, w.t, T, owner,
                     st, inflow, sm, buf, o0, o1, c_out);
  }
  store_cells(o0g + base, j0, N, o0);
  store_cells(o1g + base, j0, N, o1);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// the launch's error (0 on success). Planes are contiguous (2, Bh, N)
// float32, coefficients (2, Bh, 10) float32, bc (2, Bh, 1) float32, flip
// (Bh,) int32, rec a (Bh, slots) float32 scratch record (B1, B2; B3 takes
// a look-back scratch instead).

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

// B3's launch shape for rows of N cells at most max_threads threads a block
// (a power of two from 32 to 512): out = (threads a block, look-back tiles
// a row); the scratch the wrapper passes holds 2 * Bh * tiles + 1 words.
int rt_sweep_substep_geometry(int N, int max_threads, int* out) {
  if (!lb_shape_ok(N, max_threads, kMaxThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  lb_geometry(N, kCells, max_threads, out);
  return 0;
}

// Unread planes may alias any plane (BE reads e0, e1; CN also p1). status:
// the look-back scratch of rt_sweep_substep_geometry's size at the same
// max_threads, zeroed here before the launch. Both halves run in one
// launch, the mu<0 half's tiles first for a reflective boundary.
int rt_sweep_substep(int kind, const float* coef, const float* bc,
                     const int* flip, const float* e0, const float* e1,
                     const float* p0, const float* p1, const float* h0,
                     const float* h1, float* o0, float* o1,
                     unsigned long long* status, int Bh, int N, float s,
                     int reflective, int max_threads, void* stream) {
  int geo[2];
  if (Bh < 1 || kind < kBE || kind > kBDF ||
      rt_sweep_substep_geometry(N, max_threads, geo))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = geo[0], T = geo[1];
  const cudaError_t err = cudaMemsetAsync(
      status, 0,
      (static_cast<size_t>(2 * Bh) * T + 1) * sizeof(*status), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = 2 * Bh * T;
  if (kind == kBE)
    substep_kernel<kBE><<<grid, threads, 0, st>>>(
        coef, bc, flip, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, T, s,
        reflective, status);
  else if (kind == kCN)
    substep_kernel<kCN><<<grid, threads, 0, st>>>(
        coef, bc, flip, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, T, s,
        reflective, status);
  else
    substep_kernel<kBDF><<<grid, threads, 0, st>>>(
        coef, bc, flip, e0, e1, p0, p1, h0, h1, o0, o1, Bh, N, T, s,
        reflective, status);
  return static_cast<int>(cudaGetLastError());
}

// The halo kernels take packed (rows, X) planes, rows = 2*Bh with the mu<0
// rows first, coefficients (rows, 10), seeds and rec (rows, slots), and the
// cell reset_cell in [0, X) where the seeded chain starts.

// B4's launch shape for `rows` packed rows of X cells at K steps with the
// seeded chains from reset_cell, at most max_threads threads a block and
// max_cluster blocks a row: out = (threads a block, blocks a row (the
// cluster), tiles of the seeded chain [reset_cell, X), tiles of the halo
// chain [0, reset_cell)). One cluster a row runs both chains.
int rt_sweep_halo_bdf2_geometry(int X, int K, int reset_cell,
                                int max_threads, int max_cluster, int rows,
                                int* out) {
  if (K < 1 || K > kMaxSteps || rows < 2 || rows % 2 || X < 1 ||
      reset_cell < 0 || reset_cell >= X || max_threads < 32 ||
      max_threads > kMaxThreads || max_threads % 32 || max_cluster < 1 ||
      max_cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pick_threads(X, kCells, max_threads);
  const int tile = threads * kCells;
  const int main_tiles = (X - reset_cell + tile - 1) / tile;
  const int halo_tiles = (reset_cell + tile - 1) / tile;
  out[0] = threads;
  out[1] = wave_cluster(main_tiles + halo_tiles, 4 * K, threads, max_cluster,
                        rows,
                        {reinterpret_cast<const void*>(&halo_bdf2_kernel)});
  out[2] = main_tiles;
  out[3] = halo_tiles;
  return 0;
}

// max_threads and max_cluster as rt_sweep_halo_bdf2_geometry's.
int rt_sweep_halo_bdf2(const float* cbe, const float* ccn, const float* cbdf,
                       const float* seeds, float* rec, const float* e0,
                       const float* e1, float* o0, float* o1, float* oh0,
                       float* oh1, float* op0, float* op1, int rows, int X,
                       int K, int reset_cell, int symmetric, int max_threads,
                       int max_cluster, void* stream) {
  int geo[4];
  const int bad = rt_sweep_halo_bdf2_geometry(X, K, reset_cell, max_threads,
                                              max_cluster, rows, geo);
  if (bad) return bad;
  // A refused cluster launch returns its error.
  return static_cast<int>(launch_clusters(
      halo_bdf2_kernel, rows, geo[1], geo[0],
      static_cast<cudaStream_t>(stream), cbe, ccn, cbdf, seeds, rec, e0, e1,
      o0, o1, oh0, oh1, op0, op1, rows, X, K, reset_cell, symmetric));
}

// B5's launch shape for `rows` packed rows of X cells at K steps with the
// seeded chains from reset_cell, at most max_threads threads a block and
// max_cluster blocks a row: out = (threads a block, blocks a row (the
// cluster), tiles of the seeded chain [reset_cell, X), tiles of the halo
// chain [0, reset_cell)). One cluster a row runs both chains, one slot a
// step.
int rt_sweep_halo_multistep_geometry(int X, int K, int reset_cell,
                                     int max_threads, int max_cluster,
                                     int rows, int* out) {
  if (K < 1 || K > kMaxSteps || rows < 2 || rows % 2 || X < 1 ||
      reset_cell < 0 || reset_cell >= X || max_threads < 32 ||
      max_threads > kMaxThreads || max_threads % 32 || max_cluster < 1 ||
      max_cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pick_threads(X, kCells, max_threads);
  const int tile = threads * kCells;
  const int main_tiles = (X - reset_cell + tile - 1) / tile;
  const int halo_tiles = (reset_cell + tile - 1) / tile;
  out[0] = threads;
  out[1] = wave_cluster(
      main_tiles + halo_tiles, K, threads, max_cluster, rows,
      {reinterpret_cast<const void*>(&halo_multistep_kernel<kBE>),
       reinterpret_cast<const void*>(&halo_multistep_kernel<kCN>)});
  out[2] = main_tiles;
  out[3] = halo_tiles;
  return 0;
}

// max_threads and max_cluster as rt_sweep_halo_multistep_geometry's.
int rt_sweep_halo_multistep(int kind, const float* coef, const float* seeds,
                            float* rec, const float* e0, const float* e1,
                            float* o0, float* o1, float* op0, float* op1,
                            int rows, int X, int K, int reset_cell,
                            int max_threads, int max_cluster, void* stream) {
  if (kind != kBE && kind != kCN)
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[4];
  const int bad = rt_sweep_halo_multistep_geometry(
      X, K, reset_cell, max_threads, max_cluster, rows, geo);
  if (bad) return bad;
  // A refused cluster launch returns its error.
  return static_cast<int>(launch_clusters(
      kind == kBE ? &halo_multistep_kernel<kBE> : &halo_multistep_kernel<kCN>,
      rows, geo[1], geo[0], static_cast<cudaStream_t>(stream), coef, seeds,
      rec, e0, e1, o0, o1, op0, op1, rows, X, K, reset_cell));
}

}  // extern "C"
