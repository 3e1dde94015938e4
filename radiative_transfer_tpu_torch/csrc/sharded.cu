// Hand-written Hopper (sm_90a) kernel of the per-sub-step mesh engine
// (parallel/sharded_cuda.py).
//
// Replaces the Pallas TPU kernel factory of
// radiative_transfer_tpu/ops/pallas_sweep.py:
//   rt_sharded_substep <- _make_sharded_packed_kernel (B8: one zero-inflow
//                         BE, CN or BDF sub-step over packed rows)
//
// What is computed. Per packed row (2*Bh_l rows, the mu<0 rows first; both
// halves are independent because every row starts from a zero carry) and
// per cell of the shard: B3's sub-step (substep_tile, tiles.cuh) with three
// changes that make it shard-local (pallas_sweep.py:289-384):
// * the carry entering the row is zero: the true inflow (boundary source,
//   upstream shard, reflective coupling) is applied later by the engine as a
//   deferred correction, because the cell's 2x2 solve is affine in it;
// * every input plane pair arrives as zero-inflow planes plus a pending
//   correction (inc, d0, a, ln_a) and is rebuilt on load:
//   true(j) = z(j) + (d0 * a^j * inc, a^(j+1) * inc), a^j = expf(j * ln_a)
//   with j the cell index inside the shard, as the JAX kernel computes it
//   (float32 j, expf and not __expf; ln_a is clamped at -80 on the host);
// * the CN/BDF upwind p1/h1 tails of the first cell come from (rows, 1)
//   halo inputs (the upstream shard's corrected last-cell edges), not zero.
//
// What bounds it on this card: bytes. A BDF sub-step reads 6 planes and
// writes 2, each once (about 43 + 21 float32 operations a cell against 32
// bytes); the look-back adds 8 bytes a tile. The row walk it replaced ran
// one block a row, 32 SMs at the gray rung's shard, each waiting on its
// tile's loads with nothing else in flight.
//
// Design: a single-pass chained scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), one thread block a tile of blockDim*8 cells, rows x T
// blocks. `a` is constant along a row, so a tile's carry map is
// x -> a^n * x + B_t and only the one float B_t has to travel between
// tiles. Each block
// * takes its (row, tile) from a per-launch atomic counter, tile-major
//   across the rows, so every tile's predecessors were handed to blocks
//   that are resident or done: the look-back cannot wait on a block that
//   has not started;
// * loads its cells through CorrLoad and builds b from them (substep_rhs,
//   B3's arithmetic per cell), takes the CN/BDF upwind tails of its first
//   cell from cell j0 - 1 of the corrected p1/h1 planes in device memory
//   (from the halo columns at j0 = 0), and block-scans b from a zero carry;
// * publishes (AGGREGATE, B_t) as one 64-bit status word (tile 0, whose
//   carry in is zero, publishes INCLUSIVE at once), then with its first
//   warp reads its predecessors' words 32 at a time, nearest first
//   (backing off while one is not yet published), until tile t-1-d holds
//   an INCLUSIVE prefix P: carry_in = sum_{i<d} (a^tile)^i B_{t-1-i} +
//   (a^tile)^d P;
// * publishes (INCLUSIVE, a^tile * carry_in + B_t), then reconstructs every
//   cell from its carry in (substep_out) and stores.
// The serial part of a row is reading one word per predecessor tile, 32
// at a time, instead of a tile's loads and scans. The status words (rows x
// T) and the counter live in one scratch the wrapper allocates; the entry
// point zeroes it on the stream before each launch. The scan is exact over
// each tile; across tiles it composes the tiles' maps in another order
// than B3's serial walk, which is rounding, not truncation.

#include <cuda_runtime.h>

#include "segments.cuh"

namespace {

constexpr int kCells = kSegCells;

// A pending inflow correction of one row: (inc, d0, a, ln_a).
struct Corr {
  float inc, d0, a, ln_a;
};

__device__ __forceinline__ Corr load_corr(const float* __restrict__ c) {
  return Corr{c[0], c[1], c[2], c[3]};
}

// The thread's true cells of a plane pair from j0: z + (d0, a) * a^j * inc.
// Cells past N load as 0, as load_cells leaves them.
__device__ __forceinline__ void corrected(float (&x0)[kCells],
                                          float (&x1)[kCells],
                                          const float* __restrict__ z0,
                                          const float* __restrict__ z1,
                                          const Corr& k, int j0, int N) {
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int j = j0 + c;
    if (j < N) {
      const float apj = expf(static_cast<float>(j) * k.ln_a) * k.inc;
      x0[c] = z0[j] + k.d0 * apj;
      x1[c] = z1[j] + k.a * apj;
    } else {
      x0[c] = 0.f;
      x1[c] = 0.f;
    }
  }
}

// The second edge of a corrected pair alone (CN's p1).
__device__ __forceinline__ void corrected1(float (&x1)[kCells],
                                           const float* __restrict__ z1,
                                           const Corr& k, int j0, int N) {
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int j = j0 + c;
    x1[c] = j < N ? z1[j] + k.a * (expf(static_cast<float>(j) * k.ln_a) *
                                   k.inc)
                  : 0.f;
  }
}

// B8's loads: the planes of kind KIND rebuilt from their z-planes and
// pending corrections (e; CN p1 from cp; BDF p from cp, h from ch).
template <int KIND>
struct CorrLoad {
  const float *e0, *e1, *p0, *p1, *h0, *h1;
  Corr ce, cp, ch;
  int N;
  __device__ __forceinline__ void operator()(
      int j0, float (&x0)[kCells], float (&x1)[kCells], float (&q0p)[kCells],
      float (&q1p)[kCells], float (&q0h)[kCells],
      float (&q1h)[kCells]) const {
    corrected(x0, x1, e0, e1, ce, j0, N);
    if constexpr (KIND == kCN) corrected1(q1p, p1, cp, j0, N);
    if constexpr (KIND == kBDF) {
      corrected(q0p, q1p, p0, p1, cp, j0, N);
      corrected(q0h, q1h, h0, h1, ch, j0, N);
    }
  }
};

// The corrected value of a plane's second edge at cell j (CorrLoad's).
__device__ __forceinline__ float corrected_at(const float* __restrict__ z1,
                                             const Corr& k, int j) {
  return z1[j] + k.a * (expf(static_cast<float>(j) * k.ln_a) * k.inc);
}

// A tile's status word: flag in the high half, the float's bits in the low.
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

__device__ __forceinline__ void publish(unsigned long long* w, unsigned flag,
                                        float v) {
  const unsigned long long word =
      (static_cast<unsigned long long>(flag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(w), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* w) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(word)
               : "l"(w)
               : "memory");
  return word;
}

// The carry entering tile t > 0 of a row whose status words start at `st`,
// by one whole warp: lane i reads the word of tile j - i (a word before the
// row's start reads as INCLUSIVE 0, the row's zero inflow), spinning until
// every lane up to the nearest INCLUSIVE one holds a word; then the lanes'
// values, weighted (a^tile)^i, are summed. Every tile before the row's last
// is full, so each has the map x -> a_tile * x + B.
__device__ __forceinline__ float look_back(const unsigned long long* st,
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
    for (unsigned ns = 32;; ns = ns < 1024 ? 2 * ns : ns) {
      word = jt >= 0 ? peek(st + jt)
                     : static_cast<unsigned long long>(kInclusive) << 32;
      const unsigned flag = static_cast<unsigned>(word >> 32);
      incl = __ballot_sync(kFull, flag == kInclusive);
      const unsigned ready = __ballot_sync(kFull, flag != 0u);
      // Lanes 0 .. the nearest INCLUSIVE one (all 32 if there is none).
      const unsigned need = incl ? ((incl & (0u - incl)) << 1) - 1u : kFull;
      if ((ready & need) == need) break;
      __nanosleep(ns);  // back off: spinning warps load L2 for everyone
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

// B8, replaces _make_sharded_packed_kernel (pallas_sweep.py:289): one
// zero-inflow sub-step over packed rows, one thread block a tile, the
// tiles' carries chained by decoupled look-back. `status` holds rows x T
// zeroed words, then the zeroed tile counter.
template <int KIND>
__global__ void __launch_bounds__(kSegThreads)
    sharded_substep_kernel(const float* __restrict__ coef,
                           const float* __restrict__ ce,
                           const float* __restrict__ cp,
                           const float* __restrict__ ch,
                           const float* __restrict__ hp,
                           const float* __restrict__ hh,
                           const float* __restrict__ e0g,
                           const float* __restrict__ e1g,
                           const float* __restrict__ p0g,
                           const float* __restrict__ p1g,
                           const float* __restrict__ h0g,
                           const float* __restrict__ h1g,
                           float* __restrict__ o0g, float* __restrict__ o1g,
                           int N, int T, unsigned long long* status) {
  __shared__ SegShared sm;
  __shared__ int ticket;
  __shared__ float tile_in, tile_a, tile_b;
  if (threadIdx.x == 0)
    ticket = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status + gridDim.x), 1u));
  __syncthreads();
  // Tickets run tile-major across the rows, so the tiles in flight spread
  // over every row and each row's nearest inclusive prefix lies a few
  // tiles back; tile t - 1 of a row still takes a smaller ticket than t.
  const int rows = gridDim.x / T;
  const int t = ticket / rows;
  const int row = ticket - t * rows;
  const int tile = blockDim.x * kCells;
  const int t0 = t * tile;
  const int j0 = t0 + threadIdx.x * kCells;
  const size_t base = static_cast<size_t>(row) * N;
  const Corr kcp = load_corr(cp + 4 * row), kch = load_corr(ch + 4 * row);
  const CorrLoad<KIND> load{e0g + base,
                            e1g + base,
                            p0g + base,
                            p1g + base,
                            h0g + base,
                            h1g + base,
                            load_corr(ce + 4 * row),
                            kcp,
                            kch,
                            N};
  float x0[kCells], x1[kCells], p0[kCells], p1[kCells], q0[kCells],
      q1[kCells];
  load(j0, x0, x1, p0, p1, q0, q1);
  // The upwind p1/h1 values of the tile's first cell; thread 0 writes and
  // alone reads them (in upwind_value).
  if (threadIdx.x == 0) {
    sm.carry[0] = 0.f;
    if constexpr (KIND != kBE)
      sm.etail[0] = t0 ? corrected_at(p1g + base, kcp, t0 - 1) : hp[row];
    if constexpr (KIND == kBDF)
      sm.htail[0] = t0 ? corrected_at(h1g + base, kch, t0 - 1) : hh[row];
  }
  const Coef kc = load_coef(coef + row * kNCoef);
  float r0[kCells], r1[kCells], b[kCells], A, B;
  if constexpr (KIND == kBE) {
    substep_rhs<kBE>(kc, x0, x1, x0, x1, x0, x1, 0.f, 0.f, r0, r1, b, A, B);
  } else if constexpr (KIND == kCN) {
    const float p1_up = upwind_value(p1[kCells - 1], sm.etail, sm.edge_p);
    substep_rhs<kCN>(kc, x0, x1, x0, p1, x0, x1, p1_up, 0.f, r0, r1, b, A,
                     B);
  } else {
    const float p1_up = upwind_value(p1[kCells - 1], sm.etail, sm.edge_p);
    const float h1_up = upwind_value(q1[kCells - 1], sm.htail, sm.edge_h);
    substep_rhs<kBDF>(kc, x0, x1, p0, p1, q0, q1, p1_up, h1_up, r0, r1, b,
                      A, B);
  }
  // The block scan from a zero carry (sm.carry[0]).
  int buf = 0;
  float exA, exB;
  block_exclusive_scan(A, B, sm.carry, sm, buf, exA, exB);
  unsigned long long* st = status + static_cast<size_t>(row) * T;
  if (threadIdx.x == blockDim.x - 1) {
    // B_t: the carry leaving the tile from a zero carry in; a^tile.
    float agg = exB;
#pragma unroll
    for (int c = 0; c < kCells; ++c) agg = kc.a * agg + b[c];
    tile_a = exA * A;
    tile_b = agg;
    if (t + 1 < T) publish(st + t, t ? kAggregate : kInclusive, agg);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const float c_in = t ? look_back(st, t, tile_a) : 0.f;
    if (threadIdx.x == 0) {
      if (t && t + 1 < T) publish(st + t, kInclusive, tile_a * c_in + tile_b);
      tile_in = c_in;
    }
  }
  __syncthreads();
  float f0[kCells], f1[kCells];
  substep_out(kc, r0, r1, b, exA * tile_in + exB, sm.carry, -1, f0, f1);
  store_cells(o0g + base, j0, N, f0);
  store_cells(o1g + base, j0, N, f1);
}

}  // namespace

extern "C" {

// B8's launch shape for rows of N cells at most max_threads threads a
// block: out = (threads a block, tiles a row); the scratch the wrapper
// passes holds rows * tiles + 1 words.
int rt_sharded_geometry(int N, int max_threads, int* out) {
  const int threads = pick_threads(N, kCells, max_threads);
  out[0] = threads;
  out[1] = (N + threads * kCells - 1) / (threads * kCells);
  return 0;
}

// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// Planes are contiguous packed (rows, N) float32: BE reads e0, e1; CN also
// p1; BDF all six (unread pointers may alias any plane). coef (rows, 10);
// ce, cp, ch the (rows, 4) pending corrections of e, p and h (unread ones
// may alias ce); hp, hh the (rows, 1) upwind p1 and h1 halo columns (read
// by CN/BDF and BDF); status a scratch of rows * tiles + 1 8-byte words
// (rt_sharded_geometry at the same max_threads), zeroed here before the
// launch.
int rt_sharded_substep(int kind, const float* coef, const float* ce,
                       const float* cp, const float* ch, const float* hp,
                       const float* hh, const float* e0, const float* e1,
                       const float* p0, const float* p1, const float* h0,
                       const float* h1, float* o0, float* o1,
                       unsigned long long* status, int rows, int N,
                       int max_threads, void* stream) {
  if (rows < 2 || rows % 2 || N < 1 || kind < kBE || kind > kBDF ||
      max_threads < 32 || max_threads > kSegThreads || max_threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int geo[2];
  rt_sharded_geometry(N, max_threads, geo);
  const int threads = geo[0], T = geo[1];
  const int grid = rows * T;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, (static_cast<size_t>(grid) + 1) * sizeof(*status), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == kBE)
    sharded_substep_kernel<kBE><<<grid, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N, T,
        status);
  else if (kind == kCN)
    sharded_substep_kernel<kCN><<<grid, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N, T,
        status);
  else
    sharded_substep_kernel<kBDF><<<grid, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N, T,
        status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
