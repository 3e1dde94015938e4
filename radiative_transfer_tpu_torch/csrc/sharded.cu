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
// Design. B3's row walk (substep_segment, segments.cuh): one thread block a
// packed row loops over the shard's cells in tiles of blockDim*8 cells with
// the carry and tails in shared memory, the tile scan exact; the only
// difference from B3 is the load hook below and the row's starting carry
// and tails. CUDA blocks run in no order; the inter-tile carry is the
// in-order tile loop inside one block, as in B1-B5.

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

// B8, replaces _make_sharded_packed_kernel (pallas_sweep.py:289): one
// zero-inflow sub-step over packed rows, one thread block a row.
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
                           int N) {
  __shared__ SegShared sm;
  const int row = blockIdx.x;
  if (threadIdx.x == 0) {
    sm.carry[0] = 0.f;
    sm.etail[0] = KIND == kBE ? 0.f : hp[row];
    sm.htail[0] = KIND == kBDF ? hh[row] : 0.f;
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(row) * N;
  const CorrLoad<KIND> load{e0g + base,
                            e1g + base,
                            p0g + base,
                            p1g + base,
                            h0g + base,
                            h1g + base,
                            load_corr(ce + 4 * row),
                            load_corr(cp + 4 * row),
                            load_corr(ch + 4 * row),
                            N};
  int buf = 0;
  substep_segment<KIND>(load_coef(coef + row * kNCoef), load, o0g + base,
                        o1g + base, N, sm, buf);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// Planes are contiguous packed (rows, N) float32: BE reads e0, e1; CN also
// p1; BDF all six (unread pointers may alias any plane). coef (rows, 10);
// ce, cp, ch the (rows, 4) pending corrections of e, p and h (unread ones
// may alias ce); hp, hh the (rows, 1) upwind p1 and h1 halo columns (read
// by CN/BDF and BDF).
int rt_sharded_substep(int kind, const float* coef, const float* ce,
                       const float* cp, const float* ch, const float* hp,
                       const float* hh, const float* e0, const float* e1,
                       const float* p0, const float* p1, const float* h0,
                       const float* h1, float* o0, float* o1, int rows, int N,
                       void* stream) {
  if (rows < 2 || rows % 2 || N < 1 || kind < kBE || kind > kBDF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = pick_threads(N, kCells, kSegThreads);
  if (kind == kBE)
    sharded_substep_kernel<kBE><<<rows, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N);
  else if (kind == kCN)
    sharded_substep_kernel<kCN><<<rows, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N);
  else
    sharded_substep_kernel<kBDF><<<rows, threads, 0, st>>>(
        coef, ce, cp, ch, hp, hh, e0, e1, p0, p1, h0, h1, o0, o1, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
