// Hand-written Hopper (sm_90a) double-float kernels for the f64-grade sweep.
//
// Replaces the Pallas TPU kernel factories of
// radiative_transfer_tpu/ops/df_sweep.py:
//   rt_df_bdf2      <- _make_df_bdf2_kernel      (K whole double-float BDF2
//                                                 steps a launch; B6)
//   rt_df_multistep <- _make_df_multistep_kernel (K whole double-float BE
//                                                 or CN steps; B7)
//   rt_df_halo_bdf2 <- _make_df_halo_bdf2_kernel (seeded K-step BDF2, packed
//                                                 rows, for the df halo
//                                                 engine; B14)
//   rt_df_halo_multistep <- _make_df_halo_multistep_kernel (seeded K-step
//                                                 BE or CN, packed rows; B15)
// All run on one __device__ sub-step routine, df_substep (the counterpart
// of _df_substep), and the row-tile machinery of tiles.cuh (block-wide scan,
// upwind exchange, cell loads and stores). Every kernel here runs its rows'
// tiles as a cluster wavefront on cluster.cuh's mailboxes (which sweep.cu's
// B1, B2, B4 and B5 and adjoint.cu's B10-B12 share): B6 and B14 on
// df_bdf2_wave, B7 and B15 on df_multistep_wave, one slot a step. No
// kernel of this file walks a row on one block any more.
//
// What is computed. A value is an unevaluated sum hi + lo of two float32
// numbers; the planes come in (hi, lo) pairs. Each sub-step of each row is
// iterative refinement in four stages (ops/cuda_df.py module doc):
//   1. capture the exact double-float right-hand side (r, r_err) from the
//      state planes and the double-float coefficients;
//   2. BASE: csrc/sweep.cu's float32 solve (b-build, the scan of
//      carry_j = a*carry_{j-1} + b_j, 2x2 reconstruct) into o0, o1;
//   3. RESIDUAL: rho = r_true - A*(o0, o1), from the base OUTPUTS alone,
//      with error-free products and two_sum cascades;
//   4. CORRECT: a second float32 scan solve of A*delta = rho, with its own
//      carry, and out = two_sum(o, delta).
// The kernels compute what the TPU kernels compute: float32 planes,
// error-free transforms and two float32 scans. No double is used.
//
// Design.
// * A row is cut into tiles of blockDim*kCells cells, and every tile runs
//   all K steps (times 4 phases for BDF2) before it leaves the tile: the
//   tiles and slots (4K for BDF2, K for BE or CN) of the one-block walk
//   this file's kernels ran before, now a wavefront over a thread block
//   cluster (df_bdf2_wave, df_multistep_wave below): tile t of a chain (B7:
//   of a row; B15: of a packed row) on block t mod C, each slot's state
//   handed to the next tile's block through distributed shared memory.
//   Shared memory carries, per (step, phase) slot, the base carry, the
//   correction carry and the upwind base o1 edge (the residual's coupling to
//   the upwind tile), plus the inflow's lo part for the first tile; per step,
//   the upwind (hi, lo) edges of the p1 and h1 history planes. Each is read
//   only where a barrier separates the read from the write it needs and from
//   the next tile's overwrite.
// * At the row start every slot holds the true double-float inflow: the
//   boundary value, or for the mu>0 half of a reflective slab the flipped
//   mu<0 CORRECTED outflow two_sum(base o1 edge, correction carry) of the
//   same slot, which the mu<0 launch records as a (hi, lo) pair per slot.
//   The history fills of the first cell (CN's and BDF's shifted p1 and h1)
//   are that inflow; the base carry starts at its hi part and any
//   difference lands in the residual.
// * FMA contraction. nvcc contracts a*b + c into an FMA by default, which
//   would corrupt every error-free transform that consumes a product. The
//   capture, the residual, the last product of the correction solve and
//   every two_sum are written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc
//   never contracts, and the split is an integer mask. The base solve and
//   the correction scan may contract freely: the residual is computed from
//   the base outputs, so it is exact for whatever they are.
// * The scans are exact over each tile (the plain versions truncate to
//   npass/npass_c Hillis-Steele passes), and both solves scan in the
//   g = 1 - a form (KindCoef), where the plain versions keep JAX's float32
//   multiplier a. The residual absorbs every rounding of the base solve,
//   but the solves' shared multiplier bias survives one refinement as its
//   square: the plain versions carry it, some 1e-11 of the state on long
//   rows of thin groups, the kernels not. So kernel and plain version agree
//   to the plain version's own distance from float64, not bit for bit.
// * Cells past N in the last (ragged) tile load as 0 and are never stored;
//   they lie downstream of every real cell.
// * The halo kernels (B14, B15) take both direction halves as 2*Bh packed
//   rows in one launch, mu<0 rows first, with no reflective coupling inside
//   (parallel/df_halo_cuda.py runs a fixup launch for it). Each row is two
//   chains, as in sweep.cu's B4-B5: cells [0, reset_cell) from zero slots,
//   then [reset_cell, X) from the per-(row, slot) (hi, lo) seeds: base carry
//   and upwind o1 edge at the seed's hi part, the inflow's lo part at its lo
//   part, a zero correction carry and zero history tails (no s-multiplier
//   fold: the residual corrects the base's plain inflow). Each segment is
//   tiled from its own start, so `first` is the segment's first tile. B14
//   runs each chain on a cluster of its own; B15 runs both on the row's one
//   cluster as one sequence of tiles (cluster.cuh HaloChains), the seeded
//   chain's first tile taking its mail before it reseeds. Every row
//   records its corrected outflow two_sum(base o1 edge, correction carry)
//   per slot.
//   The scans are exact, so a zero seed's error past the halo decays as
//   a^H instead of stopping at the JAX engine's creep bound.
// * Registers: each thread holds kCells = 4 cells (sweep.cu holds 8): the
//   (hi, lo) planes of the state, the half snapshot, a phase's input and
//   output, and the right-hand side with its error terms are live at once.
//   The coefficients (30 floats a kind) live in shared memory.
//
// What bounds it on this card: each chain's handoffs and tile-phases. A
// BDF2 cell-step is ~1016 float32 operations here against the float32
// kernel's 124 (capture, residual, second scan; counted in chip_smoke.py),
// most of them __f*_rn that cannot fuse. On an H100 at the bench shape a
// 2048-cell tile-phase took ~4.1 us when one block walked a row (its ~254
// operations a cell need ~2.1 us of the SM's 128 float32 lanes at 1.98
// GHz; the rest is barriers and latency), and only 2*Bh blocks ran (Bh at
// a time for a reflective boundary). The wavefront puts C blocks on each
// chain, so a chain's critical path is ~T handoffs of one tile-phase each
// plus the last tile's remaining slots (4K - 1 for B6 and B14, K - 1 for
// B7 and B15), not T * slots tile-phases, and a block runs T * slots / C
// tile-phases; B14's longest chain (the seeded one past the halo) binds its
// launch, B15's chain is a packed row's T_h + T_m tiles. Device-memory
// traffic is 4 planes read and 12 (B6, B14) or 8 (B7, B15) written per
// K-step launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"

namespace {

constexpr int kNDF = 20;           // df pack: (lo, hh, hl) x 6, S0h, S0l
constexpr int kCells = 4;          // consecutive cells per thread
constexpr int kMaxThreads = 512;
constexpr int kMaxSlots = 256;     // 4*K phase slots, K <= 64
constexpr int kMaxSteps = kMaxSlots / 4;

// Rounded float32 operations that nvcc never contracts into an FMA.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// Knuth two-sum: s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = add(a, b);
  const float bb = sub(s, a);
  e = add(sub(a, sub(s, bb)), sub(b, bb));
}

// Bitmask split: x == h + l exactly, h the top 12 significant bits.
__device__ __forceinline__ void split(float x, float& h, float& l) {
  h = __int_as_float(__float_as_int(x) & -4096);
  l = sub(x, h);
}

// A double-float constant hi + lo with hi == hh + hl (host Veltkamp split).
struct DFConst {
  float hi, lo, hh, hl;
};

// x*y == p + prod_err for p = fl(x*y), given the splits of x and y.
__device__ __forceinline__ float prod_err(float p, float xh, float xl,
                                          float yh, float yl) {
  return add(add(add(sub(mul(xh, yh), p), mul(xh, yl)), mul(xl, yh)),
             mul(xl, yl));
}

// Captured product (_cap): p = fl(c.hi*v) and e with p + e ~= c*v to
// ~2^-48 relative; the second form adds v's lo part.
__device__ __forceinline__ void cap(const DFConst& c, float v, float& p,
                                    float& e) {
  float vh, vl;
  split(v, vh, vl);
  p = mul(c.hi, v);
  e = add(prod_err(p, c.hh, c.hl, vh, vl), mul(c.lo, v));
}
__device__ __forceinline__ void cap(const DFConst& c, float v, float vlo,
                                    float& p, float& e) {
  cap(c, v, p, e);
  e = add(e, mul(c.hi, vlo));
}

// One sub-step kind's coefficients: the base solve's float32 values and the
// double-float constants of the capture and residual (hi parts are the
// float32 values). g = 1 - a is the scans' multiplier as its distance from
// 1: a = 2q^2 / (T0^2 + q^2), so 1 - a = (T0 - q)(T0 + q) * idet, with
// T0 - q from the double-float T0 and q (where a ~ 1 the hi parts'
// difference is exact and the lo parts give the rest). The float32 a lies
// up to half an ulp from the true one, a relative error in 1 - a of
// ~6e-8 * a / (1 - a); as the multiplier it biases both solves alike, and
// one refinement leaves the square of that bias (some 1e-11 of the state
// where 1/(1 - a) ~ 100, thin groups on long rows). g is good to a few ulps
// of itself, so the scans below carry maps x -> (1 - G)*x + B.
struct KindCoef {
  float w, T0, q, idet, g;
  DFConst dT0, dq, dw, dkee, dkp, dc1;
  float S0h, S0l;                  // S0 = Sbase + c0
};

__device__ __forceinline__ void load_kind(KindCoef& k,
                                          const float* __restrict__ c,
                                          const float* __restrict__ d) {
  k.w = c[0];
  k.T0 = c[1];
  k.q = c[2];
  k.idet = c[3];
  k.g = mul(mul(add(sub(c[1], c[2]), sub(d[0], d[3])), add(c[1], c[2])),
            c[3]);
  // Columns of the df pack, in _DF_ORDER: T0 q w kee kp c1.
  auto dfc = [d](int n, float hi) {
    return DFConst{hi, d[3 * n], d[3 * n + 1], d[3 * n + 2]};
  };
  k.dT0 = dfc(0, c[1]);
  k.dq = dfc(1, c[2]);
  k.dw = dfc(2, c[0]);
  k.dkee = dfc(3, c[8]);
  k.dkp = dfc(4, c[9]);
  k.dc1 = dfc(5, c[6]);
  k.S0h = d[18];
  k.S0l = d[19];
}

struct Shared {
  KindCoef kc[3];              // BE, CN, BDF (B7: its one kind first)
  float carry[kMaxSlots];      // per-(step, phase) base carry into the tile
  float ccarry[kMaxSlots];     // per-(step, phase) correction carry
  float oth[kMaxSlots];        // upwind base o1 edge (the inflow at row start)
  float otl[kMaxSlots];        // the inflow's lo part, read in a chain's
                               // first tile only
  float eth[kMaxSteps];        // per-step upwind p1 edge (hi, lo)
  float etl[kMaxSteps];
  float hth[kMaxSteps];        // per-step upwind h1 edge (hi, lo)
  float htl[kMaxSteps];
  float scanA[2][32];          // cross-warp scan, double-buffered
  float scanB[2][32];
  float edge_h[32];            // last cell of each warp, pair exchange
  float edge_l[32];
  float edge_o[32];            // last base o1 of each warp
};

// The (hi, lo) planes of a cell-edge pair (x0, x1) over a thread's cells.
struct Pair4 {
  float h0[kCells], l0[kCells], h1[kCells], l1[kCells];
};

// Plane pointers: 4 inputs (e0 hi, lo, e1 hi, lo), then the outputs in
// groups of 4 of the same order: ends, (B6) half, prev.
struct Planes {
  const float* in[4];
  float* out[12];
};

struct Packs {
  const float* c[3];           // f32 packs (2, Bh, kNCoef)
  const float* d[3];           // df packs (2, Bh, kNDF)
};

__device__ __forceinline__ void load_pair(Pair4& x, const Planes& g,
                                          size_t base, int j0, int N) {
  load_cells(x.h0, g.in[0] + base, j0, N);
  load_cells(x.l0, g.in[1] + base, j0, N);
  load_cells(x.h1, g.in[2] + base, j0, N);
  load_cells(x.l1, g.in[3] + base, j0, N);
}

// Stores x into the outputs first .. first+3.
__device__ __forceinline__ void store_pair(const Planes& g, int first,
                                           size_t base, int j0, int N,
                                           const Pair4& x) {
  store_cells(g.out[first] + base, j0, N, x.h0);
  store_cells(g.out[first + 1] + base, j0, N, x.l0);
  store_cells(g.out[first + 2] + base, j0, N, x.h1);
  store_cells(g.out[first + 3] + base, j0, N, x.l1);
}

// The (hi, lo) value at the cell upwind of this thread's first cell: the
// previous thread's last cell, or the previous tile's (*tail_h, *tail_l)
// for thread 0, read after the barrier.
__device__ __forceinline__ void upwind_pair(float my_h, float my_l,
                                            const float* tail_h,
                                            const float* tail_l, Shared& sm,
                                            float& up_h, float& up_l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  up_h = __shfl_up_sync(kFull, my_h, 1);
  up_l = __shfl_up_sync(kFull, my_l, 1);
  if (lane == 31) {
    sm.edge_h[warp] = my_h;
    sm.edge_l[warp] = my_l;
  }
  __syncthreads();
  if (lane == 0) {
    up_h = warp ? sm.edge_h[warp - 1] : *tail_h;
    up_l = warp ? sm.edge_l[warp - 1] : *tail_l;
  }
}

// One double-float sub-step of kind KIND over this thread's cells of the
// tile (_df_substep). e: the sub-step's input; p/hp: the prev and half
// history planes (CN reads p, BDF both); pu/hu: the (hi, lo) p1/h1 values
// upwind of the thread's first cell. `first`: the chain's first tile (the
// row's, or a halo row's at reset_cell), where thread 0's history fills are
// the slot's inflow. Slot s's carries and
// upwind o1 edge are read and then replaced by this tile's; `owner` is the
// index among this thread's cells of the tile's last real cell, or -1.
template <int KIND>
__device__ __forceinline__ void df_substep(
    const KindCoef& k, bool use_corr, const Pair4& e, const Pair4& p,
    const Pair4& hp, float pu_h, float pu_l, float hu_h, float hu_l, int s,
    bool first, int owner, Shared& sm, int& buf, Pair4& o) {
  // The slot's double-float inflow, read in the chain's first tile only,
  // where the last barrier of init_row or seed_row orders it after the slot's
  // initialisation (or, in B15's reseeding tile, thread 0 wrote it itself
  // in take_step), and the owner's write of oth[s] in this sub-step follows
  // barriers that thread 0 reaches after this read. In a later tile no
  // barrier need lie between here and the previous tile owner's write of
  // oth[s], and the inflow's lo part is nonzero only at the chain start.
  float ofl = 0.f;
  if (first && threadIdx.x == 0) {
    ofl = sm.otl[s];
    if constexpr (KIND != kBE) {
      pu_h = sm.oth[s];
      pu_l = ofl;
    }
    if constexpr (KIND == kBDF) {
      hu_h = sm.oth[s];
      hu_l = ofl;
    }
  }

  // -- 1. right-hand side with capture ---------------------------------------
  float r0[kCells], r0e[kCells], r1[kCells], r1e[kCells], b[kCells];
  float G = 0.f, B = 0.f;  // this thread's map x -> (1 - G)*x + B
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    float S, Se;
    if (use_corr) {
      float tpsi, epsi, pc, epc, eS;
      two_sum(e.h0[c], e.h1[c], tpsi, epsi);
      const float psi = mul(0.5f, tpsi);
      const float psil = mul(0.5f, add(epsi, add(e.l0[c], e.l1[c])));
      cap(k.dc1, psi, psil, pc, epc);
      two_sum(k.S0h, pc, S, eS);
      Se = add(eS, add(k.S0l, epc));
    } else {
      S = k.S0h;
      Se = k.S0l;
    }
    if constexpr (KIND == kBE) {
      float m0, em0, m1, em1, ea, eb;
      cap(k.dkee, e.h0[c], e.l0[c], m0, em0);
      cap(k.dkee, e.h1[c], e.l1[c], m1, em1);
      two_sum(S, m0, r0[c], ea);
      r0e[c] = add(add(Se, em0), ea);
      two_sum(S, m1, r1[c], eb);
      r1e[c] = add(add(Se, em1), eb);
    } else if constexpr (KIND == kCN) {
      const float psh = c ? p.h1[c - 1] : pu_h;
      const float psl = c ? p.l1[c - 1] : pu_l;
      float m0, em0, m1, em1, m2, em2, t1, t2, ea, eb, ec;
      cap(k.dkee, e.h0[c], e.l0[c], m0, em0);
      cap(k.dq, e.h1[c], e.l1[c], m1, em1);
      cap(k.dw, psh, psl, m2, em2);
      two_sum(S, m0, t1, ea);
      two_sum(t1, -m1, t2, eb);
      two_sum(t2, m2, r0[c], ec);
      r0e[c] = add(sub(add(Se, em0), em1), add(em2, add(add(ea, eb), ec)));
      float m3, em3, m4, em4, t3, ed, ee;
      cap(k.dq, e.h0[c], e.l0[c], m3, em3);
      cap(k.dkee, e.h1[c], e.l1[c], m4, em4);
      two_sum(S, m3, t3, ed);
      two_sum(t3, m4, r1[c], ee);
      r1e[c] = add(add(Se, em3), add(em4, add(ed, ee)));
    } else {
      const float psh = c ? p.h1[c - 1] : pu_h;
      const float psl = c ? p.l1[c - 1] : pu_l;
      const float hsh = c ? hp.h1[c - 1] : hu_h;
      const float hsl = c ? hp.l1[c - 1] : hu_l;
      float n1, en1, n2, en2, n3, en3, n4, en4, n5, en5, n6, en6;
      cap(k.dkee, hp.h0[c], hp.l0[c], n1, en1);
      cap(k.dw, hp.h1[c], hp.l1[c], n2, en2);
      cap(k.dkp, p.h0[c], p.l0[c], n3, en3);
      cap(k.dq, p.h1[c], p.l1[c], n4, en4);
      cap(k.dw, hsh, hsl, n5, en5);
      cap(k.dw, psh, psl, n6, en6);
      float t1, t2, t3, t4, t5, ea, eb, ec, ed, ee, ef;
      two_sum(S, n1, t1, ea);
      two_sum(t1, mul(-2.f, n2), t2, eb);
      two_sum(t2, -n3, t3, ec);
      two_sum(t3, -n4, t4, ed);
      two_sum(t4, mul(4.f, n5), t5, ee);
      two_sum(t5, n6, r0[c], ef);
      r0e[c] = add(
          sub(sub(add(Se, en1), add(mul(2.f, en2), en3)), en4),
          add(add(mul(4.f, en5), en6),
              add(add(add(ea, eb), add(ec, ed)), add(ee, ef))));
      float n7, en7, n8, en8, n9, en9, n10, en10;
      cap(k.dw, hp.h0[c], hp.l0[c], n7, en7);
      cap(k.dkee, hp.h1[c], hp.l1[c], n8, en8);
      cap(k.dq, p.h0[c], p.l0[c], n9, en9);
      cap(k.dkp, p.h1[c], p.l1[c], n10, en10);
      float u1, u2, u3, eg, eh, ei, ej;
      two_sum(S, mul(2.f, n7), u1, eg);
      two_sum(u1, n8, u2, eh);
      two_sum(u2, n9, u3, ei);
      two_sum(u3, -n10, r1[c], ej);
      r1e[c] = add(sub(add(add(Se, mul(2.f, en7)), add(en8, en9)), en10),
                   add(add(eg, eh), add(ei, ej)));
    }
    b[c] = (k.q * r0[c] + k.T0 * r1[c]) * k.idet;
    B = b[c] + (B - k.g * B);
    G = k.g + (G - k.g * G);
  }

  // -- 2. base: float32 scan and reconstruct ---------------------------------
  float exG, exB;
  const float c_in =
      block_exclusive_scan<true>(G, B, &sm.carry[s], sm, buf, exG, exB);
  float cur = exB + (c_in - exG * c_in);  // carry entering the thread's cells
  float o0[kCells], o1[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const float u = r0[c] + k.w * cur;
    o0[c] = (k.T0 * u - k.q * r1[c]) * k.idet;
    o1[c] = (k.q * u + k.T0 * r1[c]) * k.idet;
    cur = b[c] + (cur - k.g * cur);
    if (c == owner) sm.carry[s] = cur;
  }

  // -- 3. output-based residual ----------------------------------------------
  // The upwind base o1: the previous cell's, or the slot's edge for thread 0
  // (the previous tile's last o1, or the double-float inflow with its lo
  // part at the row start).
  const float o1u = upwind_value(o1[kCells - 1], &sm.oth[s], sm.edge_o);
  const float o1u_l = ofl;  // 0 past the row's first tile and thread 0
  float rho0[kCells], rho1[kCells];
  G = 0.f;
  B = 0.f;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const float o1r = c ? o1[c - 1] : o1u;
    const float o1rl = c ? 0.f : o1u_l;
    float pT0, eT0, pQ1, eQ1, pW, eW, t, x1, x2, x3;
    cap(k.dT0, o0[c], pT0, eT0);
    cap(k.dq, o1[c], pQ1, eQ1);
    cap(k.dw, o1r, o1rl, pW, eW);
    two_sum(r0[c], -pT0, t, x1);
    two_sum(t, -pQ1, t, x2);
    two_sum(t, pW, t, x3);
    rho0[c] = add(t, add(add(add(x1, x2), x3),
                         add(sub(r0e[c], add(eT0, eQ1)), eW)));
    float pQ0, eQ0, pT1, eT1, y1, y2;
    cap(k.dq, o0[c], pQ0, eQ0);
    cap(k.dT0, o1[c], pT1, eT1);
    two_sum(r1[c], pQ0, t, y1);
    two_sum(t, -pT1, t, y2);
    rho1[c] = add(t, add(add(y1, y2), sub(add(r1e[c], eQ0), eT1)));
    b[c] = (k.q * rho0[c] + k.T0 * rho1[c]) * k.idet;
    B = b[c] + (B - k.g * B);
    G = k.g + (G - k.g * G);
  }

  // -- 4. correction scan, reconstruct and renormalise -----------------------
  const float cc_in =
      block_exclusive_scan<true>(G, B, &sm.ccarry[s], sm, buf, exG, exB);
  cur = exB + (cc_in - exG * cc_in);
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const float u = rho0[c] + k.w * cur;
    // The last products are rounded on their own: two_sum must see them.
    const float d0 = mul(k.T0 * u - k.q * rho1[c], k.idet);
    const float d1 = mul(k.q * u + k.T0 * rho1[c], k.idet);
    cur = b[c] + (cur - k.g * cur);
    if (c == owner) {
      // The next tile's residual couples against the BASE o1 edge.
      sm.ccarry[s] = cur;
      sm.oth[s] = o1[c];
    }
    two_sum(o0[c], d0, o.h0[c], o.l0[c]);
    two_sum(o1[c], d1, o.h1[c], o.l1[c]);
  }
}

// Slots entering a row (_half_init): every (step, phase) slot's base carry
// and upwind o1 edge at the (hi, lo) inflow, a zero correction carry, and
// zero history tails; the row's coefficients into shared memory.
// Row r's coefficients of the first nkinds kinds into shared memory; a
// barrier must follow before any read.
__device__ __forceinline__ void load_kinds(Shared& sm, int nkinds,
                                           const Packs& pk, int r) {
  if (threadIdx.x < nkinds)
    load_kind(sm.kc[threadIdx.x], pk.c[threadIdx.x] + r * kNCoef,
              pk.d[threadIdx.x] + r * kNDF);
}

__device__ __forceinline__ void init_row(Shared& sm, int slots, int steps,
                                         int nkinds, const Packs& pk,
                                         const float* __restrict__ bc,
                                         const float* __restrict__ bcl,
                                         const int* __restrict__ flip,
                                         const float* rec, int h, int row,
                                         int hr, int reflective) {
  load_kinds(sm, nkinds, pk, hr);
  const bool coupled = h == 1 && reflective;
  const float* r = coupled ? rec + 2 * slots * flip[row] : nullptr;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float vh = coupled ? r[i] : bc[hr];
    const float vl = coupled ? r[slots + i] : bcl[hr];
    sm.carry[i] = vh;
    sm.ccarry[i] = 0.f;
    sm.oth[i] = vh;
    sm.otl[i] = vl;
  }
  for (int i = threadIdx.x; i < steps; i += blockDim.x) {
    sm.eth[i] = sm.etl[i] = 0.f;
    sm.hth[i] = sm.htl[i] = 0.f;
  }
  __syncthreads();
}

// Starts a chain (the reset block of _make_df_halo_*_kernel): every slot's
// base carry and upwind o1 edge at the seed's hi part, the inflow's lo part
// at its lo part (0 where the seeds are null), a zero correction carry and
// zero history tails. The first barrier orders this after every access of
// the previous chain's slots and tails (the owner's last carry and edge
// writes, the tail thread's tail writes, the first tile's inflow reads);
// the second orders it before the new chain's first reads.
__device__ __forceinline__ void seed_row(Shared& sm, int slots, int steps,
                                         const float* __restrict__ sh,
                                         const float* __restrict__ sl) {
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float vh = sh ? sh[i] : 0.f;
    sm.carry[i] = vh;
    sm.ccarry[i] = 0.f;
    sm.oth[i] = vh;
    sm.otl[i] = sl ? sl[i] : 0.f;
  }
  for (int i = threadIdx.x; i < steps; i += blockDim.x) {
    sm.eth[i] = sm.etl[i] = 0.f;
    sm.hth[i] = sm.htl[i] = 0.f;
  }
  __syncthreads();
}

// Writes each slot's corrected outflow, two_sum(base o1 edge, correction
// carry), after the row's last cell: hi parts to rh[slot], lo to rl[slot].
__device__ __forceinline__ void write_record(const Shared& sm, int slots,
                                             float* rh, float* rl) {
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += blockDim.x)
    two_sum(sm.oth[i], sm.ccarry[i], rh[i], rl[i]);
}

// The mu<0 half of a reflective slab records its corrected outflow per
// slot as rec[row] = (hi[slots], lo[slots]).
__device__ __forceinline__ void record_row(const Shared& sm, int slots,
                                           float* rec, int h, int row,
                                           int reflective) {
  if (!(h == 0 && reflective)) return;
  float* r = rec + 2 * slots * row;
  write_record(sm, slots, r, r + slots);
}

// -- B6's and B14's wavefront: a chain's tiles across a thread block cluster
//
// Slot s of tile t needs only slot s of tile t-1 (the base carry, the
// correction carry and the upwind base o1 edge that df_substep reads and
// rewrites; with slot 4k step k's upwind p1 edge, with slot 4k+1 its upwind
// h1 edge) and slot s-1 of tile t itself. So the C blocks of a chain's
// cluster (B6: a row; B14: one of a packed row's two chains) run tiles
// t = rank, rank + C, ... through all 4K slots each, and
// tile t can run slot s while tile t+1 runs slot s-1. Each block holds, per
// slot, a mailbox and an mbarrier (one arrival a phase). Before slot s of
// tile t > 0 thread 0 waits on the barrier (acquire, cluster scope) and
// copies the mailbox into the slot's shared state, and the block runs
// df_substep unchanged. After it, the thread that owns the tile's last cell
// (the tile is full: only the chain's last tile is ragged, and it sends
// nothing) writes the slot's new state into the mailbox of block (t+1) mod
// C through the cluster's shared window and arrives on that block's barrier
// (release, cluster scope).
//
// Why no "mailbox free" signal is needed and one parity bit a block serves
// every slot: cluster.cuh (the argument holds for any mail and any number
// of slots a tile).

// B6's mail per slot: the base carry, the correction carry, the upwind base
// o1 edge, and the tail the slot carries (slot 4k: step k's p1 edge; slot
// 4k+1: its h1 edge; (hi, lo) each).
constexpr int kCarry = 0, kCCarry = 1, kOth = 2, kTh = 3, kTl = 4;
using DFMailbox = Mailbox<5, kMaxSlots>;

// Tile t > 0 takes slot s's state from its mailbox: thread 0 waits, then
// copies. No barrier follows here: every other thread first reads the
// slot's state after the next block barrier (upwind_pair's before slots 4k
// and 4k+2, the base scan's first inside df_substep otherwise), and the
// copy overwrites state last read C tiles ago.
__device__ __forceinline__ void receive(Shared& sm, DFMailbox& mb, int s,
                                        uint32_t parity) {
  if (threadIdx.x == 0) {
    const float* m = wait_mail(mb, s, parity);
    sm.carry[s] = m[kCarry];
    sm.ccarry[s] = m[kCCarry];
    sm.oth[s] = m[kOth];
    if (s % 4 == 0) {
      sm.eth[s / 4] = m[kTh];
      sm.etl[s / 4] = m[kTl];
    } else if (s % 4 == 1) {
      sm.hth[s / 4] = m[kTh];
      sm.htl[s / 4] = m[kTl];
    }
  }
}

// Slot s's new state, by the thread that wrote it in df_substep (the owner
// of the full tile's last cell), into block `next`'s mailbox; (th, tl) is
// the tail the slot carries (0 where it carries none).
__device__ __forceinline__ void send(const Shared& sm, DFMailbox& mb, int s,
                                     uint32_t next, float th, float tl) {
  const float m[5] = {sm.carry[s], sm.ccarry[s], sm.oth[s], th, tl};
  send_mail(mb, s, next, m);
}

// K whole double-float BDF2 steps, each BE(dt/2), CN(dt/2), BE(dt/2) and
// the BDF corrector, over the cells [s0, s1) of the row at plane offset
// `base` (one chain), as this block's share of the chain's wavefront over
// (tile, slot): the chain's tiles from s0 on the C blocks of the cluster,
// tile t on block `rank` = t mod C. The slots and tails in shared memory
// start as init_row or seed_row left them (they serve the chain's first
// tile; the mailboxes, opened before, bring every later tile's). The half
// snapshot is the CN output where snap_cn, else the phase-0 BE output.
// Returns whether this block ran the chain's last tile, whose slots then
// hold the chain's outflow (a block of no tile runs nothing).
__device__ __forceinline__ bool df_bdf2_wave(const Planes& g, size_t base,
                                             int s0, int s1, int K,
                                             bool snap_cn, bool use_corr,
                                             Shared& sm, DFMailbox& mb,
                                             int C, int rank) {
  const int tile = blockDim.x * kCells;
  const int T = (s1 - s0 + tile - 1) / tile;
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = s0 + t * tile;
    const int j0 = t0 + threadIdx.x * kCells;
    const int owner = tile_owner(t0, j0, tile, s1, kCells);
    const bool first = t == 0;
    const bool sender = t + 1 < T && owner >= 0;
    Pair4 x, hs;
    load_pair(x, g, base, j0, s1);
    for (int k = 0; k < K; ++k) {
      const int s = 4 * k;
      if (!first) receive(sm, mb, s, parity);
      // prev = the step's input; its upwind p1 edge feeds CN and BDF.
      float xu_h, xu_l;
      upwind_pair(x.h1[kCells - 1], x.l1[kCells - 1], &sm.eth[k], &sm.etl[k],
                  sm, xu_h, xu_l);
      Pair4 b, c;
      df_substep<kBE>(sm.kc[0], use_corr, x, x, x, 0.f, 0.f, 0.f, 0.f, s,
                      first, owner, sm, buf, b);
      if (sender)
        send(sm, mb, s, next, x.h1[kCells - 1], x.l1[kCells - 1]);
      if (!first) receive(sm, mb, s + 1, parity);
      df_substep<kCN>(sm.kc[1], use_corr, b, x, x, xu_h, xu_l, 0.f, 0.f, s + 1,
                      first, owner, sm, buf, c);
      hs = snap_cn ? c : b;
      if (sender)
        send(sm, mb, s + 1, next, hs.h1[kCells - 1], hs.l1[kCells - 1]);
      if (!first) receive(sm, mb, s + 2, parity);
      float hu_h, hu_l;
      upwind_pair(hs.h1[kCells - 1], hs.l1[kCells - 1], &sm.hth[k],
                  &sm.htl[k], sm, hu_h, hu_l);
      Pair4 d, f;
      df_substep<kBE>(sm.kc[0], use_corr, c, x, x, 0.f, 0.f, 0.f, 0.f, s + 2,
                      first, owner, sm, buf, d);
      if (sender) send(sm, mb, s + 2, next, 0.f, 0.f);
      if (!first) receive(sm, mb, s + 3, parity);
      df_substep<kBDF>(sm.kc[2], use_corr, d, x, hs, xu_h, xu_l, hu_h, hu_l,
                       s + 3, first, owner, sm, buf, f);
      if (sender) send(sm, mb, s + 3, next, 0.f, 0.f);
      // prev of the final state = the LAST step's input.
      if (k == K - 1) store_pair(g, 8, base, j0, s1, x);
      x = f;
    }
    store_pair(g, 0, base, j0, s1, x);
    store_pair(g, 4, base, j0, s1, hs);
    if (!first) parity ^= 1u;
  }
  return T > 0 && rank == (T - 1) % C;
}

// -- B7's and B15's wavefront: a row's tiles, one slot a step --------------
//
// The tiles and slots (slot k: step k) of the one-block walk B7 and B15 ran
// before, as a wavefront, as df_bdf2_wave is to one block walking B6's row.
// Slot k of tile t needs only slot k of tile t-1 and slot k-1 of tile t, so
// tile t runs slot k while tile t+1 runs slot k-1. The mail per slot is the
// base carry, the correction carry, the upwind base o1 edge and, under CN,
// step k's p1 edge (hi, lo): DFMailbox's fields, one slot a step.
using DFStepMailbox = Mailbox<5, kMaxSteps>;

// Tile t > 0 takes slot k's state from its mailbox: thread 0 waits, then
// copies (receive's argument holds: every other thread first reads the
// slot's state after the next block barrier, upwind_pair's under CN, the
// base scan's first inside df_substep under BE). Where (sh, sl) are given
// (the seeded chain's first tile of a halo row) thread 0 waits all the
// same, discards the mail and sets the slot as seed_row would from the
// seed: base carry and upwind o1 edge at sh[k], the inflow's lo part at
// sl[k], a zero correction carry and zero p1 tails. That tile runs
// df_substep with `first` set, which reads the slot's inflow (oth[k],
// otl[k]) in thread 0 only, before any barrier: the thread that has just
// written it, so no barrier is needed; no other thread reads oth[k] or
// otl[k] (upwind_value hands oth[k] to thread 0 alone), and the owner's
// rewrite of oth[k] comes after the sub-step's scans' barriers, which
// thread 0 reaches after its reads.
template <bool kTail>
__device__ __forceinline__ void take_step(Shared& sm, DFStepMailbox& mb,
                                          int k, uint32_t parity,
                                          const float* sh, const float* sl) {
  if (threadIdx.x != 0) return;
  // The seed's loads are issued before the wait and land during it.
  const float vh = sh ? sh[k] : 0.f, vl = sh ? sl[k] : 0.f;
  const float* m = wait_mail(mb, k, parity);
  if (sh) {
    sm.carry[k] = vh;
    sm.ccarry[k] = 0.f;
    sm.oth[k] = vh;
    sm.otl[k] = vl;
    sm.eth[k] = sm.etl[k] = 0.f;
    return;
  }
  sm.carry[k] = m[kCarry];
  sm.ccarry[k] = m[kCCarry];
  sm.oth[k] = m[kOth];
  if (kTail) {
    sm.eth[k] = m[kTh];
    sm.etl[k] = m[kTl];
  }
}

// K whole double-float BE or CN steps over the N cells of the row at plane
// offset `base`, as this block's share of the row's wavefront: tiles rank,
// rank + C, ... of the cluster's C blocks, laid out by `chains` (B7:
// OneChain, one chain from cell 0; B15: HaloChains, the halo chain from
// zero and then the seeded chain, whose first tile takes its mail and
// reseeds from (seeds_h, seeds_l)). The slots and tails in shared memory
// start as init_row (B7) or seed_row (B15) left them: they serve tile 0
// only, whose sub-steps read the slot's (hi, lo) inflow as `first`; every
// later tile takes its slot's state from its mail (take_step), the
// reseeding tile from the seeds. Every tile but the row's last sends its
// mail, the halo chain's
// last (ragged or not) too; a ragged tile's p1 tail is its owner's last
// cell, past the chain's end, and the reseeding tile discards it. Returns
// whether this block ran the row's last tile, whose slots then hold the
// row's outflow; prev = each step's input.
template <int KIND, class Chains>
__device__ __forceinline__ bool df_multistep_wave(
    const Planes& g, size_t base, int N, int K, bool use_corr, Shared& sm,
    DFStepMailbox& mb, int C, int rank, const Chains& chains,
    const float* seeds_h, const float* seeds_l) {
  constexpr bool kTail = KIND == kCN;
  const int tile = blockDim.x * kCells;
  const int T = chains.tiles(N, tile);
  const uint32_t next = (rank + 1) % C;
  int buf = 0;
  uint32_t parity = 0;
  for (int t = rank; t < T; t += C) {
    const int t0 = chains.start(t, tile);
    const int s1 = chains.end(t, N);
    const int j0 = t0 + threadIdx.x * kCells;
    const int owner = tile_owner(t0, j0, tile, s1, kCells);
    const bool waits = t > 0;
    const bool first = chains.first(t);
    const bool reseed = chains.reseeds(t);
    const bool sender = t + 1 < T && owner >= 0;
    Pair4 x;
    load_pair(x, g, base, j0, s1);
    for (int k = 0; k < K; ++k) {
      if (waits)
        take_step<kTail>(sm, mb, k, parity, reseed ? seeds_h : nullptr,
                         seeds_l);
      float xu_h = 0.f, xu_l = 0.f;
      if constexpr (kTail)
        upwind_pair(x.h1[kCells - 1], x.l1[kCells - 1], &sm.eth[k],
                    &sm.etl[k], sm, xu_h, xu_l);
      Pair4 f;
      df_substep<KIND>(sm.kc[0], use_corr, x, x, x, xu_h, xu_l, 0.f, 0.f, k,
                       first, owner, sm, buf, f);
      if (sender) {
        const float m[5] = {sm.carry[k], sm.ccarry[k], sm.oth[k],
                            x.h1[kCells - 1], x.l1[kCells - 1]};
        send_mail(mb, k, next, m, kTail ? 5 : 3);
      }
      if (k == K - 1) store_pair(g, 4, base, j0, s1, x);
      x = f;
    }
    store_pair(g, 0, base, j0, s1, x);
    if (waits) parity ^= 1u;
  }
  return T > 0 && rank == (T - 1) % C;
}

// B6, replaces _make_df_bdf2_kernel (df_sweep.py:372): K whole double-float
// BDF2 steps as a wavefront over (tile, slot) (df_bdf2_wave, which B14
// shares): the cluster of C blocks at blockIdx.x / C owns one row, block
// rank r its tiles r, r + C, ... The tiles, slots and arithmetic are those
// of one block walking the row; only who runs a tile and how a slot's state
// reaches the next tile differ.
__global__ void __launch_bounds__(kMaxThreads)
    df_bdf2_kernel(Packs pk, const float* __restrict__ bc,
                   const float* __restrict__ bcl,
                   const int* __restrict__ flip, float* rec, Planes g, int Bh,
                   int N, int K, int symmetric, int reflective, int use_corr,
                   int half0) {
  __shared__ Shared sm;
  __shared__ DFMailbox mb;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cr = blockIdx.x / C;
  const int row = cr % Bh;
  const int h = half0 + cr / Bh;
  const int hr = h * Bh + row;
  const int slots = 4 * K;
  open_mailboxes(mb, slots);
  // Kinds and tails on every block; the slots' inflow serves tile 0 only.
  init_row(sm, slots, K, 3, pk, bc, bcl, flip, rec, h, row, hr, reflective);
  // The half snapshot is the CN output for mu<0 and the phase-0 BE output
  // for mu>0 (reference quirk, solver.cpp:733 vs 784-787) unless symmetric.
  // The block that ran the row's last tile holds the outflow slots.
  if (df_bdf2_wave(g, static_cast<size_t>(hr) * N, 0, N, K,
                   symmetric || h == 0, use_corr, sm, mb, C, rank))
    record_row(sm, slots, rec, h, row, reflective);
  close_mailboxes();
}

// B7, replaces _make_df_multistep_kernel (df_sweep.py:475): K whole
// double-float BE or CN steps, prev = each step's input, as a wavefront
// over (tile, slot), one slot a step (df_multistep_wave under OneChain,
// which B15 runs under HaloChains): the cluster of C blocks at blockIdx.x /
// C owns one row, block rank r its tiles r, r + C, ... The tiles, slots and
// arithmetic are those of the one-block walk this kernel ran before; only
// who runs a tile and how a slot's state reaches the next tile differ. The
// mu<0 half of a reflective slab records its corrected outflow from the
// block that ran the row's last tile; the mu>0 half, launched after it,
// reads that record as its tile 0's inflow.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    df_multistep_kernel(Packs pk, const float* __restrict__ bc,
                        const float* __restrict__ bcl,
                        const int* __restrict__ flip, float* rec, Planes g,
                        int Bh, int N, int K, int reflective, int use_corr,
                        int half0) {
  __shared__ Shared sm;
  __shared__ DFStepMailbox mb;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cr = blockIdx.x / C;
  const int row = cr % Bh;
  const int h = half0 + cr / Bh;
  const int hr = h * Bh + row;
  open_mailboxes(mb, K);
  // Kind and tails on every block; the slots' inflow serves tile 0 only.
  init_row(sm, K, K, 1, pk, bc, bcl, flip, rec, h, row, hr, reflective);
  if (df_multistep_wave<KIND>(g, static_cast<size_t>(hr) * N, N, K,
                              use_corr, sm, mb, C, rank, OneChain(), nullptr,
                              nullptr))
    record_row(sm, K, rec, h, row, reflective);
  close_mailboxes();
}

// B14, replaces _make_df_halo_bdf2_kernel (df_sweep.py:640): K whole seeded
// double-float BDF2 steps over packed rows (mu<0 rows first), each row's two
// chains as wavefronts (df_bdf2_wave, B6's), one cluster a chain: clusters
// [0, rows) run the seeded chains [reset_cell, X), which end the rows and
// record their outflow; clusters [rows, 2*rows), present when reset_cell >
// 0, the chains [0, reset_cell) from zero slots. A chain never hands state
// to the other, so each cluster's mail runs along one unbroken chain of
// tiles, which cluster.cuh's protocol needs (a seeded tile mid-chain that
// waits on no mail could overwrite its successor's unread mailbox; B15
// keeps one cluster a row instead by taking the mail first). Blocks
// beyond a short chain's tiles open and close their mailboxes only. Seeds
// and the record are (rows, 4K); rec holds the hi parts, then the lo parts.
__global__ void __launch_bounds__(kMaxThreads)
    df_halo_bdf2_kernel(Packs pk, const float* __restrict__ seeds_h,
                        const float* __restrict__ seeds_l, float* rec,
                        Planes g, int rows, int X, int K, int reset_cell,
                        int symmetric, int use_corr) {
  __shared__ Shared sm;
  __shared__ DFMailbox mb;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cr = blockIdx.x / C;
  const bool seeded = cr < rows;
  const int row = seeded ? cr : cr - rows;
  const int slots = 4 * K;
  const size_t sd = static_cast<size_t>(row) * slots;
  open_mailboxes(mb, slots);
  load_kinds(sm, 3, pk, row);
  seed_row(sm, slots, K, seeded ? seeds_h + sd : nullptr,
           seeded ? seeds_l + sd : nullptr);
  // The per-row blend of the half snapshot: both halves share the launch.
  const bool last = df_bdf2_wave(
      g, static_cast<size_t>(row) * X, seeded ? reset_cell : 0,
      seeded ? X : reset_cell, K, symmetric || row < rows / 2, use_corr, sm,
      mb, C, rank);
  if (seeded && last)
    write_record(sm, slots, rec + sd,
                 rec + static_cast<size_t>(rows) * slots + sd);
  close_mailboxes();
}

// B15, replaces _make_df_halo_multistep_kernel (df_sweep.py:541): K whole
// seeded double-float BE or CN steps over packed rows (mu<0 rows first),
// each row a wavefront over (tile, slot) on a cluster of C blocks
// (df_multistep_wave): the row's halo chain [0, reset_cell) from zero slots
// and its seeded chain [reset_cell, X) run as ONE sequence of tiles
// (cluster.cuh HaloChains), the seeded chain's first tile taking each
// slot's mail before it starts from the (hi, lo) seeds (take-and-reseed),
// so the halo chain costs the launch no cluster. With reset_cell 0 the row
// is one chain from the seeds. Seeds and the record are (rows, K); rec
// holds the hi parts, then the lo parts, written by the block that ran the
// row's last tile.
template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
    df_halo_multistep_kernel(Packs pk, const float* __restrict__ seeds_h,
                             const float* __restrict__ seeds_l, float* rec,
                             Planes g, int rows, int X, int K,
                             int reset_cell, int use_corr) {
  __shared__ Shared sm;
  __shared__ DFStepMailbox mb;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const size_t sd = static_cast<size_t>(row) * K;
  open_mailboxes(mb, K);
  load_kinds(sm, 1, pk, row);
  // Kind and tails on every block; the slots' inflow (zero before a halo
  // chain, else the seeds) serves tile 0 only.
  const bool halo = reset_cell > 0;
  seed_row(sm, K, K, halo ? nullptr : seeds_h + sd,
           halo ? nullptr : seeds_l + sd);
  if (df_multistep_wave<KIND>(g, static_cast<size_t>(row) * X, X, K,
                              use_corr, sm, mb, C, rank,
                              HaloChains(reset_cell, blockDim.x * kCells),
                              seeds_h + sd, seeds_l + sd))
    write_record(sm, K, rec + sd, rec + static_cast<size_t>(rows) * K + sd);
  close_mailboxes();
}

Planes unpack_planes(void* const* planes, int nout) {
  Planes g{};
  for (int i = 0; i < 4; ++i) g.in[i] = static_cast<const float*>(planes[i]);
  for (int i = 0; i < nout; ++i) g.out[i] = static_cast<float*>(planes[4 + i]);
  return g;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success). Planes are contiguous (2, Bh, N)
// float32, passed as an array of pointers: e0 hi, e0 lo, e1 hi, e1 lo, then
// the outputs (ends, B6's half, prev; each e0 hi, e0 lo, e1 hi, e1 lo).
// Coefficients are (2, Bh, 10) and (2, Bh, 20) float32, bc and bcl (2, Bh,
// 1) float32, flip (Bh,) int32, rec a (Bh, 2, slots) float32 scratch record.

// B6's launch shape for rows of N cells at K steps, at most max_threads
// threads a block and max_cluster blocks a row, `clusters` rows a launch
// (Bh for a reflective boundary, else 2*Bh): out = (threads a block, blocks
// a row (the cluster), tiles a row).
int rt_df_bdf2_geometry(int N, int K, int max_threads, int max_cluster,
                        int clusters, int* out) {
  const int threads = pick_threads(N, kCells, max_threads);
  const int tiles = (N + threads * kCells - 1) / (threads * kCells);
  out[0] = threads;
  out[1] = wave_cluster(tiles, 4 * K, threads, max_cluster, clusters,
                        {reinterpret_cast<const void*>(&df_bdf2_kernel)});
  out[2] = tiles;
  return 0;
}

int rt_df_bdf2(const float* cbe, const float* ccn, const float* cbdf,
               const float* dbe, const float* dcn, const float* dbdf,
               const float* bc, const float* bcl, const int* flip, float* rec,
               void* const* planes, int Bh, int N, int K, int symmetric,
               int reflective, int use_corr, int max_threads,
               int max_cluster, void* stream) {
  if (K < 1 || K > kMaxSteps || Bh < 1 || N < 1 || max_threads < 32 ||
      max_threads > kMaxThreads || max_threads % 32 || max_cluster < 1 ||
      max_cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Packs pk{{cbe, ccn, cbdf}, {dbe, dcn, dbdf}};
  const Planes g = unpack_planes(planes, 12);
  int geo[3];
  rt_df_bdf2_geometry(N, K, max_threads, max_cluster,
                      reflective ? Bh : 2 * Bh, geo);
  const int threads = geo[0], C = geo[1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A refused cluster launch returns its error, and the second half is
  // not launched.
  return launch_halves_ex(Bh, reflective, [&](int grid, int half0) {
    return launch_clusters(df_bdf2_kernel, grid, C, threads, st, pk, bc, bcl,
                           flip, rec, g, Bh, N, K, symmetric, reflective,
                           use_corr, half0);
  });
}

// B7's launch shape for rows of N cells at K steps, at most max_threads
// threads a block and max_cluster blocks a row, `clusters` rows a launch
// (Bh for a reflective boundary, else 2*Bh): out = (threads a block, blocks
// a row (the cluster), tiles a row). One slot a step.
int rt_df_multistep_geometry(int N, int K, int max_threads, int max_cluster,
                             int clusters, int* out) {
  if (K < 1 || K > kMaxSteps || N < 1 || clusters < 1 || max_threads < 32 ||
      max_threads > kMaxThreads || max_threads % 32 || max_cluster < 1 ||
      max_cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = pick_threads(N, kCells, max_threads);
  const int tiles = (N + threads * kCells - 1) / (threads * kCells);
  out[0] = threads;
  out[1] = wave_cluster(
      tiles, K, threads, max_cluster, clusters,
      {reinterpret_cast<const void*>(&df_multistep_kernel<kBE>),
       reinterpret_cast<const void*>(&df_multistep_kernel<kCN>)});
  out[2] = tiles;
  return 0;
}

// max_threads and max_cluster as rt_df_multistep_geometry's.
int rt_df_multistep(int kind, const float* coef, const float* dcoef,
                    const float* bc, const float* bcl, const int* flip,
                    float* rec, void* const* planes, int Bh, int N, int K,
                    int reflective, int use_corr, int max_threads,
                    int max_cluster, void* stream) {
  if (Bh < 1 || (kind != kBE && kind != kCN))
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  const int bad = rt_df_multistep_geometry(N, K, max_threads, max_cluster,
                                           reflective ? Bh : 2 * Bh, geo);
  if (bad) return bad;
  const Packs pk{{coef, nullptr, nullptr}, {dcoef, nullptr, nullptr}};
  const Planes g = unpack_planes(planes, 8);
  const int threads = geo[0], C = geo[1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A refused cluster launch returns its error, and the second half is
  // not launched.
  return launch_halves_ex(Bh, reflective, [&](int grid, int half0) {
    return launch_clusters(
        kind == kBE ? &df_multistep_kernel<kBE> : &df_multistep_kernel<kCN>,
        grid, C, threads, st, pk, bc, bcl, flip, rec, g, Bh, N, K,
        reflective, use_corr, half0);
  });
}

// The halo kernels take packed (rows, X) planes, rows = 2*Bh with the mu<0
// rows first, coefficients (rows, 10) and (rows, 20), seeds hi and lo (rows,
// slots), rec a (2, rows, slots) record (hi parts, then lo parts), and the
// cell reset_cell in [0, X) where the seeded chain starts.

// B14's launch shape for packed rows of X cells at K steps with the seeded
// chains from reset_cell, at most max_threads threads a block and
// max_cluster blocks a chain, `rows` packed rows: out = (threads a block,
// blocks a chain (the cluster), tiles of the seeded chain, tiles of the
// chain from zero (0 where reset_cell is 0)). The launch runs one cluster a
// chain: rows clusters, or 2*rows where reset_cell > 0.
int rt_df_halo_bdf2_geometry(int X, int K, int reset_cell, int max_threads,
                             int max_cluster, int rows, int* out) {
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
      main_tiles > halo_tiles ? main_tiles : halo_tiles, 4 * K, threads,
      max_cluster, reset_cell > 0 ? 2 * rows : rows,
      {reinterpret_cast<const void*>(&df_halo_bdf2_kernel)});
  out[2] = main_tiles;
  out[3] = halo_tiles;
  return 0;
}

// max_threads and max_cluster as rt_df_halo_bdf2_geometry's.
int rt_df_halo_bdf2(const float* cbe, const float* ccn, const float* cbdf,
                    const float* dbe, const float* dcn, const float* dbdf,
                    const float* seeds_h, const float* seeds_l, float* rec,
                    void* const* planes, int rows, int X, int K,
                    int reset_cell, int symmetric, int use_corr,
                    int max_threads, int max_cluster, void* stream) {
  int geo[4];
  const int bad = rt_df_halo_bdf2_geometry(X, K, reset_cell, max_threads,
                                           max_cluster, rows, geo);
  if (bad) return bad;
  const Packs pk{{cbe, ccn, cbdf}, {dbe, dcn, dbdf}};
  // A refused cluster launch returns its error.
  return static_cast<int>(launch_clusters(
      df_halo_bdf2_kernel, reset_cell > 0 ? 2 * rows : rows, geo[1], geo[0],
      static_cast<cudaStream_t>(stream), pk, seeds_h, seeds_l, rec,
      unpack_planes(planes, 12), rows, X, K, reset_cell, symmetric,
      use_corr));
}

// B15's launch shape for `rows` packed rows of X cells at K steps with the
// seeded chains from reset_cell, at most max_threads threads a block and
// max_cluster blocks a row: out = (threads a block, blocks a row (the
// cluster), tiles of the seeded chain [reset_cell, X), tiles of the halo
// chain [0, reset_cell)). One cluster a row runs both chains.
int rt_df_halo_multistep_geometry(int X, int K, int reset_cell,
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
  out[1] = wave_cluster(
      main_tiles + halo_tiles, K, threads, max_cluster, rows,
      {reinterpret_cast<const void*>(&df_halo_multistep_kernel<kBE>),
       reinterpret_cast<const void*>(&df_halo_multistep_kernel<kCN>)});
  out[2] = main_tiles;
  out[3] = halo_tiles;
  return 0;
}

// max_threads and max_cluster as rt_df_halo_multistep_geometry's.
int rt_df_halo_multistep(int kind, const float* coef, const float* dcoef,
                         const float* seeds_h, const float* seeds_l,
                         float* rec, void* const* planes, int rows, int X,
                         int K, int reset_cell, int use_corr, int max_threads,
                         int max_cluster, void* stream) {
  if (kind != kBE && kind != kCN)
    return static_cast<int>(cudaErrorInvalidValue);
  int geo[4];
  const int bad = rt_df_halo_multistep_geometry(
      X, K, reset_cell, max_threads, max_cluster, rows, geo);
  if (bad) return bad;
  const Packs pk{{coef, nullptr, nullptr}, {dcoef, nullptr, nullptr}};
  const Planes g = unpack_planes(planes, 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A refused cluster launch returns its error.
  return static_cast<int>(launch_clusters(
      kind == kBE ? &df_halo_multistep_kernel<kBE>
                  : &df_halo_multistep_kernel<kCN>,
      rows, geo[1], geo[0], st, pk, seeds_h, seeds_l, rec, g, rows, X, K,
      reset_cell, use_corr));
}

}  // extern "C"
