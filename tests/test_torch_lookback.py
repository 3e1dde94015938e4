"""A protocol model of the look-back scan of B3, B9 and B13, on the CPU.

The CUDA kernels (csrc/sweep.cu substep_kernel, csrc/adjoint.cu
fwd_record_kernel, csrc/fused.cu fused_step_kernel, on csrc/lookback.cuh)
run only on the card (chip_smoke.py phases 3, 9 and 12 hold them against
their plain versions there). These tests hold the design's protocol and
arithmetic in plain Python and numpy, in float64:

* Every block of a launch is a generator that runs one tile of a row as
  the kernel does: per slot the right-hand sides from the tile's inputs,
  its own earlier slots' outputs and its predecessor's edges, the tile's
  zero-start scan, (AGGREGATE, B_t) published (tile 0: INCLUSIVE from the
  row's inflow at once), a look-back over the row's earlier tiles that
  stops at the nearest INCLUSIVE word, (INCLUSIVE, a^n * carry_in + B_t)
  published, every cell reconstructed from its entering carry; edge words
  written after the slot whose last-cell output they hold, reaching a
  reader at a random later step (nothing orders them before the writer's
  later status words), and read only once written. Tickets go out in order to at most R resident blocks (a
  block takes its ticket only while running); a seeded scheduler steps a
  random runnable block, so the slots complete in random orders the
  protocol admits. A state in which no resident block can move is a
  deadlock and fails. Every word goes 0 -> AGGREGATE -> INCLUSIVE (tile 0:
  0 -> INCLUSIVE) and every edge word is written once.
* B9: BE, CN and BDF2, both half modes, reflective (one launch, every
  mu<0 ticket before every mu>0 one; a mu>0 row's tile 0 waits on the
  flipped mu<0 row's last INCLUSIVE word) and source left. The planes and
  the records (at the record tiles: rtile a multiple of the look-back
  tile, the block starting one writes it) against ``fwd_record_launch_ref``
  evaluated in float64 with exact block scans (npass = log2(blk)), within
  1e-12 (the records at the plain version's blocks that start the model's
  record tiles).
* B13: the step and ``materialize_only``, both half modes; the planes and
  the (rows, 6) record (written by the block of the row's last tile)
  against ``fused_step_launch_ref`` likewise.
* B3: one slot, BE, CN and BDF, reflective (tickets as B9's) and source
  left; a tile's upwind p1/h1 edges are the input planes' values at cell
  t0 - 1 (0 at a half's start). The planes against ``substep_launch_ref``
  in float64 with exact block scans, within 1e-12.
* Shapes: a ragged last tile, a row below one tile, whole tiles, and a row
  of more than 32 tiles (beyond one warp's window of the look-back).
* Mutants that must fail: a successor that reads its predecessor's edge
  word without waiting for it to be written; a reflective launch whose
  tickets run tile-major across both halves (a mu>0 ticket before mu<0
  ones), which deadlocks once the waiting mu>0 blocks fill the residency
  (B9 and B3); a B3 mu>0 row start that peeks the flipped row's outflow
  word without waiting and takes 0 while it is unwritten.

No JAX program is compiled here.
"""

import os
import random
from collections import deque

import numpy as np
import pytest
import torch

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca
from radiative_transfer_tpu_torch.ops import cuda_fused as cf
from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN
from radiative_transfer_tpu_torch.parallel.sharded_cuda import (
    ShardedCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
AGG, INCL = 1, 2
BAR = 1e-12
L = 32              # the look-back tile (cells)
RTILE = 64          # the record tile, two look-back tiles
BLK = 16            # the plain version's block: divides N and RTILE
# Rows of N cells: 6 whole tiles and a ragged 16-cell one; 16 cells (below
# one tile); 6 whole tiles; 40 tiles, a look-back beyond one warp's window.
SHAPES = {"ragged": 208, "below-one-tile": 16, "whole-tiles": 192,
          "40-tiles": 40 * L}


class Deadlock(AssertionError):
    pass


class Launch:
    """The launch's device memory: status words and edge words. An edge
    word is stored with release and nothing orders the writer's later
    relaxed status words behind it, so it reaches a reader at a random
    later step: its delivery is a task of its own in the scheduler."""

    def __init__(self):
        self.words = {}
        self.edges = {}
        self.deliveries = []

    def publish(self, key, flag, value, t, full):
        old = self.words.get(key, (0, 0.0))[0]
        allowed = {AGG: (0,), INCL: (AGG,) if t and full else (0,)}[flag]
        assert old in allowed, f"word {key}: {old} -> {flag}"
        self.words[key] = (flag, value)

    def written(self, key):
        return lambda: key in self.words

    def publish_edge(self, key, value):
        def deliver():
            assert key not in self.edges, f"edge {key} written twice"
            self.edges[key] = value
            yield None
        self.deliveries.append([deliver(), None])


def run(blocks, resident, rng, mem):
    """Hands the blocks (generators, in ticket order) to at most `resident`
    running blocks and steps a random runnable one, or an edge word's
    delivery, until all finish. A block yields a predicate it waits on
    (None: none)."""
    pending = deque(blocks)
    running = []
    while pending or running or mem.deliveries:
        while pending and len(running) < resident:
            running.append([pending.popleft(), None])
        ready = [b for b in running if b[1] is None or b[1]()]
        if not ready and not mem.deliveries:
            raise Deadlock(f"{len(running)} resident blocks all wait, "
                           f"{len(pending)} tickets not handed out")
        b = rng.choice(ready + mem.deliveries)
        try:
            b[1] = next(b[0])
        except StopIteration:
            (running if b in running else mem.deliveries).remove(b)


def coef_row(c):
    """A row's packed coefficients as floats, by name."""
    names = ("w", "T0", "q", "idet", "a", "Sb", "c1", "c0", "kee", "kp")
    return dict(zip(names, (float(x) for x in c)))


def linear(k):
    return dict(k, Sb=0.0, c0=0.0)


def rhs(kind, k, e0, e1, p0, p1, h0, h1, p1_up, h1_up):
    """tiles.cuh rhs and b over a tile's real cells."""
    psi = 0.5 * (e0 + e1)
    S = k["Sb"] + k["c1"] * psi + k["c0"]
    sp = np.concatenate([[p1_up], p1[:-1]])
    sh = np.concatenate([[h1_up], h1[:-1]])
    if kind == BE:
        r0, r1 = S + k["kee"] * e0, S + k["kee"] * e1
    elif kind == CN:
        r0 = S + k["kee"] * e0 - k["q"] * e1 + k["w"] * sp
        r1 = S + k["q"] * e0 + k["kee"] * e1
    else:
        r0 = (S + k["kee"] * h0 - 2.0 * k["w"] * h1 - k["kp"] * p0
              - k["q"] * p1 + k["w"] * (4.0 * sh + sp))
        r1 = S + 2.0 * k["w"] * h0 + k["kee"] * h1 + k["q"] * p0 - k["kp"] * p1
    return r0, r1, (k["q"] * r0 + k["T0"] * r1) * k["idet"]


def look_back(mem, key_of, t, a_tile):
    """The carry entering tile t > 0: the row's earlier tiles' words, nearest
    first, each waited on until written, summed with weights a_tile^d until
    the nearest INCLUSIVE one."""
    acc, mult = 0.0, 1.0
    j = t - 1
    while True:
        yield mem.written(key_of(j))
        flag, val = mem.words[key_of(j)]
        acc += mult * val
        if flag == INCL:
            return acc
        mult *= a_tile
        j -= 1


def slot(mem, key_of, t, T, kind, k, planes, p1_up, h1_up, inflow):
    """One slot of tile t of T (lookback.cuh lb_substep): returns (o0, o1,
    carry in, carry out). The row's last tile publishes no aggregate and
    its INCLUSIVE word after the reconstruction."""
    r0, r1, b = rhs(kind, k, *planes, p1_up, h1_up)
    a = k["a"]
    zs = np.empty_like(b)          # zero-start carry entering each cell
    c = 0.0
    for m in range(len(b)):
        zs[m] = c
        c = a * c + b[m]
    full = t + 1 < T
    if t and full:
        mem.publish(key_of(t), AGG, c, t, full)
        yield None
    if t:
        c_in = yield from look_back(mem, key_of, t, a ** L)
    else:
        c_in = yield from inflow()
    c_out = a ** len(b) * c_in + c
    if full:
        mem.publish(key_of(t), INCL, c_out, t, full)
        yield None
    cur = a ** np.arange(len(b)) * c_in + zs
    u = r0 + k["w"] * cur
    if not full:
        mem.publish(key_of(t), INCL, c_out, t, full)
    return ((k["T0"] * u - k["q"] * r1) * k["idet"],
            (k["q"] * u + k["T0"] * r1) * k["idet"], c_in, c_out)


def edge_of(mem, key, mutant):
    """Thread 0's read of the predecessor's edge word: waited on, or with
    the mutant read at once (an unwritten word reads 0)."""
    if not mutant:
        yield lambda: key in mem.edges
    return mem.edges.get(key, 0.0)


def const(v):
    def gen():
        return v
        yield  # noqa: unreachable; makes this a generator
    return gen


def _nerr(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / (scale if scale > 0 else 1.0))


def tile_major(block, Bh, T, reflective, mutant_tickets):
    """The blocks (h, row, t) in ticket order (csrc/lookback.cuh lb_tile):
    tile-major across a group's rows, the mu<0 half's rows a group of their
    own for a reflective boundary (the mutant: one group of both halves)."""
    group = 2 * Bh if (mutant_tickets or not reflective) else Bh
    blocks = []
    for g in range(2 * Bh // group):
        for t in range(T):
            for r in range(group):
                hr = g * group + r
                blocks.append(block(hr // Bh, hr % Bh, t))
    return blocks


# -- B9 ----------------------------------------------------------------------

def b9_blocks(mem, x, out, ts, kc, bc, flip, s_of, reflective, symmetric,
              N, mutant_edge=False, mutant_tickets=False):
    """The launch's blocks in ticket order (csrc/adjoint.cu
    fwd_record_kernel; tile_major)."""
    e0, e1 = x
    Bh = e0.shape[1]
    T = -(-N // L)

    def block(h, row, t):
        t0, t1 = t * L, min((t + 1) * L, N)
        x0, x1 = e0[h, row, t0:t1], e1[h, row, t0:t1]
        kbe, kcn, kbdf = (coef_row(c[h, row]) for c in kc)
        recorder = t0 % RTILE == 0
        rt = t0 // RTILE
        et = e1[h, row, t0 - 1] if t0 else 0.0

        def run_slot(p, kind, k, planes, p1_up, h1_up):
            o0, o1, c_in, _ = yield from slot(
                mem, lambda j: ("s", p, h, row, j), t, T, kind, k, planes,
                p1_up, h1_up, inflow(p))
            if recorder:
                out["rc"][h, p, row, rt] = c_in
            return o0, o1

        def inflow(p):
            def gen():
                if h == 1 and reflective:
                    k_ = ("s", p, 0, flip[row], T - 1)
                    yield lambda: mem.words.get(k_, (0,))[0] == INCL
                    return s_of[p] * mem.words[k_][1]
                return s_of[p] * bc[h, row]
                yield  # noqa: unreachable
            return gen

        if recorder:
            out["ret"][h, row, rt] = et
        if ts == 3:
            b0, b1 = yield from run_slot(0, BE, kbe, (x0, x1) * 3, 0.0, 0.0)
            c0, c1 = yield from run_slot(1, CN, kcn, (b0, b1) + (x0, x1) * 2,
                                         et, 0.0)
            snap = symmetric or h == 0
            hs0, hs1 = (c0, c1) if snap else (b0, b1)
            if t + 1 < T:
                mem.publish_edge(("hs1", h, row, t), hs1[-1])
            d0, d1 = yield from run_slot(2, BE, kbe, (c0, c1, x0, x1, hs0,
                                                      hs1), 0.0, 0.0)
            ht = 0.0
            if t:
                ht = yield from edge_of(mem, ("hs1", h, row, t - 1),
                                        mutant_edge)
            if recorder:
                out["rht"][h, row, rt] = ht
            f0, f1 = yield from run_slot(3, BDF, kbdf, (d0, d1, x0, x1, hs0,
                                                        hs1), et, ht)
            out["h0"][h, row, t0:t1], out["h1"][h, row, t0:t1] = hs0, hs1
        else:
            kind, k = (BE, kbe) if ts == 1 else (CN, kcn)
            if recorder:
                out["rht"][h, row, rt] = 0.0
            f0, f1 = yield from run_slot(0, kind, k, (x0, x1) * 3,
                                         et if kind == CN else 0.0, 0.0)
        out["o0"][h, row, t0:t1], out["o1"][h, row, t0:t1] = f0, f1

    return tile_major(block, Bh, T, reflective, mutant_tickets)


@pytest.fixture(scope="module")
def b9_engines():
    """The gray deck at M = 4 (Bh = 2), optically thin (X = 0.002) and off
    equilibrium, per (ts_method, reflective, symmetric, N), on the CPU."""
    cache = {}

    def get(ts, refl, sym, N):
        key = (ts, refl, sym, N)
        if key not in cache:
            cfg = port.load_config(GRAY, M=4, N=N, X=0.002, ts_method=ts,
                                   bc_left_indicator=2 if refl else 1,
                                   bdf2_symmetric_half=sym,
                                   psi_source=((6.0,),) * 4)
            tables, _, _ = port_transport.build_tables(cfg)
            cache[key] = cs.CudaSweepEngine(cfg, tables, block=BLK,
                                            device="cpu")
        return cache[key]
    return get


def b9_case(eng, seed):
    """Seeded inputs and the plain version's float64 outputs at exact
    scans."""
    rng = np.random.default_rng(seed)
    z = torch.zeros((2, eng.Bh, cs._NCOEF), dtype=torch.float64)
    co = [eng.coef[k].double() if k in eng.coef else z for k in (BE, CN, BDF)]
    base = eng.init_state().e0.double().numpy()
    x = [base * rng.uniform(0.5, 1.5, base.shape) for _ in range(2)]
    geo = ca.step_geometry(eng)
    full = int(np.log2(BLK))
    geo["npass"] = {k: full for k in (BE, CN, BDF)}
    ref = ca.fwd_record_launch_ref(*co, eng.bc.double(), eng.flip,
                                   *map(torch.as_tensor, x), **geo)
    return co, x, geo, [r.numpy() for r in ref]


def b9_model(eng, co, x, geo, seed, resident, **mutant):
    ts, N = geo["ts_method"], x[0].shape[-1]
    Bh = eng.Bh
    nph = 4 if ts == 3 else 1
    nrt = -(-N // RTILE)
    out = {"o0": np.zeros_like(x[0]), "o1": np.zeros_like(x[0]),
           "h0": np.zeros_like(x[0]) if ts == 3 else x[0],
           "h1": np.zeros_like(x[0]) if ts == 3 else x[1],
           "rc": np.full((2, nph, Bh, nrt), np.nan),
           "ret": np.full((2, Bh, nrt), np.nan),
           "rht": np.full((2, Bh, nrt), np.nan)}
    s_of = ([geo["s_be"], geo["s_cn"], geo["s_be"], geo["s_bdf"]] if ts == 3
            else [geo["s_be"] if ts == 1 else geo["s_cn"]])
    mem = Launch()
    kc = [c.numpy() for c in co]
    blocks = b9_blocks(mem, x, out, ts, kc, eng.bc.double().numpy()[..., 0],
                       eng.flip.numpy(), s_of, geo["reflective"],
                       geo["symmetric_half"], N, **mutant)
    run(blocks, resident, random.Random(seed), mem)
    return out


def b9_errors(out, ref, N):
    """Planes, then the records at the plain blocks that start the record
    tiles."""
    o0, o1, h0, h1, rc, ret, rht = ref
    idx = [r * RTILE // BLK for r in range(-(-N // RTILE))]
    planes = max(_nerr(out[k], r) for k, r in
                 (("o0", o0), ("o1", o1), ("h0", h0), ("h1", h1)))
    recs = max(_nerr(out["rc"], rc[..., idx]),
               _nerr(out["ret"], ret[..., idx]),
               _nerr(out["rht"], rht[..., idx]))
    return planes, recs


B9_CASES = ([(3, refl, sym, shape) for refl in (True, False)
             for sym in (False, True) for shape in SHAPES]
            + [(ts, refl, False, shape) for ts in (1, 2)
               for refl in (True, False) for shape in SHAPES
               if shape != "whole-tiles"])


@pytest.mark.parametrize(
    "ts,refl,sym,shape", B9_CASES,
    ids=[f"{ {1: 'BE', 2: 'CN', 3: 'BDF2'}[c[0]]}-"
         f"{'refl' if c[1] else 'src'}-{'sym' if c[2] else 'asym'}-{c[3]}"
         for c in B9_CASES])
def test_b9_lookback_model_matches_plain(b9_engines, ts, refl, sym, shape):
    N = SHAPES[shape]
    eng = b9_engines(ts, refl, sym, N)
    if N > L:
        # The composition matters: a carry crosses a whole tile.
        a = max(float(c[..., cs._A].double().max()) for c in eng.coef.values())
        assert a ** L > 1e-3
    co, x, geo, ref = b9_case(eng, seed=10 * ts + N)
    for seed, resident in ((ts + N, 3), (ts + N + 1, 2 * eng.Bh * 8)):
        out = b9_model(eng, co, x, geo, seed, resident)
        planes, recs = b9_errors(out, ref, N)
        assert planes <= BAR and recs <= BAR, (seed, planes, recs)


# -- B13 ---------------------------------------------------------------------

def b13_blocks(mem, z, v, kc, out, N, symmetric, materialize_only,
               mutant_edge=False):
    """The launch's blocks in ticket order (csrc/fused.cu
    fused_step_kernel): tile-major across the packed rows."""
    z0, z1 = z
    rows = z0.shape[0]
    T = -(-N // L)

    def block(row, t):
        t0, t1 = t * L, min((t + 1) * L, N)
        n = t1 - t0
        Z = np.zeros(n)
        kbe, kcn, kbdf = (coef_row(c[row]) for c in kc)
        lbe, lcn, lbdf = linear(kbe), linear(kcn), linear(kbdf)
        vr = v[row]
        snap = symmetric or row < rows // 2
        last = t + 1 == T

        def run_slot(s, kind, k, planes, p1_up, h1_up, inflow):
            return (yield from slot(mem, lambda j: ("s", s, row, j), t, T,
                                    kind, k, planes, p1_up, h1_up, inflow))

        def edge(name):
            return (yield from edge_of(mem, (name, row, t - 1), mutant_edge))

        def pub(name, value):
            if not last:
                mem.publish_edge((name, row, t), value)

        p1cn = vr[cf.V_P1CN] if t == 0 else 0.0
        p1bdf = vr[cf.V_P1BDF] if t == 0 else 0.0
        b0, b1, _, _ = yield from run_slot(0, BE, lbe, (Z,) * 6, 0.0, 0.0,
                                           const(vr[cf.V_BE1]))
        c0, c1, _, _ = yield from run_slot(1, CN, lcn, (b0, b1) + (Z,) * 4,
                                           p1cn, 0.0, const(vr[cf.V_CN]))
        hs0, hs1 = (c0, c1) if snap else (b0, b1)
        pub("cfill", hs1[-1])
        d0, d1, _, _ = yield from run_slot(2, BE, lbe, (c0, c1) + (Z,) * 4,
                                           0.0, 0.0, const(vr[cf.V_BE2]))
        hc = (yield from edge("cfill")) if t else vr[cf.V_FILLH]
        f0, f1, _, _ = yield from run_slot(3, BDF, lbdf,
                                           (d0, d1, Z, Z, hs0, hs1), p1bdf,
                                           hc, const(vr[cf.V_BDF]))
        x0, x1 = z0[row, t0:t1] + f0, z1[row, t0:t1] + f1
        if materialize_only:
            for name, g in zip(("o0", "o1", "h0", "h1"), (x0, x1, hs0, hs1)):
                out[name][row, t0:t1] = g
            return
        pub("etail", x1[-1])
        zero = const(0.0)
        b0, b1, _, m0 = yield from run_slot(4, BE, kbe, (x0, x1) * 3, 0.0,
                                            0.0, zero)
        et = (yield from edge("etail")) if t else 0.0
        c0, c1, _, m1 = yield from run_slot(5, CN, kcn, (b0, b1, x0, x1, x0,
                                                         x1), et, 0.0, zero)
        hs0, hs1 = (c0, c1) if snap else (b0, b1)
        pub("htail", hs1[-1])
        d0, d1, _, m2 = yield from run_slot(6, BE, kbe, (c0, c1, x0, x1, hs0,
                                                         hs1), 0.0, 0.0, zero)
        ht = (yield from edge("htail")) if t else 0.0
        f0, f1, _, m3 = yield from run_slot(7, BDF, kbdf, (d0, d1, x0, x1,
                                                           hs0, hs1), et, ht,
                                            zero)
        if last:
            out["rec"][row] = (m0, m1, m2, m3, hs1[-1], x1[-1])
        for name, g in zip(("o0", "o1", "h0", "h1"), (f0, f1, hs0, hs1)):
            out[name][row, t0:t1] = g

    return [block(r, t) for t in range(T) for r in range(rows)]


@pytest.fixture(scope="module")
def b13_engines():
    """The gray deck at M = 4 (packed rows 4) as B13's mesh engines pack
    it, optically thin, per (symmetric, N), on the CPU."""
    cache = {}

    def get(sym, N):
        if (sym, N) not in cache:
            cfg = port.load_config(GRAY, M=4, N=N, X=0.002, ts_method=3,
                                   bdf2_symmetric_half=sym,
                                   psi_source=((6.0,),) * 4)
            tables, _, _ = port_transport.build_tables(cfg)
            cache[(sym, N)] = ShardedCudaEngine(cfg, tables, block=BLK,
                                                device="cpu")
        return cache[(sym, N)]
    return get


def b13_case(eng, seed, mo):
    rng = np.random.default_rng(seed)
    rows = eng.rows
    base = eng.init_state().e0.double().reshape(rows, -1).numpy()
    v = base[:, :1] * rng.uniform(-0.5, 0.5, (rows, cf.NV))
    z = [base * rng.uniform(0.5, 1.5, base.shape) for _ in range(2)]
    co = [eng.coef[k].double() for k in (BE, CN, BDF)]
    full = int(np.log2(BLK))
    ref = cf.fused_step_launch_ref(
        *co, torch.as_tensor(v), *map(torch.as_tensor, z),
        symmetric_half=bool(eng.cfg.bdf2_symmetric_half), blk=BLK,
        npass={k: full for k in (BE, CN, BDF)}, materialize_only=mo)
    return co, v, z, [r.numpy() for r in ref]


def b13_model(eng, co, v, z, mo, seed, resident, **mutant):
    N = z[0].shape[1]
    out = {k: np.zeros_like(z[0]) for k in ("o0", "o1", "h0", "h1")}
    out["rec"] = np.full((eng.rows, cf.NREC), np.nan)
    mem = Launch()
    blocks = b13_blocks(mem, z, v, [c.numpy() for c in co], out, N,
                        bool(eng.cfg.bdf2_symmetric_half), mo, **mutant)
    run(blocks, resident, random.Random(seed), mem)
    return out


def b13_error(out, ref, mo):
    names = ("o0", "o1", "h0", "h1") + (() if mo else ("rec",))
    return max(_nerr(out[k], r) for k, r in zip(names, ref))


B13_CASES = [(mo, sym, shape) for mo in (False, True) for sym in (False, True)
             for shape in ("ragged", "below-one-tile", "40-tiles")]


@pytest.mark.parametrize(
    "mo,sym,shape", B13_CASES,
    ids=[f"{'mat' if c[0] else 'step'}-{'sym' if c[1] else 'asym'}-{c[2]}"
         for c in B13_CASES])
def test_b13_lookback_model_matches_plain(b13_engines, mo, sym, shape):
    N = SHAPES[shape]
    eng = b13_engines(sym, N)
    co, v, z, ref = b13_case(eng, 7 + N + sym, mo)
    for seed, resident in ((N + mo, 3), (N + mo + 1, eng.rows * 8)):
        err = b13_error(b13_model(eng, co, v, z, mo, seed, resident), ref,
                        mo)
        assert err <= BAR, (seed, err)


# -- B3 ----------------------------------------------------------------------

def b3_blocks(mem, kind, planes, out, kc, bc, flip, s, reflective, N,
              mutant_peek=False, mutant_tickets=False):
    """The launch's blocks in ticket order (csrc/sweep.cu substep_kernel;
    tile_major): one slot a tile, its upwind p1/h1 edges the input planes'
    values at cell t0 - 1. The mutant_peek row start reads the flipped row's
    outflow word without waiting, 0 while it is unwritten."""
    Bh = planes[0].shape[1]
    T = -(-N // L)
    p1, h1 = planes[3], planes[5]

    def block(h, row, t):
        t0, t1 = t * L, min((t + 1) * L, N)
        ins = tuple(x[h, row, t0:t1] for x in planes)
        p1_up = p1[h, row, t0 - 1] if t0 else 0.0
        h1_up = h1[h, row, t0 - 1] if t0 else 0.0

        def inflow():
            if h == 1 and reflective:
                key = (0, flip[row], T - 1)
                if not mutant_peek:
                    yield lambda: mem.words.get(key, (0,))[0] == INCL
                flag, val = mem.words.get(key, (0, 0.0))
                return s * (val if flag == INCL else 0.0)
            return s * bc[h, row]

        f0, f1, _, _ = yield from slot(
            mem, lambda j: (h, row, j), t, T, kind, coef_row(kc[h, row]),
            ins, p1_up, h1_up, inflow)
        out["o0"][h, row, t0:t1], out["o1"][h, row, t0:t1] = f0, f1

    return tile_major(block, Bh, T, reflective, mutant_tickets)


def b3_case(eng, kind, seed):
    """Seeded input planes of `kind` (BE 2, CN 3, BDF 6) and the plain
    version's float64 planes at exact scans."""
    rng = np.random.default_rng(seed)
    base = eng.init_state().e0.double().numpy()
    n = {BE: 2, CN: 3, BDF: 6}[kind]
    x = [base * rng.uniform(0.5, 1.5, base.shape) for _ in range(n)]
    ref = cs.substep_launch_ref(
        kind, eng.coef[kind].double(), eng.bc.double(), eng.flip,
        [torch.as_tensor(a) for a in x], s=float(eng.kcs[kind].s),
        reflective=eng.reflective, blk=BLK, npass=int(np.log2(BLK)))
    return x, [r.numpy() for r in ref]


def b3_model(eng, kind, x, seed, resident, **mutant):
    N = x[0].shape[-1]
    out = {"o0": np.zeros_like(x[0]), "o1": np.zeros_like(x[0])}
    mem = Launch()
    planes = [p.numpy() for p in cs._substep_planes(
        kind, [torch.as_tensor(a) for a in x])]
    blocks = b3_blocks(mem, kind, planes, out, eng.coef[kind].double().numpy(),
                       eng.bc.double().numpy()[..., 0], eng.flip.numpy(),
                       float(eng.kcs[kind].s), eng.reflective, N, **mutant)
    run(blocks, resident, random.Random(seed), mem)
    return out


def b3_error(out, ref):
    return max(_nerr(out["o0"], ref[0]), _nerr(out["o1"], ref[1]))


B3_CASES = [(kind, refl, shape) for kind in (BE, CN, BDF)
            for refl in (True, False) for shape in SHAPES]


@pytest.mark.parametrize(
    "kind,refl,shape", B3_CASES,
    ids=[f"{ {BE: 'BE', CN: 'CN', BDF: 'BDF'}[c[0]]}-"
         f"{'refl' if c[1] else 'src'}-{c[2]}" for c in B3_CASES])
def test_b3_lookback_model_matches_plain(b9_engines, kind, refl, shape):
    N = SHAPES[shape]
    eng = b9_engines(3, refl, False, N)
    x, ref = b3_case(eng, kind, seed=100 * kind + N)
    for seed, resident in ((kind + N, 3), (kind + N + 1, 2 * eng.Bh * 8)):
        err = b3_error(b3_model(eng, kind, x, seed, resident), ref)
        assert err <= BAR, (seed, err)


# -- mutants -----------------------------------------------------------------

def test_mutant_unguarded_edge_read_fails(b9_engines, b13_engines):
    """Reading the predecessor's edge word without waiting for it: some
    seeded interleaving reads it unwritten, and B9's BDF phase and B13's
    second cycle then miss their mark."""
    N = SHAPES["ragged"]
    eng = b9_engines(3, False, False, N)
    co, x, geo, ref = b9_case(eng, seed=1)
    b9_errs = [max(b9_errors(b9_model(eng, co, x, geo, seed, 2 * eng.Bh * 8,
                                      mutant_edge=True), ref, N))
               for seed in range(8)]
    eng13 = b13_engines(False, N)
    co, v, z, ref13 = b13_case(eng13, 2, False)
    b13_errs = [b13_error(b13_model(eng13, co, v, z, False, seed,
                                    eng13.rows * 8, mutant_edge=True),
                          ref13, False) for seed in range(8)]
    assert max(b9_errs) > 1e-6, b9_errs
    assert max(b13_errs) > 1e-6, b13_errs


def test_mutant_mu_pos_ticket_first_deadlocks(b9_engines):
    """A reflective B9 launch whose tickets run tile-major across both
    halves: mu>0 row starts take tickets before the mu<0 rows' last tiles
    and wait on them; once such waiters fill the residency, nothing can
    move. The kernel's order (every mu<0 ticket first) finishes at the same
    residency."""
    N = SHAPES["whole-tiles"]
    eng = b9_engines(3, True, False, N)
    co, x, geo, ref = b9_case(eng, seed=3)
    resident = eng.Bh
    out = b9_model(eng, co, x, geo, 5, resident)
    assert max(b9_errors(out, ref, N)) <= BAR
    with pytest.raises(Deadlock):
        b9_model(eng, co, x, geo, 5, resident, mutant_tickets=True)


def test_b3_mutant_unwaited_outflow_fails(b9_engines):
    """A B3 mu>0 row start that peeks the flipped mu<0 row's outflow word
    without waiting and takes 0 while it is unwritten: some seeded
    interleaving starts a mu>0 row before that word is written."""
    N = SHAPES["ragged"]
    eng = b9_engines(3, True, False, N)
    x, ref = b3_case(eng, BDF, seed=4)
    errs = [b3_error(b3_model(eng, BDF, x, seed, 2 * eng.Bh * 8,
                              mutant_peek=True), ref) for seed in range(8)]
    assert max(errs) > 1e-6, errs


def test_b3_mutant_mu_pos_ticket_first_deadlocks(b9_engines):
    """B3's reflective launch with tickets tile-major across both halves:
    the mu>0 row starts fill the residency waiting on mu<0 outflow words
    whose tiles have no ticket yet. The kernel's order finishes there."""
    N = SHAPES["whole-tiles"]
    eng = b9_engines(3, True, False, N)
    x, ref = b3_case(eng, CN, seed=6)
    resident = eng.Bh
    assert b3_error(b3_model(eng, CN, x, 5, resident), ref) <= BAR
    with pytest.raises(Deadlock):
        b3_model(eng, CN, x, 5, resident, mutant_tickets=True)
