"""Models of the two row splits the redesigned kernels run, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py phases 3
and 11 hold them against their plain versions there). These tests hold the
two designs' arithmetic and protocol in plain PyTorch and Python:

* (a) B8's single-pass chained scan with decoupled look-back
  (csrc/sharded.cu): per-tile zero-start scans of the plain version's b,
  composed as carry_in(t) = a^n * carry_in(t-1) + B_{t-1} (n the cells of
  a full tile) and reconstructed per cell, against
  ``sharded_substep_launch_ref``: evaluated in float64 with npass =
  log2(blk), so that its block scan is exact, within 1e-12; in float32 at
  the engine's own npass within 1e-5, the card's bar (the plain version
  truncates its scan, the model does not). BE, CN and BDF; a ragged row, a
  row below one tile and a row of whole tiles; nonzero pending corrections
  and halo tails; an optically thin slab (a ~ 0.995-0.9994), so that carries
  cross many tiles.
* (b) B6's cluster wavefront (csrc/df_sweep.cu): C blocks over (tile,
  slot), tile t on block t mod C, one mailbox entry and one mbarrier (one
  arrival a phase) per slot and block, each block's single parity bit
  flipped after every tile that waited, run under seeded random
  interleavings of the blocks. Every read gets what tile t-1 wrote for
  that slot; step k's upwind p1 edge arrives by slot 4k and its h1 edge by
  slot 4k+1; no write lands on an unread entry; no barrier runs two phases
  ahead of its waiter (a parity wait could not tell them apart); every
  block finishes.

No JAX program is compiled here.
"""

import os
import random

import numpy as np
import pytest
import torch

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN
from radiative_transfer_tpu_torch.parallel.sharded_cuda import (
    ShardedCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
KINDS = [BE, CN, BDF]
KIND_IDS = ["BE", "CN", "BDF"]

# -- (a) B8's look-back ------------------------------------------------------

BLK = 64            # the plain version's block (divides every N below)
CELLS = 8           # cells a thread in B8
# Rows of N cells at B8's 512-cell tile (64 threads): 4 whole tiles and a
# ragged 448-cell one; 192 cells, below one (256-cell) tile; 3 whole tiles.
SHAPES = {"ragged": 2496, "below-one-tile": 192, "whole-tiles": 1536}


def _tile(N: int) -> int:
    """B8's tile for rows of N cells (csrc/tiles.cuh pick_threads at
    cuda_sweep.SHARDED_THREADS threads at most, 8 cells a thread)."""
    t = -(-N // CELLS)
    t = -(-t // 32) * 32
    t = min(max(t, 32), cs.SHARDED_THREADS)
    return t * CELLS


@pytest.fixture(scope="module", params=list(SHAPES), ids=list(SHAPES))
def engine(request):
    """The gray deck at M = 4 (rows 4), optically thin (X = 0.002), off
    equilibrium, on ShardedCudaEngine at a one-device mesh on the CPU."""
    cfg = port.load_config(GRAY, M=4, N=SHAPES[request.param], X=0.002,
                           ts_method=3, bc_left_indicator=2,
                           psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return ShardedCudaEngine(cfg, tables, block=BLK, device="cpu")


def _inputs(eng, kind: int, seed: int):
    """Seeded B8 inputs, packed (rows, N): pending corrections (inc around
    the state's scale, both signs; the engine's d0, a, ln_a), halo tails
    and planes around it."""
    rng = np.random.default_rng(seed)
    rows, N = eng.rows, eng.N_loc
    B = float(np.asarray(eng.tables.B)[0])
    n_corr, n_halo, n_planes = {BE: (1, 0, 2), CN: (2, 1, 3),
                                BDF: (3, 2, 6)}[kind]
    cc = eng.cc[kind].reshape(rows, 3).numpy()
    corrs = [np.concatenate([B * rng.uniform(-1, 1, (rows, 1)), cc], 1)
             for _ in range(n_corr)]
    halos = [B * rng.uniform(0.5, 1.5, (rows, 1)) for _ in range(n_halo)]
    planes = [B * rng.uniform(0.5, 1.5, (rows, N)) for _ in range(n_planes)]
    return corrs, halos, planes


def _model_b8(kind, coef, corrs, halos, planes, tile: int):
    """B8's chained scan in plain PyTorch: the true planes rebuilt as the
    kernel loads them, the right-hand sides and b of the plain version,
    each tile's zero-start scan (its aggregate B_t and every cell's
    zero-start carry), the tiles' carries composed in order, and the 2x2
    reconstruction from each cell's entering carry."""
    rows, N = planes[0].shape
    kc = cs._unpack_coef(coef)
    j = torch.arange(N, dtype=torch.float32)[None, :]
    e0, e1 = cs._corrected(planes[0], planes[1], corrs[0], j)
    zt = torch.zeros((rows, 1), dtype=e0.dtype)
    if kind == BDF:
        p0, p1 = cs._corrected(planes[2], planes[3], corrs[1], j)
        h0, h1 = cs._corrected(planes[4], planes[5], corrs[2], j)
    elif kind == CN:
        _, p1 = cs._corrected(planes[2], planes[2], corrs[1], j)
        p0, h0, h1 = e0, e0, e1
    else:
        p0, p1, h0, h1 = e0, e1, e0, e1
    ptail = halos[0] if kind in (CN, BDF) else zt
    htail = halos[1] if kind == BDF else zt

    def shift1(x, tail):
        return torch.cat([tail, x[:, :-1]], dim=1)

    S = kc.Sb + kc.c1 * (0.5 * (e0 + e1)) + kc.c0
    if kind == BE:
        r0, r1 = S + kc.kee * e0, S + kc.kee * e1
    elif kind == CN:
        r0 = S + kc.kee * e0 - kc.q * e1 + kc.w * shift1(p1, ptail)
        r1 = S + kc.q * e0 + kc.kee * e1
    else:
        r0 = (S + kc.kee * h0 - 2.0 * kc.w * h1 - kc.kp * p0 - kc.q * p1
              + kc.w * (4.0 * shift1(h1, htail) + shift1(p1, ptail)))
        r1 = S + 2.0 * kc.w * h0 + kc.kee * h1 + kc.q * p0 - kc.kp * p1
    b = (kc.q * r0 + kc.T0 * r1) * kc.idet

    # Each tile's zero-start scan, all tiles at once (cells past N are 0).
    T = -(-N // tile)
    bt = torch.cat([b, b.new_zeros((rows, T * tile - N))], 1)
    bt = bt.reshape(rows, T, tile)
    a = kc.a[:, :, None]                                   # (rows, 1, 1)
    zero_start = torch.empty_like(bt)                      # carry leaving
    c = bt.new_zeros((rows, T))
    for m in range(tile):
        c = a[:, :, 0] * c + bt[:, :, m]
        zero_start[:, :, m] = c
    # The carries entering the tiles: the look-back's composition.
    a_tile = kc.a ** tile
    cin = [zt]
    for t in range(1, T):
        cin.append(a_tile * cin[-1] + zero_start[:, t - 1, -1:])
    cin = torch.cat(cin, 1)[:, :, None]                    # (rows, T, 1)
    m = torch.arange(tile, dtype=b.dtype)
    before = torch.cat([bt.new_zeros((rows, T, 1)), zero_start[..., :-1]],
                       2)
    cur = (a ** m * cin + before).reshape(rows, -1)[:, :N]
    u = r0 + kc.w * cur
    return ((kc.T0 * u - kc.q * r1) * kc.idet,
            (kc.q * u + kc.T0 * r1) * kc.idet)


def _nerr(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_b8_lookback_model_matches_plain(engine, kind, dtype):
    eng = engine
    N = eng.N_loc
    tile = _tile(N)
    if N > tile:
        # The composition matters: a carry crosses a whole tile.
        a = cs._unpack_coef(eng.coef[kind].double()).a
        assert float((a ** tile).max()) > 1e-3
    corrs, halos, planes = _inputs(eng, kind, seed=7 * kind + N)

    def as_t(xs):
        return [torch.as_tensor(x, dtype=dtype) for x in xs]

    coef = eng.coef[kind].to(dtype)
    args = (kind, coef, as_t(corrs), as_t(halos), as_t(planes))
    got = _model_b8(*args, tile=tile)
    if dtype == torch.float64:
        # log2(blk) passes: the plain version's block scan is exact.
        ref = cs.sharded_substep_launch_ref(
            *args, blk=eng.block, npass=int(np.log2(eng.block)))
        bar = 1e-12
    else:
        ref = cs.sharded_substep_launch_ref(
            *args, blk=eng.block, npass=eng.scan_npass[kind])
        bar = 1e-5
    errs = [_nerr(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= bar, errs


# -- (b) B6's mailbox protocol ----------------------------------------------

class _Block:
    """One cluster block of B6's wavefront, as csrc/df_sweep.cu runs it:
    tiles rank, rank + C, ...; per tile and step k the slots 4k .. 4k+3,
    each (for t > 0) a wait on the slot's barrier with the block's parity
    and a copy of its mailbox, the sub-step, and (when a tile follows) a
    send to block (t+1) mod C; the parity flips after a tile that waited."""

    def __init__(self, rank, C, T, K):
        self.rank, self.C, self.T, self.K = rank, C, T, K
        self.parity = 0
        self.ops = self._ops()
        self.pending = next(self.ops, None)

    def _ops(self):
        for t in range(self.rank, self.T, self.C):
            for k in range(self.K):
                for p in range(4):
                    s = 4 * k + p
                    if t > 0:
                        yield ("wait", t, s, k, p)
                    yield ("run", t, s, k, p)
                    if t + 1 < self.T:
                        yield ("send", t, s, k, p)
            if t > 0:
                yield ("flip", t, 0, 0, 0)


def _run_wavefront(C: int, T: int, K: int, seed: int):
    """Runs the protocol under one seeded random interleaving; returns the
    number of steps taken. Asserts every property on the way."""
    S = 4 * K
    rng = random.Random(seed)
    blocks = [_Block(r, C, T, K) for r in range(C)]
    # Per (block, slot): the mailbox (message, read?), the barrier's
    # completed phases and the waits that passed.
    mail = [[None] * S for _ in range(C)]
    unread = [[False] * S for _ in range(C)]
    phases = [[0] * S for _ in range(C)]
    waited = [[0] * S for _ in range(C)]
    # What each block's shared state holds: the slot's state and the tails.
    state = [[None] * S for _ in range(C)]
    eth = [[None] * K for _ in range(C)]
    hth = [[None] * K for _ in range(C)]
    steps = 0
    while True:
        live = [b for b in blocks if b.pending is not None]
        if not live:
            break
        runnable = []
        for b in live:
            op, t, s, k, p = b.pending
            if op != "wait" or phases[b.rank][s] % 2 != b.parity:
                runnable.append(b)
        assert runnable, f"deadlock: C={C} T={T} K={K}"
        b = rng.choice(runnable)
        r = b.rank
        op, t, s, k, p = b.pending
        if op == "wait":
            # A parity wait passes on the phase it waits for only if the
            # barrier is not a further phase ahead.
            assert phases[r][s] == waited[r][s] + 1, (C, T, K, t, s)
            waited[r][s] += 1
            msg = mail[r][s]
            assert unread[r][s] and msg[:2] == (t - 1, s), (msg, t, s)
            unread[r][s] = False
            state[r][s] = msg
            if p == 0:
                eth[r][k] = msg[2]
            elif p == 1:
                hth[r][k] = msg[2]
        elif op == "run":
            if t > 0:
                assert state[r][s][:2] == (t - 1, s)
                # upwind_pair reads step k's p1 edge before slot 4k and
                # its h1 edge before slot 4k+2 (both after their slots'
                # waits): each must be tile t-1's for step k.
                if p == 0:
                    assert eth[r][k] == ("e", t - 1, k)
                if p == 2:
                    assert hth[r][k] == ("h", t - 1, k)
            state[r][s] = (t, s)
        elif op == "send":
            nxt = (r + 1) % C
            assert state[r][s] == (t, s)
            assert not unread[nxt][s], (C, T, K, t, s)   # no lost message
            tail = ("e", t, k) if p == 0 else ("h", t, k) if p == 1 else None
            mail[nxt][s] = (t, s, tail)
            unread[nxt][s] = True
            phases[nxt][s] += 1
            assert phases[nxt][s] <= waited[nxt][s] + 1
        else:
            b.parity ^= 1
        b.pending = next(b.ops, None)
        steps += 1
    # Every message was read: the last tile sends nothing.
    assert not any(any(row) for row in unread)
    return steps


def _wave_cases():
    for C in (1, 2, 8, 16):
        for K in (1, 2, 3, 4):
            for T in sorted({1, C - 1, C, C + 1, 3 * C + 2} - {0}):
                yield pytest.param(C, T, K, id=f"C{C}-T{T}-K{K}")


@pytest.mark.parametrize("C,T,K", list(_wave_cases()))
def test_b6_mailbox_protocol(C, T, K):
    for seed in range(3):
        steps = _run_wavefront(C, T, K, seed=1000 * C + 10 * T + K + seed)
        sends = (T - 1) * 4 * K
        waits = (T - 1) * 4 * K
        assert steps == T * 4 * K + sends + waits + (T - 1)
