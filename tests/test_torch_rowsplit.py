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
* (b, c) The cluster wavefront of B6 (csrc/df_sweep.cu), B1 and B2
  (csrc/sweep.cu), on csrc/cluster.cuh's mailboxes: C blocks over (tile,
  slot), tile t on block t mod C, one mailbox entry and one mbarrier (one
  arrival a phase) per slot and block, each block's single parity bit
  flipped after every tile that waited, run under seeded random
  interleavings of the blocks. Every read gets what tile t-1 wrote for
  that slot; the tails arrive with their slots (B6 and B1: step k's upwind
  p1 edge by slot 4k and its h1 edge by slot 4k+1; B2-CN: step k's p1 edge
  by slot k; B2-BE: none) and are those of tile t-1 where they are read;
  no write lands on an unread entry; no barrier runs two phases ahead of
  its waiter (a parity wait could not tell them apart); every block
  finishes.
* (d) B1's and B2's wavefront walk in plain PyTorch: each (tile, slot) a
  unit, the tile's sub-step with an exact scan from the carry the mail
  brings, run in a seeded random order that C blocks could take (tile t on
  block t mod C, each block's units in order, a unit ready when tile t-1's
  mail for its slot is in the mailbox), carries and tails passed through a
  mailbox dict. Held bit for bit against the same model in serial order
  (one block), and against ``bdf2_launch_ref`` / ``multistep_launch_ref``
  evaluated in float64 with npass = log2(blk), so that their block scan is
  exact, within 1e-12; reflective and source left boundaries, both half
  modes, a ragged last tile, whole tiles, a row below one tile.

No JAX program is compiled here.
"""

import functools
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


# -- (b, c) the wavefront's mailbox protocol ---------------------------------

# Per kernel: slots a step and, per tail, (the slot phase that carries it,
# the slot phase before whose sub-step the receiving tile reads it).
WAVES = {
    "B6": (4, {"e": (0, 0), "h": (1, 2)}),
    "B1": (4, {"e": (0, 0), "h": (1, 2)}),
    "B2-CN": (1, {"e": (0, 0)}),
    "B2-BE": (1, {}),
}


class _Block:
    """One cluster block of the wavefront, as csrc/df_sweep.cu (B6) and
    csrc/sweep.cu (B1, B2) run it: tiles rank, rank + C, ...; per tile and
    step k the slots k*spp .. k*spp + spp - 1, each (for t > 0) a wait on
    the slot's barrier with the block's parity and a copy of its mailbox,
    the sub-step, and (when a tile follows) a send to block (t+1) mod C;
    the parity flips after a tile that waited."""

    def __init__(self, rank, C, T, K, spp):
        self.rank, self.C, self.T, self.K, self.spp = rank, C, T, K, spp
        self.parity = 0
        self.ops = self._ops()
        self.pending = next(self.ops, None)

    def _ops(self):
        for t in range(self.rank, self.T, self.C):
            for k in range(self.K):
                for p in range(self.spp):
                    s = self.spp * k + p
                    if t > 0:
                        yield ("wait", t, s, k, p)
                    yield ("run", t, s, k, p)
                    if t + 1 < self.T:
                        yield ("send", t, s, k, p)
            if t > 0:
                yield ("flip", t, 0, 0, 0)


def _run_wavefront(C: int, T: int, K: int, seed: int, wave: str = "B6"):
    """Runs the protocol of `wave` under one seeded random interleaving;
    returns the number of steps taken. Asserts every property on the
    way."""
    spp, tails = WAVES[wave]
    S = spp * K
    rng = random.Random(seed)
    blocks = [_Block(r, C, T, K, spp) for r in range(C)]
    # Per (block, slot): the mailbox (message, read?), the barrier's
    # completed phases and the waits that passed.
    mail = [[None] * S for _ in range(C)]
    unread = [[False] * S for _ in range(C)]
    phases = [[0] * S for _ in range(C)]
    waited = [[0] * S for _ in range(C)]
    # What each block's shared state holds: the slot's state and, per tail,
    # each step's tail.
    state = [[None] * S for _ in range(C)]
    held = {x: [[None] * K for _ in range(C)] for x in tails}
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
        assert runnable, f"deadlock: {wave} C={C} T={T} K={K}"
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
            for x, (sent_p, _) in tails.items():
                if p == sent_p:
                    held[x][r][k] = msg[2]
        elif op == "run":
            if t > 0:
                assert state[r][s][:2] == (t - 1, s)
                # Each tail is read (thread 0's upwind exchange) before the
                # sub-step of its reading phase, after its slot's wait: it
                # must be tile t-1's for step k.
                for x, (_, read_p) in tails.items():
                    if p == read_p:
                        assert held[x][r][k] == (x, t - 1, k), (wave, t, s)
            state[r][s] = (t, s)
        elif op == "send":
            nxt = (r + 1) % C
            assert state[r][s] == (t, s)
            assert not unread[nxt][s], (C, T, K, t, s)   # no lost message
            tail = next(((x, t, k) for x, (sent_p, _) in tails.items()
                         if p == sent_p), None)
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


def _b1_b2_wave_cases():
    """(wave, C, T, K): B1 at C up to 16 (its 4K slots allow it from K =
    4), B2 at C up to its K slots; T below C, at C, one above, and with
    a ragged rest (3C + 2)."""
    for wave, Ks in (("B1", (1, 4)), ("B2-CN", (1, 5, 16)),
                     ("B2-BE", (1, 5, 16))):
        spp = WAVES[wave][0]
        for K in Ks:
            for C in sorted({1, min(3, spp * K), min(16, spp * K)}):
                for T in sorted({1, C - 1, C, C + 1, 3 * C + 2} - {0}):
                    yield pytest.param(wave, C, T, K,
                                       id=f"{wave}-C{C}-T{T}-K{K}")


@pytest.mark.parametrize("wave,C,T,K", list(_b1_b2_wave_cases()))
def test_b1_b2_mailbox_protocol(wave, C, T, K):
    S = WAVES[wave][0] * K
    for seed in range(3):
        steps = _run_wavefront(C, T, K, seed=7000 * C + 10 * T + K + seed,
                               wave=wave)
        assert steps == T * S + 2 * (T - 1) * S + (T - 1)


# -- (d) B1's and B2's wavefront walk in plain PyTorch ------------------------

MBLK = 32                # the plain version's block
MN = 96                  # cells a row: three plain blocks
# The model's tiles: a ragged last one (40, 40, 16), whole tiles (4 of 24),
# a row below one tile.
MTILES = {"ragged": 40, "whole": 24, "below-one-tile": 128}


def _tile_substep(kind, kc, e0, e1, p0, p1, h0, h1, p1_up, h1_up, carry):
    """substep_tile (csrc/tiles.cuh) over one tile's (rows, n) cells: the
    right-hand sides with the upwind p1/h1 values (rows, 1), the exact scan
    of carry_j = a*carry_{j-1} + b_j from the carry entering the tile, the
    2x2 reconstruction. Returns (o0, o1, the carry leaving the tile)."""
    def shift(x, up):
        return torch.cat([up, x[:, :-1]], 1)

    S = kc.Sb + kc.c1 * (0.5 * (e0 + e1)) + kc.c0
    if kind == BE:
        r0, r1 = S + kc.kee * e0, S + kc.kee * e1
    elif kind == CN:
        r0 = S + kc.kee * e0 - kc.q * e1 + kc.w * shift(p1, p1_up)
        r1 = S + kc.q * e0 + kc.kee * e1
    else:
        r0 = (S + kc.kee * h0 - 2.0 * kc.w * h1 - kc.kp * p0 - kc.q * p1
              + kc.w * (4.0 * shift(h1, h1_up) + shift(p1, p1_up)))
        r1 = S + 2.0 * kc.w * h0 + kc.kee * h1 + kc.q * p0 - kc.kp * p1
    b = (kc.q * r0 + kc.T0 * r1) * kc.idet
    cin = torch.empty_like(b)
    cur = carry
    for j in range(b.shape[1]):
        cin[:, j:j + 1] = cur
        cur = kc.a * cur + b[:, j:j + 1]
    u = r0 + kc.w * cin
    return ((kc.T0 * u - kc.q * r1) * kc.idet,
            (kc.q * u + kc.T0 * r1) * kc.idet, cur)


class _WaveTile:
    """One tile of one half's rows as the wavefront kernels run it, one
    (step, phase) slot at a time: B1 (bdf2_kernel: BE, CN, BE, BDF a step,
    the half snapshot, step k's p1 edge sent with slot 4k and its h1 edge
    with slot 4k+1) or B2 (multistep_kernel of `kind`: one slot a step, CN
    sending step k's p1 edge with slot k). run(s, mail) takes tile t-1's
    mail (carry, tail) for slot s (None for the row's first tile: the
    carries start from `inflow` and the tails at 0) and returns this
    tile's mail."""

    def __init__(self, wave, kcs, x0, x1, snap_cn, inflow):
        self.wave, self.kcs, self.snap_cn = wave, kcs, snap_cn
        self.x0, self.x1 = x0, x1
        self.inflow = inflow
        self.zt = torch.zeros_like(x0[:, :1])
        self.tails = {}

    def run(self, s, mail):
        carry, tail = mail if mail is not None else (self.inflow[s],
                                                     self.zt)
        if self.wave == "B1":
            return self._bdf2(s, carry, tail)
        kind = BE if self.wave == "B2-BE" else CN
        x0, x1 = self.x0, self.x1
        out0, out1, c = _tile_substep(kind, self.kcs[kind], x0, x1, x0, x1,
                                      x0, x1, tail, self.zt, carry)
        self.p0, self.p1 = x0, x1
        self.x0, self.x1 = out0, out1
        return c, (x1[:, -1:] if kind == CN else None)

    def _bdf2(self, s, carry, tail):
        k, ph = divmod(s, 4)
        kbe, kcn, kbdf = (self.kcs[x] for x in (BE, CN, BDF))
        x0, x1, z = self.x0, self.x1, self.zt
        if ph == 0:
            self.tails["e", k] = tail
            self.b = _tile_substep(BE, kbe, x0, x1, x0, x1, x0, x1, z, z,
                                   carry)
            return self.b[2], x1[:, -1:]
        if ph == 1:
            self.tails["h", k] = tail
            self.c = _tile_substep(CN, kcn, *self.b[:2], x0, x1, x0, x1,
                                   self.tails["e", k], z, carry)
            pick = self.c if self.snap_cn else self.b
            self.hs = pick[:2]
            return self.c[2], self.hs[1][:, -1:]
        if ph == 2:
            self.d = _tile_substep(BE, kbe, *self.c[:2], x0, x1, *self.hs,
                                   z, z, carry)
            return self.d[2], None
        f = _tile_substep(BDF, kbdf, *self.d[:2], x0, x1, *self.hs,
                          self.tails["e", k], self.tails["h", k], carry)
        self.p0, self.p1 = x0, x1
        self.x0, self.x1 = f[:2]
        return f[2], None

    def outputs(self):
        if self.wave == "B1":
            return (self.x0, self.x1, *self.hs, self.p0, self.p1)
        return self.x0, self.x1, self.p0, self.p1


def _wave_half(wave, kcs, x0, x1, K, inflow, tile, snap_cn, C, rng):
    """One half's rows through the wavefront walk on C blocks, units in an
    order drawn from `rng` (serial, tile after tile, for C = 1). Returns
    (the half's output planes, the carries leaving the row per slot)."""
    N = x0.shape[1]
    T = -(-N // tile)
    S = (4 if wave == "B1" else 1) * K
    tiles = [_WaveTile(wave, kcs, x0[:, t * tile:(t + 1) * tile],
                       x1[:, t * tile:(t + 1) * tile], snap_cn, inflow)
             for t in range(T)]
    # Each block's units in its order: tiles rank, rank + C, ..., all slots.
    queues = [[(t, s) for t in range(r, T, C) for s in range(S)]
              for r in range(C)]
    mailbox = {}
    record = [None] * S
    while any(queues):
        ready = [q for q in queues
                 if q and (q[0][0] == 0 or (q[0][0] - 1, q[0][1]) in mailbox)]
        assert ready, f"deadlock: {wave} C={C} T={T} K={K}"
        q = rng.choice(ready)
        t, s = q.pop(0)
        carry, tail = tiles[t].run(s, mailbox.pop((t - 1, s), None))
        if t + 1 < T:
            assert (t, s) not in mailbox
            mailbox[t, s] = (carry, tail if tail is not None else
                             tiles[t].zt)
        else:
            record[s] = carry
    assert not mailbox
    outs = [torch.cat(p, 1) for p in zip(*(x.outputs() for x in tiles))]
    return outs, record


def _wave_launch(wave, eng, x0, x1, K, tile, C, seed):
    """A whole launch of B1 or B2 on (2, Bh, N) planes: the mu<0 half, then
    the mu>0 half from the boundary or, on a reflective slab, from the
    flipped mu<0 record, each through the wavefront walk."""
    rng = random.Random(seed)
    kinds = (BE, CN, BDF) if wave == "B1" else (
        (BE,) if wave == "B2-BE" else (CN,))
    s_of = ([eng.kcs[k].s for _ in range(K) for k in (BE, CN, BE, BDF)]
            if wave == "B1" else [eng.kcs[kinds[0]].s] * K)
    coef = {k: eng.coef[k].to(x0.dtype) for k in kinds}
    bc = eng.bc.to(x0.dtype)
    outs, record = [], None
    for h in (0, 1):
        if h == 1 and eng.reflective:
            inflow = [s * c[eng.flip.long()] for s, c in zip(s_of, record)]
        else:
            inflow = [s * bc[h] for s in s_of]
        kcs = {k: cs._unpack_coef(coef[k][h]) for k in kinds}
        snap_cn = bool(eng.cfg.bdf2_symmetric_half) or h == 0
        got, record = _wave_half(wave, kcs, x0[h], x1[h], K, inflow, tile,
                                 snap_cn, C, rng)
        outs.append(got)
    return tuple(torch.stack(p) for p in zip(*outs))


@functools.cache
def _model_engine(ts_method: int, reflective: bool, symmetric: bool):
    """The gray deck at M = 4 (Bh = 2), N = MN, optically thin (X =
    0.002, so carries cross tiles), on CudaSweepEngine on the CPU."""
    cfg = port.load_config(
        GRAY, M=4, N=MN, X=0.002, ts_method=ts_method,
        bc_left_indicator=2 if reflective else 1,
        bdf2_symmetric_half=symmetric,
        psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cs.CudaSweepEngine(cfg, tables, block=MBLK, device="cpu")


def _model_cases():
    for wave in ("B1", "B2-BE", "B2-CN"):
        for refl in (True, False):
            for tname in MTILES:
                yield pytest.param(wave, refl, False, tname,
                                   id=f"{wave}-{'refl' if refl else 'src'}"
                                   f"-{tname}")
    for refl in (True, False):
        yield pytest.param("B1", refl, True, "ragged",
                           id=f"B1-{'refl' if refl else 'src'}-sym-ragged")


@pytest.mark.parametrize("wave,refl,sym,tname", list(_model_cases()))
def test_b1_b2_wavefront_model_matches_plain(wave, refl, sym, tname):
    ts_method = {"B1": 3, "B2-BE": 1, "B2-CN": 2}[wave]
    eng = _model_engine(ts_method, refl, sym)
    tile = MTILES[tname]
    T = -(-MN // tile)
    K = 3 if wave == "B1" else 5
    S = (4 if wave == "B1" else 1) * K
    rng = np.random.default_rng(ts_method * 100 + tile + 10 * refl + sym)
    B = float(np.asarray(eng.tables.B)[0])
    x0, x1 = (torch.as_tensor(B * rng.uniform(0.5, 1.5, (2, eng.Bh, MN)))
              for _ in range(2))
    if T > 1:
        # The mail matters: a carry crosses a whole tile.
        kc = next(iter(eng.coef.values()))
        a = cs._unpack_coef(kc.double().reshape(-1, 10)).a
        assert float((a ** tile).max()) > 1e-2
    serial = _wave_launch(wave, eng, x0, x1, K, tile, C=1, seed=0)
    for C in sorted({2, min(S, T, 16)}):
        for seed in range(2):
            got = _wave_launch(wave, eng, x0, x1, K, tile, C=C, seed=seed)
            assert all(torch.equal(g, r) for g, r in zip(got, serial)), (
                C, seed)
    npass = int(np.log2(MBLK))
    coef = {k: c.double() for k, c in eng.coef.items()}
    if wave == "B1":
        ref = cs.bdf2_launch_ref(
            coef[BE], coef[CN], coef[BDF], eng.bc.double(), eng.flip, x0, x1,
            K=K, s_be=eng.kcs[BE].s, s_cn=eng.kcs[CN].s,
            s_bdf=eng.kcs[BDF].s, reflective=eng.reflective,
            symmetric_half=sym, blk=MBLK, npass_be=npass, npass_cn=npass,
            npass_bdf=npass)
    else:
        kind = BE if wave == "B2-BE" else CN
        ref = cs.multistep_launch_ref(
            kind, coef[kind], eng.bc.double(), eng.flip, x0, x1, K=K,
            s=eng.kcs[kind].s, reflective=eng.reflective, blk=MBLK,
            npass=npass)
    errs = [_nerr(g, r) for g, r in zip(serial, ref)]
    assert max(errs) <= 1e-12, errs
