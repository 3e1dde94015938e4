"""Models of B4's and B15's cluster wavefronts, one cluster a packed row, on
the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py phases 3,
6 and 8 hold them against their plain versions there). B4 (csrc/sweep.cu
halo_bdf2_kernel, on csrc/wave.cuh bdf2_wave) and B15 (csrc/df_sweep.cu
df_halo_multistep_kernel, on df_multistep_wave) run each packed row's two
chains, the halo chain [0, reset_cell) from zero and the seeded chain
[reset_cell, X) from the seeds, as ONE sequence of tiles on the row's
cluster of C blocks (csrc/cluster.cuh HaloChains): tiles 0 .. T_h-1 the
halo chain, then the seeded chain, tile t on block t mod C. The seeded
chain's first tile still takes its mail for every slot and then overwrites
the slot's state with the seed (take-and-reseed). These tests hold that
design in plain Python and PyTorch:

* (a) The protocol: every block of the launch (one cluster a packed row)
  under seeded random interleavings, B4's 4K slots (step k's p1 tail with
  slot 4k, its h1 tail with slot 4k+1) and B15's K slots (under CN step k's
  p1 tail with slot k; under BE none). Every read gets what its upstream
  tile wrote; the reseeded tile's state and tails come from the seeds (and
  zeros), not from the mail it took; no write lands on an unread entry; no
  barrier runs two phases ahead of its waiter; every block finishes, and
  the halo chain's last tile (ragged or not) sends. Reset off the tile,
  reset 0, a halo chain shorter than C, T_h >= C, a seeded chain of C + 1
  tiles, packed rows 2 and 32.
* (b) The mutant where the seeded tile skips its take (it reseeds without
  waiting, and the halo chain's last tile sends nothing): some seeded
  interleaving must break (a)'s checks.
* (c) B4's walk in plain PyTorch: each (tile, slot) a unit, the tile's
  sub-step with an exact scan (test_torch_rowsplit._tile_substep), run in
  a seeded random order C blocks could take, mail through a dict, the
  reseeding tile discarding its mail; bit for bit against the serial walk,
  the record included, and against ``halo_bdf2_launch_ref`` evaluated in
  float64 with npass = log2(blk) (its block scan exact) within 1e-12.
* (d) B15's walk on the plain version's df sub-step
  (``cuda_df._df_substep_block`` over a whole tile with an exact scan, the
  arithmetic of ``_df_multistep_block``), against
  ``df_halo_multistep_launch_ref`` with exact block scans within 1e-12 in
  hi + lo (max|d(hi+lo)| / max|hi+lo|), bit for bit against the serial
  walk, the record included.

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
from radiative_transfer_tpu_torch.ops import cuda_df as cd
from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN
from test_torch_recwave import _walk
from test_torch_rowsplit import _model_engine, _nerr, _tile_substep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")


# -- (a, b) the protocol: one cluster a packed row, take-and-reseed ----------

# Per wave: slots a step, and per tail (the phase of the slot that carries
# it, the phase before whose sub-step the receiving tile reads it).
WAVES = {"B4": (4, {"e": (0, 0), "h": (1, 2)}),
         "B15-CN": (1, {"e": (0, 0)}),
         "B15-BE": (1, {})}


def _ops(Th, Tm, S, C, rank, mutant):
    """One block's operations, as bdf2_wave and df_multistep_wave run them
    under HaloChains: its tiles rank, rank + C, ... of the row's Th + Tm;
    per tile and slot a wait on the slot's barrier with the block's parity
    and a take (the reseeding tile Th > 0 takes and discards), the sub-step,
    and a send to block rank + 1 mod C unless it is the row's last tile;
    the parity flips after a tile that waited. The mutant's tile Th reseeds
    without waiting, and the halo chain's last tile sends nothing."""
    T = Th + Tm
    for t in range(rank, T, C):
        skip = mutant and Th > 0 and t == Th
        sends = t + 1 < T and not (mutant and Th > 0 and t == Th - 1)
        for s in range(S):
            if t > 0:
                yield ("reseed" if skip else "wait", t, s)
            yield ("run", t, s)
            if sends:
                yield ("send", t, s)
        if t > 0 and not skip:
            yield ("flip", t, 0)


def _run_protocol(wave, rows, Th, Tm, K, C, seed, mutant=False):
    """Every block of a launch of `rows` clusters under one seeded random
    interleaving; asserts every property on the way. Returns the steps
    taken."""
    per, tails = WAVES[wave]
    S = per * K
    T = Th + Tm
    rng = random.Random(seed)

    def tail_of(row, t, s, zero):
        """The tail slot s brings (from tile t), or None."""
        k, p = divmod(s, per)
        for x, (sent_p, _) in tails.items():
            if p == sent_p:
                return ("zero", row, k) if zero else (x, row, t, k)
        return None

    def start(row, s):
        # A chain's entering state: the seeds where the row is one chain or
        # at the reseeding tile, zero for the halo chain.
        return ("seed", row, s)

    blocks = []
    for row in range(rows):
        # Per block: mailbox (message, read?), completed barrier phases,
        # passed waits, parity, the slots' and tails' state in shared
        # memory as tile 0 finds it (zero before a halo chain, else the
        # seeds).
        st = [dict(mail=[None] * S, unread=[False] * S, phases=[0] * S,
                   waited=[0] * S, parity=0,
                   state=[start(row, s) if Th == 0 else ("zero", row, s)
                          for s in range(S)],
                   held={x: [("zero", row, k) for k in range(K)]
                         for x in tails})
              for _ in range(C)]
        for r in range(C):
            ops = _ops(Th, Tm, S, C, r, mutant)
            blocks.append([row, st, r, ops, next(ops, None)])
    steps = 0
    while True:
        live = [b for b in blocks if b[4] is not None]
        if not live:
            break
        runnable = [b for b in live if b[4][0] != "wait" or
                    b[1][b[2]]["phases"][b[4][2]] % 2 != b[1][b[2]]["parity"]]
        assert runnable, f"deadlock: {wave} Th={Th} Tm={Tm} K={K} C={C}"
        b = rng.choice(runnable)
        row, st, r, ops, (op, t, s) = b
        me = st[r]
        k, p = divmod(s, per)
        if op == "wait":
            # A parity wait passes on the phase it waits for only if the
            # barrier is not a further phase ahead.
            assert me["phases"][s] == me["waited"][s] + 1, (row, t, s)
            me["waited"][s] += 1
            msg = me["mail"][s]
            assert me["unread"][s] and msg[:3] == (row, t - 1, s), (
                msg, row, t, s)
            me["unread"][s] = False
            if t == Th:
                # Take-and-reseed: the mail is discarded.
                me["state"][s] = start(row, s)
                msg = (*msg[:3], tail_of(row, t, s, zero=True))
            else:
                me["state"][s] = msg[:3]
            for x, (sent_p, _) in tails.items():
                if p == sent_p:
                    me["held"][x][k] = msg[3]
        elif op == "reseed":
            me["state"][s] = start(row, s)
            for x, (sent_p, _) in tails.items():
                if p == sent_p:
                    me["held"][x][k] = ("zero", row, k)
        elif op == "run":
            first = t == 0 or t == Th
            want = (("zero", row, s) if t == 0 and Th > 0 else
                    start(row, s) if first else (row, t - 1, s))
            assert me["state"][s] == want, (me["state"][s], want)
            for x, (_, read_p) in tails.items():
                if p == read_p:
                    assert me["held"][x][k] == (
                        ("zero", row, k) if first else (x, row, t - 1, k)), (
                        me["held"][x][k], x, row, t, k)
            me["state"][s] = (row, t, s)
        elif op == "send":
            nxt = st[(r + 1) % C]
            assert me["state"][s] == (row, t, s)
            assert not nxt["unread"][s], (row, t, s)     # no lost message
            nxt["mail"][s] = (row, t, s, tail_of(row, t, s, zero=False))
            nxt["unread"][s] = True
            nxt["phases"][s] += 1
            assert nxt["phases"][s] <= nxt["waited"][s] + 1
        else:
            me["parity"] ^= 1
        b[4] = next(ops, None)
        steps += 1
    # Every message was read: only the row's last tile sends nothing.
    assert not any(u for b in blocks for u in b[1][b[2]]["unread"])
    return steps


def _tiles(X, reset, tile):
    """(halo tiles [0, reset), seeded tiles [reset, X)), each chain tiled
    from its own start, as HaloChains tiles them."""
    return -(-reset // tile), -(-(X - reset) // tile)


# (rows, X, reset_cell, tile, K, C) in cells of the model's tiles: reset off
# the tile with a ragged halo tile that sends; reset 0; a halo chain of one
# ragged tile, shorter than C; a halo chain of C + 2 tiles; a seeded chain
# of C + 1 tiles with a ragged last tile; packed rows 32 (the gray rung's
# rows at a halo of one ragged tile and C = 3); gray_s8's B4 main launch in
# tiles (2 halo tiles and 64 seeded, a cluster of 16 at K = 4) cut to 20.
PROTO_SHAPES = {
    "ragged-halo": (2, 96, 40, 24, 2, 3),
    "reset0": (2, 96, 0, 24, 2, 3),
    "halo-below-C": (2, 128, 16, 24, 2, 4),
    "halo-ge-C": (2, 80, 40, 8, 1, 3),
    "seeded-C+1": (2, 16 + 4 * 8 + 3, 16, 8, 2, 4),
    "rows32": (32, 40, 4, 8, 1, 3),
    "gray_s8-main": (2, 2 * 4 + 20 * 4, 8, 4, 4, 16),
}


def _proto_cases():
    for wave in WAVES:
        for shape, (rows, X, reset, tile, K, C) in PROTO_SHAPES.items():
            if wave != "B4":
                # One slot a step: K 1, 3 and 8.
                K = {1: 3, 2: 1, 4: 8}[K]
                if shape in ("rows32", "gray_s8-main") and wave == "B15-BE":
                    continue
            yield pytest.param(wave, rows, X, reset, tile, K, C,
                               id=f"{wave}-{shape}-K{K}")


@pytest.mark.parametrize("wave,rows,X,reset,tile,K,C", list(_proto_cases()))
def test_halo_row_protocol(wave, rows, X, reset, tile, K, C):
    Th, Tm = _tiles(X, reset, tile)
    per = WAVES[wave][0]
    S = per * K
    for seed in range(3):
        steps = _run_protocol(wave, rows, Th, Tm, K, C, seed=97 * C + seed)
        T = Th + Tm
        # Every tile but the row's last sends, the halo chain's last too.
        units, mails, flips = T * S, (T - 1) * S, T - 1
        assert steps == rows * (units + 2 * mails + flips)


# The mutant's shapes (rows, Th, Tm, K, C): the halo chain at least C
# tiles long, so that the block of the seeded tile runs a halo tile first
# and its successor's block can still be behind.
MUTANT_SHAPES = {"B4-C3": ("B4", 2, 3, 3, 1, 3),
                 "B4-C4": ("B4", 2, 4, 3, 1, 4),
                 "B15-CN-C2": ("B15-CN", 2, 3, 2, 2, 2),
                 "B15-CN-C3": ("B15-CN", 2, 4, 2, 1, 3),
                 "B15-BE-C2": ("B15-BE", 2, 2, 3, 1, 2)}


@pytest.mark.parametrize("shape", list(MUTANT_SHAPES))
def test_halo_row_skip_take_mutant_fails(shape):
    wave, rows, Th, Tm, K, C = MUTANT_SHAPES[shape]
    broke = 0
    for seed in range(40):
        # The design itself passes at the same shape and seed.
        _run_protocol(wave, rows, Th, Tm, K, C, seed=seed)
        try:
            _run_protocol(wave, rows, Th, Tm, K, C, seed=seed, mutant=True)
        except AssertionError:
            broke += 1
    assert broke > 0


# -- (c) B4's walk in plain PyTorch ------------------------------------------

HBLK = 8                   # the plain version's block
HX = 96                    # packed cells a row: 12 plain blocks


class _B4Tile:
    """One tile of a packed row as bdf2_wave runs it under HaloChains, one
    (step, phase) slot at a time: BE, CN, BE, BDF a step, the half snapshot
    blended per row, step k's p1 edge sent with slot 4k and its h1 edge with
    slot 4k+1. run(s, mail) takes tile t-1's mail (carry, tail) for slot s;
    the row's tile 0 gets None and the chain's first tile past a halo
    chain (`reseed`) discards what it gets: both start from `inflow` and
    zero tails."""

    def __init__(self, kcs, x0, x1, snap_cn, inflow, reseed):
        self.kcs, self.snap_cn, self.inflow = kcs, snap_cn, inflow
        self.x0, self.x1, self.reseed = x0, x1, reseed
        self.zt = torch.zeros_like(x0[:, :1])
        self.tails = {}

    def run(self, s, mail):
        if mail is None or self.reseed:
            carry, tail = self.inflow[s], self.zt
        else:
            carry, tail = mail
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
            self.hs = tuple(cs._pick(self.snap_cn, cn, be)
                            for cn, be in zip(self.c[:2], self.b[:2]))
            return self.c[2], self.hs[1][:, -1:]
        if ph == 2:
            self.d = _tile_substep(BE, kbe, *self.c[:2], x0, x1, *self.hs,
                                   z, z, carry)
            return self.d[2], z
        f = _tile_substep(BDF, kbdf, *self.d[:2], x0, x1, *self.hs,
                          self.tails["e", k], self.tails["h", k], carry)
        self.p0, self.p1 = x0, x1
        self.x0, self.x1 = f[:2]
        return f[2], z

    def outputs(self):
        return (self.x0, self.x1, *self.hs, self.p0, self.p1)


def _halo_tiles(X, reset, tile):
    """The tiles of a packed row as HaloChains lays them out: (first cell,
    end, whether the tile reseeds); the halo chain's, then the seeded
    chain's, each from its own start."""
    out = []
    for s0, s1 in ((0, reset), (reset, X)):
        out += [(t0, min(t0 + tile, s1), t0 == reset > 0)
                for t0 in range(s0, s1, tile)]
    return out


def _b4_launch(kcs, x0, x1, seeds, reset, K, tile, snap_cn, C, seed):
    """A whole B4 launch on packed (rows, X) planes through the unit walk
    on C blocks. Returns halo_bdf2_launch's 7 outputs."""
    rows, X = x0.shape
    zt = torch.zeros((rows, 1), dtype=x0.dtype)
    seeded = [seeds[:, c:c + 1] for c in range(4 * K)]
    tiles = [_B4Tile(kcs, x0[:, a:b], x1[:, a:b], snap_cn,
                     seeded if a >= reset else [zt] * (4 * K), rs)
             for a, b, rs in _halo_tiles(X, reset, tile)]
    outflow = _walk(tiles, 4 * K, C, random.Random(seed))
    planes = [torch.cat(p, 1) for p in zip(*(t.outputs() for t in tiles))]
    return (*planes, torch.cat([m[0] for m in outflow], 1))


# (reset in plain blocks of HBLK, tile, K, symmetric): reset off the tile
# with a ragged halo tile (24 + 16) and a ragged seeded last tile (24, 24,
# 8); reset 0 (4 whole tiles); a halo chain of one ragged tile; a halo
# chain of 6 tiles (at C = 4, T_h >= C); a seeded chain of C + 1 = 6 tiles
# behind a one-tile halo chain at C = 5; a row below one tile (one halo
# tile and one seeded tile).
B4_CASES = {
    "ragged-halo-K2-asym": (5, 24, 2, False),
    "ragged-halo-K1-sym": (5, 24, 1, True),
    "reset0-K2-asym": (0, 24, 2, False),
    "reset0-K3-sym": (0, 24, 3, True),
    "halo-below-tile-K3-asym": (2, 24, 3, False),
    "halo-ge-C-K2-asym": (6, 8, 2, False),
    "seeded-C+1-K1-asym": (1, 16, 1, False),
    "below-one-tile-K2-sym": (5, 128, 2, True),
}


@pytest.mark.parametrize("case", list(B4_CASES))
def test_b4_halo_walk_matches_plain(case):
    reset, tile, K, sym = B4_CASES[case]
    eng = _model_engine(3, False, sym)
    rows = 2 * eng.Bh
    rng = np.random.default_rng(reset + tile + 10 * K + sym)
    B = float(np.asarray(eng.tables.B)[0])
    x0, x1 = (torch.as_tensor(B * rng.uniform(0.5, 1.5, (rows, HX)))
              for _ in range(2))
    seeds = torch.as_tensor(B * rng.uniform(0.5, 6.5, (rows, 4 * K)))
    coef = {k: eng.coef[k].double().reshape(rows, -1) for k in (BE, CN, BDF)}
    kcs = {k: cs._unpack_coef(c) for k, c in coef.items()}
    snap_cn = True if sym else torch.arange(rows)[:, None] < rows // 2
    T = len(_halo_tiles(HX, reset * HBLK, tile))
    serial = _b4_launch(kcs, x0, x1, seeds, reset * HBLK, K, tile, snap_cn,
                        C=1, seed=0)
    for C in sorted({2, 3, min(4 * K, T, 5)} - {1}):
        got = _b4_launch(kcs, x0, x1, seeds, reset * HBLK, K, tile, snap_cn,
                         C=C, seed=C)
        assert all(torch.equal(g, r) for g, r in zip(got, serial)), C
    npass = int(np.log2(HBLK))
    ref = cs.halo_bdf2_launch_ref(
        coef[BE], coef[CN], coef[BDF], seeds, reset, x0, x1, K=K,
        symmetric_half=sym, blk=HBLK, npass_be=npass, npass_cn=npass,
        npass_bdf=npass)
    errs = [_nerr(g, r) for g, r in zip(serial, ref)]
    assert max(errs) <= 1e-12, errs


# -- (d) B15's walk on the plain df sub-step ---------------------------------

@functools.cache
def _df_engine(kind: int, use_corr: bool):
    """The gray deck at M = 4 (4 packed rows), N = HX, optically thin (X =
    0.002, so carries cross tiles), BE or CN, on DFCudaEngine on the
    CPU."""
    cfg = port.load_config(GRAY, M=4, N=HX, X=0.002, ts_method=kind,
                           use_correction=use_corr,
                           psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cd.DFCudaEngine(cfg, tables, block=HBLK, device="cpu")


class _DFStepTile:
    """One tile of a packed row as df_multistep_wave runs it, one step's
    slot at a time, on the plain version's df sub-step over the whole tile
    with an exact scan. run(k, mail) takes tile t-1's mail for slot k:
    (slot state [carry, ccarry, o1 edge, 0], p1 tail (hi, lo)); the row's
    tile 0 gets None and the reseeding tile discards what it gets: both
    start from `start` (seed_row's slots) with zero tails and run the
    sub-step with `first` set. It returns this tile's mail."""

    def __init__(self, kind, kb, kd, x, use_corr, start, reseed):
        n = x[0].shape[1]
        self.masks = torch.as_tensor(cs._scan_masks(n))
        self.npass = len(cs._scan_strides(n))
        self.col0 = torch.arange(n)[None, :] < 1
        self.kind, self.kb, self.kd, self.x = kind, kb, kd, x
        self.use_corr, self.start, self.reseed = use_corr, start, reseed
        self.zt = torch.zeros_like(x[0][:, :1])

    def run(self, k, mail):
        first = mail is None or self.reseed
        if first:
            slot, tail = list(self.start[k]), (self.zt, self.zt)
        else:
            slot, tail = list(mail[0]), mail[1]
        x = self.x
        f = cd._df_substep_block(
            self.kind, self.kb, self.kd, self.col0, first, self.masks,
            self.use_corr, x, x if self.kind == CN else None, None, tail,
            None, slot, self.npass, self.npass)
        self.prev, self.x = x, f
        return slot, (x[2][:, -1:], x[3][:, -1:])

    def outputs(self):
        return (*self.x, *self.prev)


def _b15_launch(eng, kind, seeds_h, seeds_l, reset, x, K, tile, C, seed):
    """A whole B15 launch on packed (rows, X) planes through the unit walk
    on C blocks. Returns the 8 planes and the record's hi and lo."""
    rows, X = x[0].shape
    kb = cs._unpack_coef(eng.coef[kind].reshape(rows, -1))
    kd = cd._unpack_dfc(eng.dcoef[kind].reshape(rows, -1), kb)
    zt = torch.zeros((rows, 1))
    halo = cd._df_chain_slots(K, None, None, zt)
    seeded = cd._df_chain_slots(K, seeds_h, seeds_l, zt)
    tiles = [_DFStepTile(kind, kb, kd, tuple(p[:, a:b] for p in x),
                         bool(eng.cfg.use_correction),
                         seeded if a >= reset else halo, rs)
             for a, b, rs in _halo_tiles(X, reset, tile)]
    outflow = _walk(tiles, K, C, random.Random(seed))
    planes = [torch.cat(p, 1) for p in zip(*(t.outputs() for t in tiles))]
    return (*planes, *cd._df_record([m[0] for m in outflow]))


# (kind, reset in plain blocks, tile, K, use_correction): reset off the
# tile with a ragged halo tile (24 + 16) and seeded chain (24, 24, 8);
# reset 0; a halo chain of one ragged tile; a halo chain of 6 tiles (T_h
# >= C); BE and CN, K 1 and 3, the correction source on and off.
B15_CASES = {
    "CN-ragged-halo-K3-corr": (CN, 5, 24, 3, True),
    "CN-ragged-halo-K1-nocorr": (CN, 5, 24, 1, False),
    "CN-reset0-K3-corr": (CN, 0, 24, 3, True),
    "CN-halo-below-tile-K1-corr": (CN, 2, 24, 1, True),
    "CN-halo-ge-C-K3-nocorr": (CN, 6, 8, 3, False),
    "BE-ragged-halo-K3-corr": (BE, 5, 24, 3, True),
    "BE-reset0-K1-nocorr": (BE, 0, 24, 1, False),
    "BE-halo-ge-C-K3-corr": (BE, 6, 8, 3, True),
}


@pytest.mark.parametrize("case", list(B15_CASES))
def test_b15_halo_walk_matches_plain(case):
    kind, reset, tile, K, corr = B15_CASES[case]
    eng = _df_engine(kind, corr)
    rows = 2 * eng.Bh
    rng = np.random.default_rng(kind + reset + tile + 10 * K + corr)
    B = float(np.asarray(eng.tables.B)[0])
    his = [torch.as_tensor(B * rng.uniform(0.5, 1.5, (rows, HX)),
                           dtype=torch.float32) for _ in range(2)]
    los = [h * torch.as_tensor(rng.uniform(-0.5, 0.5, (rows, HX)) * 2.0 ** -24,
                               dtype=torch.float32) for h in his]
    x = (his[0], los[0], his[1], los[1])
    sh = torch.as_tensor(B * rng.uniform(0.5, 6.5, (rows, K)),
                         dtype=torch.float32)
    sl = sh * torch.as_tensor(rng.uniform(-0.5, 0.5, sh.shape) * 2.0 ** -24,
                              dtype=torch.float32)
    T = len(_halo_tiles(HX, reset * HBLK, tile))
    serial = _b15_launch(eng, kind, sh, sl, reset * HBLK, x, K, tile, C=1,
                         seed=0)
    for C in sorted({2, min(K, T, 4)} - {1}):
        got = _b15_launch(eng, kind, sh, sl, reset * HBLK, x, K, tile, C=C,
                          seed=C)
        assert all(torch.equal(g, r) for g, r in zip(got, serial)), C
    npass = int(np.log2(HBLK))
    ref = cd.df_halo_multistep_launch_ref(
        kind, eng.coef[kind].reshape(rows, -1),
        eng.dcoef[kind].reshape(rows, -1), sh, sl, reset, *x, K=K,
        use_corr=corr, blk=HBLK, npass=npass, npass_c=npass)
    errs = []
    for i in range(0, 10, 2):
        got = serial[i].double() + serial[i + 1].double()
        want = ref[i].double() + ref[i + 1].double()
        errs.append(float((got - want).abs().max() / want.abs().max()))
    assert max(errs) <= 1e-12, errs
