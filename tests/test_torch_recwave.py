"""Models of B11's and B14's cluster wavefronts, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py phases 8
and 10 hold them against their plain versions there). These tests hold the
two designs' arithmetic and protocol in plain PyTorch and Python:

* (a) B11 (csrc/adjoint.cu fwd_record_k_kernel) is B1's wavefront walk
  (csrc/wave.cuh bdf2_wave) with a record hook: each (tile, slot) a unit,
  run in a seeded random order that C blocks could take (tile t on block
  t mod C, each block's units in order, a unit ready when tile t-1's mail
  for its slot is in the mailbox), each slot's entering carry, each step's
  upwind e1 and hs1 edges (the tails that ride with slots 4k and 4k+1) and
  the inputs of steps 1..K-1 recorded per tile. Held bit for bit against
  the same walk in serial order, its records and intermediate inputs bit
  for bit against K chained one-step walks (K B9 launches), and against
  ``fwd_record_k_launch_ref`` evaluated in float64 with npass = log2(blk),
  so that its block scan is exact, within 1e-12 (the records at the plain
  version's blocks that start the model's tiles): both boundaries, both
  half modes, a ragged last tile, T = C + 1, a row below one tile.
* (b) B14's protocol (csrc/df_sweep.cu df_halo_bdf2_kernel on
  csrc/cluster.cuh's mailboxes): each packed row's two chains, [0,
  reset_cell) from zero and [reset_cell, X) from the seeds, on a cluster
  of C blocks each, under seeded random interleavings of every block of
  the launch. Every read gets what the tile upstream in its own chain
  wrote; no write lands on an unread entry; no barrier runs two phases
  ahead of its waiter; every block finishes (blocks beyond a short
  chain's tiles only open and close their mailboxes). Reset off the tile
  with a ragged halo chain, reset 0, a halo chain shorter than C, a
  seeded chain of C + 1 tiles.
* (c) The mutant that cluster.cuh rules out: both chains of a row on ONE
  cluster, the seeded tile mid-row waiting on no mail. Some seeded
  interleaving must break (b)'s checks.
* (d) B14's chains in plain PyTorch: the same unit walk on the df
  sub-step of the plain version (``cuda_df._df_substep_block`` over a
  whole tile with an exact scan), each chain's first tile seeded as
  seed_row seeds it, against ``df_halo_bdf2_launch_ref`` with exact block
  scans within 1e-12 in hi + lo (max|d(hi+lo)| / max|hi+lo|), bit for bit
  against the serial walk; the record from the seeded chain's last tile.

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
from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca
from radiative_transfer_tpu_torch.ops import cuda_df as cd
from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN
from test_torch_rowsplit import MN, _model_engine, _nerr, _WaveTile

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")


def _walk(tiles, S, C, rng):
    """Runs the units (t, s) of one chain's tiles on C blocks in an order
    drawn from `rng` (tile after tile for C = 1): tile t on block t mod C,
    each block's units in order, a unit ready when tile t-1's mail for its
    slot is in the mailbox. tiles[t].run(s, mail) takes tile t-1's mail
    (None for the chain's first tile) and returns this tile's. Returns the
    last tile's mail per slot (the chain's outflow)."""
    T = len(tiles)
    queues = [[(t, s) for t in range(r, T, C) for s in range(S)]
              for r in range(C)]
    mailbox, outflow = {}, [None] * S
    while any(queues):
        ready = [q for q in queues
                 if q and (q[0][0] == 0 or (q[0][0] - 1, q[0][1]) in mailbox)]
        assert ready, f"deadlock: C={C} T={T} S={S}"
        q = rng.choice(ready)
        t, s = q.pop(0)
        mail = tiles[t].run(s, mailbox.pop((t - 1, s), None))
        if t + 1 < T:
            assert (t, s) not in mailbox
            mailbox[t, s] = mail
        else:
            outflow[s] = mail
    assert not mailbox
    return outflow


# -- (a) B11: B1's walk with the record hook ----------------------------------

RBLK = 8                   # the plain version's block: divides every tile
# The model's tiles on MN = 96 cells: a ragged last one (40, 40, 16; T =
# C + 1 at C = 2), whole tiles (4 of 24; T = C + 1 at C = 3), a row below
# one tile.
RTILES = {"ragged": 40, "whole": 24, "below-one-tile": 128}


class _RecTile(_WaveTile):
    """A tile of B1's walk (test_torch_rowsplit._WaveTile) with B11's record
    hook (csrc/adjoint.cu KRecords): each slot's carry entering the tile,
    step k's upwind e1 and hs1 edges (the tails that slots 4k and 4k+1
    bring: zero for the row's first tile), and step k's input."""

    def __init__(self, kcs, x0, x1, snap_cn, inflow):
        super().__init__("B1", kcs, x0, x1, snap_cn, inflow)
        self.rc, self.ret, self.rht, self.ins = {}, {}, {}, {}

    def run(self, s, mail):
        carry, tail = mail if mail is not None else (self.inflow[s],
                                                     self.zt)
        k, ph = divmod(s, 4)
        self.rc[s] = carry
        if ph == 0:
            self.ret[k] = tail
            self.ins[k] = (self.x0, self.x1)
        elif ph == 1:
            self.rht[k] = tail
        carry, tail = super().run(s, mail)
        return carry, tail if tail is not None else self.zt


def _b11_launch(eng, x0, x1, K, tile, C, seed):
    """A whole B11 launch on (2, Bh, N) planes through the walk: the mu<0
    half, then the mu>0 half from the boundary or the flipped mu<0 outflow.
    Returns fwd_record_k_launch's 11 outputs, records per model tile."""
    rng = random.Random(seed)
    N = x0.shape[-1]
    T = -(-N // tile)
    S = 4 * K
    s_of = [eng.kcs[k].s for _ in range(K) for k in (BE, CN, BE, BDF)]
    coef = {k: eng.coef[k].to(x0.dtype) for k in (BE, CN, BDF)}
    bc = eng.bc.to(x0.dtype)
    halves, outflow = [], None
    for h in (0, 1):
        if h == 1 and eng.reflective:
            inflow = [s * c[0][eng.flip.long()]
                      for s, c in zip(s_of, outflow)]
        else:
            inflow = [s * bc[h] for s in s_of]
        kcs = {k: cs._unpack_coef(coef[k][h]) for k in coef}
        snap_cn = bool(eng.cfg.bdf2_symmetric_half) or h == 0
        tiles = [_RecTile(kcs, x0[h][:, t * tile:(t + 1) * tile],
                          x1[h][:, t * tile:(t + 1) * tile], snap_cn, inflow)
                 for t in range(T)]
        outflow = _walk(tiles, S, C, rng)
        planes = [torch.cat(p, 1) for p in zip(*(x.outputs() for x in tiles))]

        def per_tile(attr, n):
            return torch.stack([torch.cat([getattr(x, attr)[i] for x in tiles],
                                          1) for i in range(n)])

        ri = [torch.stack([torch.cat([x.ins[k][i] for x in tiles], 1)
                           for k in range(1, K)]) if K > 1 else
              x0.new_empty((0, *x0.shape[1:])) for i in (0, 1)]
        halves.append((*planes, per_tile("rc", S), per_tile("ret", K),
                       per_tile("rht", K), *ri))
    out = [torch.stack(p) for p in zip(*halves)]
    # ri: (K-1, 2, Bh, N), as the kernels lay them out.
    return (*out[:9], *(r.transpose(0, 1) for r in out[9:]))


def _chained(eng, x0, x1, K, tile):
    """K one-step walks (K B9 launches), each from the last one's ends:
    their records and the inputs of steps 1..K-1, laid out as B11's."""
    ins, recs = [(x0, x1)], []
    for _ in range(K):
        o = _b11_launch(eng, *ins[-1], 1, tile, C=1, seed=0)
        recs.append(o[6:9])
        ins.append(o[:2])
    return (torch.cat([r[0] for r in recs], 1),
            torch.cat([r[1] for r in recs], 1),
            torch.cat([r[2] for r in recs], 1),
            *(torch.stack([x[i] for x in ins[1:K]]) if K > 1 else
              x0.new_empty((0, *x0.shape)) for i in (0, 1)))


def _b11_cases():
    """K = 2 on every boundary, half mode and tile shape; K = 1 and 3 on
    two of them."""
    cases = [(refl, sym, tname, 2) for refl in (True, False)
             for sym in (False, True) for tname in RTILES]
    cases += [(True, False, "whole", 1), (False, True, "ragged", 3)]
    for refl, sym, tname, K in cases:
        yield pytest.param(refl, sym, tname, K,
                           id=f"{'refl' if refl else 'src'}-"
                           f"{'sym' if sym else 'asym'}-{tname}-K{K}")


@pytest.mark.parametrize("refl,sym,tname,K", list(_b11_cases()))
def test_b11_wavefront_model_matches_plain(refl, sym, tname, K):
    eng = _model_engine(3, refl, sym)
    tile = RTILES[tname]
    T = -(-MN // tile)
    rng = np.random.default_rng(tile + 10 * refl + sym)
    B = float(np.asarray(eng.tables.B)[0])
    x0, x1 = (torch.as_tensor(B * rng.uniform(0.5, 1.5, (2, eng.Bh, MN)))
              for _ in range(2))
    serial = _b11_launch(eng, x0, x1, K, tile, C=1, seed=0)
    # Every order C blocks could take: C = 2, T - 1 (T = C + 1) and T.
    for C in sorted({2, T - 1, min(4 * K, T)} - {0, 1}):
        got = _b11_launch(eng, x0, x1, K, tile, C=C, seed=C)
        assert all(torch.equal(g, r) for g, r in zip(got, serial)), C
    # Records and intermediate inputs: those of K chained one-step walks.
    chained = _chained(eng, x0, x1, K, tile)
    assert all(torch.equal(g, r) for g, r in zip(serial[6:], chained))
    coef = {k: c.double() for k, c in eng.coef.items()}
    npass = int(np.log2(RBLK))
    ref = ca.fwd_record_k_launch_ref(
        coef[BE], coef[CN], coef[BDF], eng.bc.double(), eng.flip, x0, x1,
        K=K, ts_method=3, s_be=eng.kcs[BE].s, s_cn=eng.kcs[CN].s,
        s_bdf=eng.kcs[BDF].s, reflective=eng.reflective, symmetric_half=sym,
        blk=RBLK, npass={BE: npass, CN: npass, BDF: npass})
    errs = [_nerr(g, r) for g, r in zip(serial[:6] + serial[9:],
                                        ref[:6] + ref[9:]) if r.numel()]
    # The records at the plain version's blocks that start the tiles.
    at = torch.arange(T) * (tile // RBLK)
    errs += [float((g - r[..., at]).abs().max() / r.abs().max())
             for g, r in zip(serial[6:9], ref[6:9])]
    assert max(errs) <= 1e-12, errs


# -- (b, c) B14's two-chain protocol, and the shared-cluster mutant -----------

# Per tail: (the slot phase that carries it, the phase before whose
# sub-step the receiving tile reads it), as B6's.
TAILS = {"e": (0, 0), "h": (1, 2)}


def _clusters(TA, TB, shared):
    """The launch's clusters, each a list of its tiles in order as (chain,
    tile of the chain, tiles of the chain): one cluster a chain (B14; no
    halo cluster where reset_cell is 0), or with `shared` the mutant's one
    cluster holding the halo chain's tiles and then the seeded chain's."""
    a = [("A", t, TA) for t in range(TA)]
    b = [("B", t, TB) for t in range(TB)]
    if shared:
        return [a + b]
    return [b] + ([a] if TA else [])


def _ops(tiles, rank, C, K):
    """One block's operations as df_bdf2_wave runs them: its tiles rank,
    rank + C, ...; per tile and slot (for a tile that is not its chain's
    first) a wait on the slot's barrier with the block's parity and a copy
    of its mailbox, the sub-step, and (unless it is its chain's last tile)
    a send to block rank + 1 mod C; the parity flips after a tile that
    waited."""
    for g in range(rank, len(tiles), C):
        chain, t, T = tiles[g]
        for s in range(4 * K):
            if t > 0:
                yield ("wait", chain, t, s)
            yield ("run", chain, t, s)
            if t + 1 < T:
                yield ("send", chain, t, s)
        if t > 0:
            yield ("flip", chain, t, 0)


def _run_b14_protocol(TA, TB, K, C, seed, shared=False):
    """Every block of the launch under one seeded random interleaving;
    asserts every property on the way. Returns the steps taken."""
    S = 4 * K
    rng = random.Random(seed)
    blocks = []
    for tiles in _clusters(TA, TB, shared):
        # Per block of the cluster: mailbox (message, read?), completed
        # barrier phases, passed waits, parity, the slots' and tails'
        # state in shared memory.
        st = [dict(mail=[None] * S, unread=[False] * S, phases=[0] * S,
                   waited=[0] * S, state=[None] * S,
                   held={x: [None] * K for x in TAILS}, parity=0)
              for _ in range(C)]
        for r in range(C):
            ops = _ops(tiles, r, C, K)
            blocks.append([st, r, ops, next(ops, None)])
    steps = 0
    while True:
        live = [b for b in blocks if b[3] is not None]
        if not live:
            break
        runnable = []
        for b in live:
            me = b[0][b[1]]
            if b[3][0] != "wait" or me["phases"][b[3][3]] % 2 != me["parity"]:
                runnable.append(b)
        assert runnable, f"deadlock: TA={TA} TB={TB} K={K} C={C}"
        b = rng.choice(runnable)
        st, r, ops, (op, chain, t, s) = b
        me = st[r]
        k, p = divmod(s, 4)
        if op == "wait":
            # A parity wait passes on the phase it waits for only if the
            # barrier is not a further phase ahead.
            assert me["phases"][s] == me["waited"][s] + 1, (chain, t, s)
            me["waited"][s] += 1
            msg = me["mail"][s]
            assert me["unread"][s] and msg[:3] == (chain, t - 1, s), (
                msg, chain, t, s)
            me["unread"][s] = False
            me["state"][s] = msg[:3]
            for x, (sent_p, _) in TAILS.items():
                if p == sent_p:
                    me["held"][x][k] = msg[3]
        elif op == "run":
            if t > 0:
                assert me["state"][s] == (chain, t - 1, s)
                for x, (_, read_p) in TAILS.items():
                    if p == read_p:
                        assert me["held"][x][k] == (x, chain, t - 1, k)
            me["state"][s] = (chain, t, s)
        elif op == "send":
            nxt = st[(r + 1) % C]
            assert me["state"][s] == (chain, t, s)
            assert not nxt["unread"][s], (chain, t, s)     # no lost message
            tail = next(((x, chain, t, k) for x, (sent_p, _) in TAILS.items()
                         if p == sent_p), None)
            nxt["mail"][s] = (chain, t, s, tail)
            nxt["unread"][s] = True
            nxt["phases"][s] += 1
            assert nxt["phases"][s] <= nxt["waited"][s] + 1
        else:
            me["parity"] ^= 1
        b[3] = next(ops, None)
        steps += 1
    # Every message was read: a chain's last tile sends nothing.
    assert not any(u for b in blocks for u in b[0][b[1]]["unread"])
    return steps


def _tiles(X, reset, tile):
    """(halo tiles [0, reset), seeded tiles [reset, X)), each chain tiled
    from its own start."""
    return -(-reset // tile), -(-(X - reset) // tile)


# (X, reset_cell, tile, K, C): reset off the tile with a ragged halo chain;
# reset 0; a halo chain shorter than C; a seeded chain of C + 1 tiles;
# gray_s8's main launch in tiles (a 4-tile halo chain, 128 seeded tiles at
# K = 2) at a cluster of 7.
B14_SHAPES = {
    "ragged-halo": (96, 40, 24, 2, 2),
    "ragged-halo-C3": (96, 40, 24, 1, 3),
    "reset0": (96, 0, 24, 2, 3),
    "reset0-C1": (96, 0, 24, 1, 1),
    "halo-below-C": (128, 16, 8, 2, 6),
    "halo-below-C-K1": (128, 16, 8, 1, 4),
    "seeded-C+1": (64 + 5 * 8, 64, 8, 2, 4),
    "seeded-C+1-halo-long": (200 + 5 * 8, 200, 8, 1, 4),
    "gray_s8-main": ((2 + 64) * 8, 2 * 8, 2, 2, 7),
    "gray_s8-fixup": (4 * 8, 0, 8, 2, 4),
    "K3-C12": (20 * 8 + 3, 5 * 8 + 1, 8, 3, 12),
}


@pytest.mark.parametrize("shape", list(B14_SHAPES))
def test_b14_two_chain_protocol(shape):
    X, reset, tile, K, C = B14_SHAPES[shape]
    TA, TB = _tiles(X, reset, tile)
    for seed in range(3):
        steps = _run_b14_protocol(TA, TB, K, C, seed=100 * C + seed)
        units = (TA + TB) * 4 * K
        mails = (max(TA - 1, 0) + TB - 1) * 4 * K
        flips = max(TA - 1, 0) + TB - 1
        assert steps == units + 2 * mails + flips


# The mutant's shapes: the halo chain at least C tiles long, so that the
# block of the seeded tile runs a halo tile first and can run ahead.
MUTANT_SHAPES = {"C4": (4, 6, 2, 4), "C3-K1": (3, 5, 1, 3),
                 "C2": (2, 4, 2, 2)}


@pytest.mark.parametrize("shape", list(MUTANT_SHAPES))
def test_b14_shared_cluster_mutant_fails(shape):
    TA, TB, K, C = MUTANT_SHAPES[shape]
    broke = 0
    for seed in range(40):
        # The design itself passes at the same shape and seed.
        _run_b14_protocol(TA, TB, K, C, seed=seed)
        try:
            _run_b14_protocol(TA, TB, K, C, seed=seed, shared=True)
        except AssertionError:
            broke += 1
    assert broke > 0


# -- (d) B14's chains in plain PyTorch ---------------------------------------

DBLK = 8                   # the plain version's block
DX = 96                    # packed cells a row: 12 plain blocks


@functools.cache
def _df_engine(symmetric: bool, use_corr: bool):
    """The gray deck at M = 4 (4 packed rows), N = DX, optically thin (X =
    0.002, so carries cross tiles), on DFCudaEngine on the CPU."""
    cfg = port.load_config(GRAY, M=4, N=DX, X=0.002, ts_method=3,
                           bdf2_symmetric_half=symmetric,
                           use_correction=use_corr,
                           psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cd.DFCudaEngine(cfg, tables, block=DBLK, device="cpu")


class _DFTile:
    """One tile of one B14 chain as df_bdf2_wave runs it, one (step, phase)
    slot at a time, on the plain version's df sub-step over the whole tile
    with an exact scan. run(s, mail) takes tile t-1's mail for slot s:
    (slot state [carry, ccarry, o1 edge, 0], tail (hi, lo)), None for the
    chain's first tile, whose slots start as `start` (seed_row's) and its
    tails at zero; it returns this tile's mail."""

    def __init__(self, kbs, kds, x, snap_cn, use_corr, start):
        n = x[0].shape[1]
        npass = len(cs._scan_strides(n))
        self.masks = torch.as_tensor(cs._scan_masks(n))
        self.npass = npass
        self.col0 = torch.arange(n)[None, :] < 1
        self.kbs, self.kds, self.x = kbs, kds, x
        self.snap_cn, self.use_corr, self.start = snap_cn, use_corr, start
        self.zt = torch.zeros_like(x[0][:, :1])
        self.tails = {}

    def _phase(self, k, kind, first, slot, e, p=None, hpl=None, ptail=None,
               htail=None):
        return cd._df_substep_block(
            kind, self.kbs[kind], self.kds[kind], self.col0, first,
            self.masks, self.use_corr, e, p, hpl, ptail, htail, slot,
            self.npass, self.npass)

    def run(self, s, mail):
        k, ph = divmod(s, 4)
        first = mail is None
        if first:
            slot, tail = list(self.start[s]), (self.zt, self.zt)
        else:
            slot, tail = list(mail[0]), mail[1]
        x, z = self.x, (self.zt, self.zt)
        if ph == 0:
            self.tails["e", k] = tail
            self.b = self._phase(k, BE, first, slot, x)
            out = (x[2][:, -1:], x[3][:, -1:])
        elif ph == 1:
            self.tails["h", k] = tail
            self.c = self._phase(k, CN, first, slot, self.b, p=x,
                                 ptail=self.tails["e", k])
            self.hs = tuple(cs._pick(self.snap_cn, a, bb)
                            for a, bb in zip(self.c, self.b))
            out = (self.hs[2][:, -1:], self.hs[3][:, -1:])
        elif ph == 2:
            self.d = self._phase(k, BE, first, slot, self.c)
            out = z
        else:
            f = self._phase(k, BDF, first, slot, self.d, p=x, hpl=self.hs,
                            ptail=self.tails["e", k],
                            htail=self.tails["h", k])
            self.prev, self.x = x, f
            out = z
        return slot, out

    def outputs(self):
        return (*self.x, *self.hs, *self.prev)


def _b14_launch(eng, seeds_h, seeds_l, reset, x, K, tile, C, seed):
    """A whole B14 launch on packed (rows, X) planes: each row's chains
    [0, reset) from zero slots and [reset, X) from the seeds, each through
    the unit walk on C blocks. Returns the 12 planes and the record."""
    rng = random.Random(seed)
    rows, X = x[0].shape
    kbs = {k: cs._unpack_coef(eng.coef[k].reshape(rows, -1))
           for k in (BE, CN, BDF)}
    kds = {k: cd._unpack_dfc(eng.dcoef[k].reshape(rows, -1), kbs[k])
           for k in (BE, CN, BDF)}
    sym = bool(eng.cfg.bdf2_symmetric_half)
    snap_cn = True if sym else torch.arange(rows)[:, None] < rows // 2
    zt = torch.zeros((rows, 1))
    outs = [torch.empty_like(x[0]) for _ in range(12)]
    record = None
    for s0, s1, seeded in ((0, reset, False), (reset, X, True)):
        if s0 == s1:
            continue
        start = cd._df_chain_slots(4 * K, seeds_h if seeded else None,
                                   seeds_l, zt)
        tiles = [_DFTile(kbs, kds, tuple(p[:, t0:min(t0 + tile, s1)]
                                          for p in x),
                         snap_cn, eng.cfg.use_correction, start)
                 for t0 in range(s0, s1, tile)]
        outflow = _walk(tiles, 4 * K, C, rng)
        for o, p in zip(outs, zip(*(t.outputs() for t in tiles))):
            o[:, s0:s1] = torch.cat(p, 1)
        if seeded:
            record = cd._df_record([m[0] for m in outflow])
    return (*outs, *record)


# (X blocks of DBLK at reset, tile, K, sym, use_correction): reset off the
# tile with a ragged halo chain (24 + 16) and seeded chain (24, 24, 8);
# reset 0 (4 whole tiles); a halo chain of 2 tiles (shorter than C = 3)
# and a seeded one of 10; K 1 and 2, both half modes, the correction
# source on and off.
DF_CASES = {
    "ragged-halo-K2-asym": (5, 24, 2, False, True),
    "ragged-halo-K1-sym-nocorr": (5, 24, 1, True, False),
    "reset0-K2-asym": (0, 24, 2, False, True),
    "reset0-K1-sym": (0, 24, 1, True, True),
    "halo-below-C-K1-asym-nocorr": (2, 8, 1, False, False),
}


@pytest.mark.parametrize("case", list(DF_CASES))
def test_b14_chain_model_matches_plain(case):
    reset, tile, K, sym, corr = DF_CASES[case]
    eng = _df_engine(sym, corr)
    rows = 2 * eng.Bh
    rng = np.random.default_rng(reset + tile + K)
    B = float(np.asarray(eng.tables.B)[0])
    his = [torch.as_tensor(B * rng.uniform(0.5, 1.5, (rows, DX)),
                           dtype=torch.float32) for _ in range(2)]
    los = [h * torch.as_tensor(rng.uniform(-0.5, 0.5, (rows, DX)) * 2.0 ** -24,
                               dtype=torch.float32) for h in his]
    x = (his[0], los[0], his[1], los[1])
    sh = torch.as_tensor(B * rng.uniform(0.5, 6.5, (rows, 4 * K)),
                         dtype=torch.float32)
    sl = sh * torch.as_tensor(rng.uniform(-0.5, 0.5, sh.shape) * 2.0 ** -24,
                              dtype=torch.float32)
    serial = _b14_launch(eng, sh, sl, reset * DBLK, x, K, tile, C=1, seed=0)
    for C in (2, 3):
        got = _b14_launch(eng, sh, sl, reset * DBLK, x, K, tile, C=C, seed=C)
        assert all(torch.equal(g, r) for g, r in zip(got, serial)), C
    npass = {k: int(np.log2(DBLK)) for k in (BE, CN, BDF)}
    ref = cd.df_halo_bdf2_launch_ref(
        *(eng.coef[k].reshape(rows, -1) for k in (BE, CN, BDF)),
        *(eng.dcoef[k].reshape(rows, -1) for k in (BE, CN, BDF)), sh, sl,
        reset, *x, K=K, symmetric_half=sym, use_corr=corr, blk=DBLK,
        npass=npass, npass_c=npass)
    errs = []
    for i in range(0, 14, 2):
        got = serial[i].double() + serial[i + 1].double()
        want = ref[i].double() + ref[i + 1].double()
        errs.append(float((got - want).abs().max() / want.abs().max()))
    assert max(errs) <= 1e-12, errs
