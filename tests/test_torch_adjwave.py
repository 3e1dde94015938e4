"""Models of B10's and B12's reversed cluster wavefront, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py phases 9
and 10 hold them against their plain versions there). These tests hold the
design's protocol and arithmetic in plain Python and PyTorch:

* (a) The protocol of csrc/adjoint.cu bwd_block on csrc/cluster.cuh's
  mailboxes, under seeded random interleavings of the C blocks of a row's
  cluster: a prologue (block r runs the record tiles r, r + C, ... and
  writes each of their sub-tiles' entries of the scratch), a cluster
  barrier, then the wavefront: the u-th sub-tile from the row's end on
  block u mod C, its slots in the backward's order (step K-1 down to 0,
  phases 3, 2, 1, 0), each (for u > 0) a wait on the slot's barrier with
  the block's parity and a copy of its mailbox, the slot's adjoint phase,
  and (unless the sub-tile is the row's first) a send to block (u+1) mod
  C; the parity flips after each sub-tile that waited; then each block's
  gradient partial, a cluster barrier, rank 0's reduction and the closing
  barrier. Checked on the way: the mail flows from sub-tile u to u+1 in
  slot order and every read gets what sub-tile u-1 wrote for that slot;
  the hs1-shift cotangent travels with slot (k, 3) and the e1-shift one
  with slot (k, 1) (BDF2; CN: slot k), and each is sub-tile u-1's where
  it is read (after phase 2 and phase 0); no write lands on an unread
  entry; no barrier runs two phases ahead of its waiter; the scratch is
  read only after every block wrote its part of it; rank 0 reads every
  partial after it is written; the block that ran the row's first
  sub-tile holds every slot's lambda from it; every block finishes.
* (b) The reversed walk in plain PyTorch: each (sub-tile, slot) a unit
  (the slot's adjoint phase, a step's forward recomputed before its
  phase-3 unit), run in a seeded random order that C blocks could take
  (sub-tile u on block u mod C, each block's units in order, a unit ready
  when sub-tile u-1's mail for its slot is in the mailbox), lambdas and
  shift cotangents passed through a mailbox dict, each sub-tile's forward
  carries and hs1 edges from a prologue over the record tiles, the
  gradient packs summed per block and then over the blocks in rank order.
  Held bit for bit against the same model in serial order (the sub-tiles
  one after another) at the same C; its state cotangents bit for bit
  against the model at C = 1; and against ``bwd_launch_ref`` /
  ``bwd_k_launch_ref`` evaluated in float64 with npass = log2(blk), so
  that their block scans are exact, within 1e-12 (records from
  ``fwd_record_launch_ref`` / ``fwd_record_k_launch_ref`` the same way):
  BE, CN and BDF2 at K = 1 (B10), BDF2 at K = 2, 3 and 4 (B12), reflective
  and source left boundaries, both half modes, a ragged last sub-tile,
  whole sub-tiles, a row below one record tile.

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
from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")

# -- (a) the reversed wavefront's protocol -----------------------------------

# Per walk: phases a step and, per shift cotangent, (the phase whose slot
# carries it, the phase after whose adjoint the receiving sub-tile reads it).
WALKS = {
    "BDF2": (4, {"h": (3, 2), "e": (1, 0)}),
    "CN": (1, {"e": (0, 0)}),
    "BE": (1, {}),
}


class _Block:
    """One cluster block of B10/B12 (csrc/adjoint.cu bwd_block), as a list
    of operations: its prologue tiles, the cluster barrier, its sub-tiles
    of the wavefront (per slot in the backward's order: a wait for u > 0,
    the phase, a send unless the sub-tile is the row's first, and the
    reads of shift cotangents after phases 2 and 0), the parity flips, the
    row-start record, the partial, the reduction barrier, rank 0's
    reduction, the closing barrier."""

    def __init__(self, rank, C, G, ntiles, K, walk):
        self.rank, self.C, self.G, self.ntiles, self.K = rank, C, G, ntiles, K
        self.nph, self.tails = WALKS[walk]
        self.parity = 0
        self.ops = self._ops()
        self.pending = next(self.ops, None)

    def _ops(self):
        for t in range(self.rank, self.ntiles, self.C):
            yield ("prologue", t, 0, 0, 0)
        yield ("arrive", "scratch", 0, 0, 0)
        yield ("pass", "scratch", 0, 0, 0)
        nph = self.nph
        for u in range(self.rank, self.G, self.C):
            yield ("load", u, 0, 0, 0)
            for k in reversed(range(self.K)):
                for p in reversed(range(nph)):
                    s = nph * k + p
                    if u > 0:
                        yield ("wait", u, s, k, p)
                    yield ("run", u, s, k, p)
                    if u + 1 < self.G:
                        yield ("send", u, s, k, p)
                    for x, (_, read_p) in self.tails.items():
                        if p == read_p:
                            yield ("tail", u, x, k, p)
            if u > 0:
                yield ("flip", u, 0, 0, 0)
        if self.rank == (self.G - 1) % self.C:
            yield ("row start", self.G - 1, 0, 0, 0)
        yield ("partial", 0, 0, 0, 0)
        yield ("arrive", "partials", 0, 0, 0)
        yield ("pass", "partials", 0, 0, 0)
        if self.rank == 0:
            yield ("reduce", 0, 0, 0, 0)
        yield ("arrive", "close", 0, 0, 0)
        yield ("pass", "close", 0, 0, 0)


def _run_protocol(C, G, K, walk, nsub, seed):
    """Runs the protocol under one seeded random interleaving; returns the
    count of each kind of operation. Asserts every property on the way."""
    nph, tails = WALKS[walk]
    S = nph * K
    ntiles = -(-G // nsub)
    rng = random.Random(seed)
    blocks = [_Block(r, C, G, ntiles, K, walk) for r in range(C)]
    mail = [[None] * S for _ in range(C)]
    unread = [[False] * S for _ in range(C)]
    phases = [[0] * S for _ in range(C)]
    waited = [[0] * S for _ in range(C)]
    state = [[None] * S for _ in range(C)]       # each slot's lambda
    held = {x: [[("init", x, k) for k in range(K)] for _ in range(C)]
            for x in tails}
    scratch = [False] * G                        # sub-tile entries written
    arrived = {"scratch": set(), "partials": set(), "close": set()}
    partial = [False] * C
    reduced = False
    counts = {}
    while True:
        live = [b for b in blocks if b.pending is not None]
        if not live:
            break
        runnable = []
        for b in live:
            op, a1, s, k, p = b.pending
            if op == "wait" and phases[b.rank][s] % 2 == b.parity:
                continue
            if op == "pass" and len(arrived[a1]) < C:
                continue
            runnable.append(b)
        assert runnable, f"deadlock: {walk} C={C} G={G} K={K}"
        b = rng.choice(runnable)
        r = b.rank
        op, a1, s, k, p = b.pending
        counts[op] = counts.get(op, 0) + 1
        if op == "prologue":
            for g in range(a1 * nsub, min((a1 + 1) * nsub, G)):
                assert not scratch[g]
                scratch[g] = True
        elif op == "arrive":
            arrived[a1].add(r)
        elif op == "load":
            # Sub-tile u is the row's (G-1-u)-th from the start.
            assert scratch[G - 1 - a1], (walk, C, G, K, a1)
        elif op == "wait":
            u = a1
            # A parity wait passes on the phase it waits for only if the
            # barrier is not a further phase ahead.
            assert phases[r][s] == waited[r][s] + 1, (C, G, K, u, s)
            waited[r][s] += 1
            msg = mail[r][s]
            assert unread[r][s] and msg[:2] == (u - 1, s), (msg, u, s)
            unread[r][s] = False
            state[r][s] = msg[:2]
            for x, (sent_p, _) in tails.items():
                if p == sent_p:
                    held[x][r][k] = msg[2]
        elif op == "run":
            u = a1
            if u > 0:
                assert state[r][s] == (u - 1, s), (walk, u, s)
            state[r][s] = (u, s)
        elif op == "send":
            u, nxt = a1, (r + 1) % C
            assert state[r][s] == (u, s)
            assert not unread[nxt][s], (C, G, K, u, s)   # no lost message
            tail = next(((x, u, k) for x, (sent_p, _) in tails.items()
                         if p == sent_p), None)
            mail[nxt][s] = (u, s, tail)
            unread[nxt][s] = True
            phases[nxt][s] += 1
            assert phases[nxt][s] <= waited[nxt][s] + 1
        elif op == "tail":
            u, x = a1, s
            want = ("init", x, k) if u == 0 else (x, u - 1, k)
            assert held[x][r][k] == want, (walk, C, G, K, u, x, k)
        elif op == "flip":
            b.parity ^= 1
        elif op == "row start":
            # The row's first sub-tile's lambdas, every slot.
            assert all(state[r][i] == (G - 1, i) for i in range(S))
        elif op == "partial":
            partial[r] = True
        elif op == "reduce":
            assert all(partial)
            reduced = True
        b.pending = next(b.ops, None)
    assert reduced and all(scratch)
    # Every message was read: the row's first sub-tile sends nothing.
    assert not any(any(row) for row in unread)
    return counts


def _protocol_cases():
    """(walk, C, G, K, nsub): BDF2 at C up to 16 (its 4K slots allow it
    from K = 4), CN and BE at C = 1 (one slot: the block mails itself); G
    below C, at C, one above, and with a ragged rest (3C + 2); four
    sub-tiles a record tile (fewer in the last), and a row below one
    record tile (nsub >= G)."""
    for walk, Ks in (("BDF2", (1, 2, 4, 16)), ("CN", (1,)), ("BE", (1,))):
        nph = WALKS[walk][0]
        for K in Ks:
            for C in sorted({1, min(4, nph * K), min(7, nph * K),
                             min(16, nph * K)}):
                for G in sorted({1, C - 1, C, C + 1, 3 * C + 2} - {0}):
                    yield pytest.param(walk, C, G, K, 4,
                                       id=f"{walk}-C{C}-G{G}-K{K}")
    for walk in WALKS:
        yield pytest.param(walk, 1, 3, 1, 4, id=f"{walk}-C1-G3-one-tile")


@pytest.mark.parametrize("walk,C,G,K,nsub", list(_protocol_cases()))
def test_reversed_mailbox_protocol(walk, C, G, K, nsub):
    S = WALKS[walk][0] * K
    for seed in range(3):
        counts = _run_protocol(C, G, K, walk, nsub,
                               seed=9000 * C + 10 * G + K + seed)
        assert counts.get("wait", 0) == (G - 1) * S
        assert counts.get("send", 0) == (G - 1) * S
        assert counts["run"] == G * S
        assert counts.get("flip", 0) == G - 1
        assert counts["prologue"] == -(-G // nsub)


# -- (b) the reversed walk in plain PyTorch ----------------------------------

MBLK = 16                 # the plain versions' block
MN = 112                  # cells a row: seven plain blocks
# The model's sub-tiles (four to a record tile): 12 cells (a ragged last
# sub-tile of 4 cells; record tiles of 48, the last of 16), 8 cells (whole
# sub-tiles; record tiles of 32, the last of 16) and 40 cells (one record
# tile of 160 > MN: a row below one record tile, a ragged last sub-tile).
MSUB = {"ragged": 12, "whole": 8, "below-one-tile": 40}
NSUB = 4
NPASS = int(np.log2(MBLK))


def _block(w):
    """The plain sub-step machinery for one w-cell block with exact scans:
    (first, last, forward masks, reversed masks, passes)."""
    first = torch.arange(w)[None, :] == 0
    last = torch.arange(w)[None, :] == w - 1
    masks = torch.as_tensor(cs._scan_masks(w), dtype=torch.float64)
    mrev = torch.as_tensor(ca._rev_scan_masks(w), dtype=torch.float64)
    return first, last, masks, mrev, len(cs._scan_strides(w))


class _Sub:
    """One sub-tile of one half's rows as bwd_wave runs it: per step (newest
    first) the forward recomputed from the prologue's carries and hs1
    edges, then one unit a slot in the backward's order. run(j, mail) takes
    sub-tile u-1's mail (lambda, shift cotangent) for backward slot j (None
    for the row's last sub-tile: the lambdas start from `lam0`, the shift
    cotangents at 0) and returns this sub-tile's mail for it."""

    def __init__(self, m, s0, s1, fcarry, ht, lam0):
        self.m, self.sl = m, slice(s0, s1)
        self.s0 = s0
        self.blk = _block(s1 - s0)
        self.fcarry, self.ht, self.lam0 = fcarry, ht, lam0
        zc = torch.zeros_like(m.zt)
        self.cet = [zc] * m.K
        self.cht = [zc] * m.K
        self.gacc = [torch.zeros((m.Bh, cs._NCOEF), dtype=torch.float64)
                     for _ in range(3)]
        self.oc = None

    def _vals(self, kind, kc, slot, *planes, pt=None, ht=None):
        first, _, masks, _, npass = self.blk
        z = self.m.zt
        return ca._substep_vals(kind, kc, first, masks, *planes,
                                self.fcarry[slot], z if pt is None else pt,
                                z if ht is None else ht, npass)

    def _adj(self, kind, kc, pr, planes, oc0, oc1, lam):
        _, last, _, mrev, npass = self.blk
        return ca._substep_adj(kind, kc, last, mrev, pr, *planes, oc0, oc1,
                               lam, npass)

    def run(self, j, mail):
        m = self.m
        k, p = m.K - 1 - j // m.nph, m.nph - 1 - j % m.nph
        slot = m.nph * k + p
        lam, tail = mail if mail is not None else (self.lam0[slot], None)
        last = self.blk[1]
        if p == m.nph - 1:
            self._recompute(k)
        x0, x1 = self.x
        if m.nph == 1:
            if tail is not None:
                self.cet[k] = tail
            kind = m.kind1
            A0 = self._adj(kind, m.kc[kind], self.pr, (x0, x1) * 3,
                           *self.oc, lam)
            e0c = A0.e0
            e1c = A0.e1 + A0.p1 + torch.where(last, self.cet[k], 0.0)
            self.gacc[0] = self.gacc[0] + A0.coef
            self._step_done(k, e0c, e1c)
            return A0.c_in, (A0.ptail if kind == CN else None)
        kbe, kcn, kbdf = (m.kc[x] for x in (BE, CN, BDF))
        (b0, b1, prB), (c0, c1, prC), (d0, d1, prD), prF = self.pr
        hs0, hs1 = (c0, c1) if m.snap_cn else (b0, b1)
        if p == 3:
            if tail is not None:
                self.cht[k] = tail
            self.A3 = self._adj(BDF, kbdf, prF, (d0, d1, x0, x1, hs0, hs1),
                                *self.oc, lam)
            return self.A3.c_in, self.A3.htail
        if p == 2:
            self.A2 = self._adj(BE, kbe, prD, (c0, c1, x0, x1, hs0, hs1),
                                self.A3.e0, self.A3.e1, lam)
            return self.A2.c_in, None
        A3, A2 = self.A3, self.A2
        if p == 1:
            if tail is not None:
                self.cet[k] = tail
            hs0c, hs1c = self.hc
            hs1c = hs1c + torch.where(last, self.cht[k], 0.0)
            hs0c, hs1c = hs0c + A3.h0, hs1c + A3.h1
            if m.snap_cn:
                c0c, c1c = A2.e0 + hs0c, A2.e1 + hs1c
                self.bc = (torch.zeros_like(hs0c), torch.zeros_like(hs1c))
            else:
                c0c, c1c = A2.e0, A2.e1
                self.bc = (hs0c, hs1c)
            self.A1 = self._adj(CN, kcn, prC, (b0, b1, x0, x1, x0, x1), c0c,
                                c1c, lam)
            return self.A1.c_in, self.A1.ptail + A3.ptail
        A1 = self.A1
        A0 = self._adj(BE, kbe, prB, (x0, x1) * 3, self.bc[0] + A1.e0,
                       self.bc[1] + A1.e1, lam)
        e0c = A0.e0 + A3.p0
        e1c = A0.e1 + A3.p1 + A1.p1 + torch.where(last, self.cet[k], 0.0)
        self.gacc[0] = self.gacc[0] + A0.coef + A2.coef
        self.gacc[1] = self.gacc[1] + A1.coef
        self.gacc[2] = self.gacc[2] + A3.coef
        self._step_done(k, e0c, e1c)
        return A0.c_in, None

    def _recompute(self, k):
        """Step k's forward over the sub-tile: its input, the half snapshot's
        cotangent (the launch's at k = K-1), and the output cotangent (the
        launch's ends' at k = K-1, else step k+1's input cotangent)."""
        m = self.m
        x0, x1 = (x[:, self.sl] for x in m.ins[k])
        self.x = (x0, x1)
        et = m.et(k, self.s0)
        if k == m.K - 1:
            self.oc = tuple(c[:, self.sl] for c in m.co)
        if m.nph == 1:
            kind = m.kind1
            _, _, self.pr = self._vals(kind, m.kc[kind], m.nph * k,
                                       *(x0, x1) * 3,
                                       pt=et if kind == CN else None)
            return
        kbe, kcn, kbdf = (m.kc[x] for x in (BE, CN, BDF))
        s = 4 * k
        b = self._vals(BE, kbe, s, *(x0, x1) * 3)
        c = self._vals(CN, kcn, s + 1, b[0], b[1], *(x0, x1) * 2, pt=et)
        hs0, hs1 = (c[0], c[1]) if m.snap_cn else (b[0], b[1])
        d = self._vals(BE, kbe, s + 2, c[0], c[1], x0, x1, hs0, hs1)
        _, _, prF = self._vals(BDF, kbdf, s + 3, d[0], d[1], x0, x1, hs0,
                               hs1, pt=et, ht=self.ht[k])
        self.pr = (b, c, d, prF)
        z = torch.zeros_like(x0)
        self.hc = (tuple(c[:, self.sl] for c in m.coh) if k == m.K - 1
                   else (z, z))

    def _step_done(self, k, e0c, e1c):
        m = self.m
        if k == m.K - 1 and m.cop is not None:
            e0c = e0c + m.cop[0][:, self.sl]
            e1c = e1c + m.cop[1][:, self.sl]
        self.oc = (e0c, e1c)


class _Half:
    """One half's rows of a B10/B12 launch: its inputs, cotangents, records
    and coefficients, the prologue over the record tiles, and the record
    tiles' e1 edges."""

    def __init__(self, ts_method, K, kc, snap_cn, ins, co, coh, cop, rc,
                 ret, rht, sub):
        self.nph = 4 if ts_method == 3 else 1
        self.kind1 = BE if ts_method == 1 else CN
        self.K, self.kc, self.snap_cn = K, kc, snap_cn
        self.ins, self.co, self.coh, self.cop = ins, co, coh, cop
        self.rc, self.ret, self.rht = rc, ret, rht
        self.Bh, self.N = ins[0][0].shape
        self.zt = torch.zeros((self.Bh, 1), dtype=torch.float64)
        self.sub, self.rtile = sub, NSUB * sub

    def et(self, k, s0):
        """Step k's e1 edge upwind of the sub-tile at s0: the record for a
        record tile's first sub-tile, an input value otherwise."""
        if s0 % self.rtile == 0:
            return self.ret[k][s0 // self.rtile]
        return self.ins[k][1][:, s0 - 1:s0]

    def prologue(self):
        """Each record tile's forward over its sub-tiles in order, from its
        records: every sub-tile's entering carries and hs1 edges."""
        out = []
        for t0 in range(0, self.N, self.rtile):
            carry = list(self.rc[t0 // self.rtile])
            ht = list(self.rht[t0 // self.rtile])
            for s0 in range(t0, min(t0 + self.rtile, self.N), self.sub):
                out.append((list(carry), list(ht)))
                sub = _Sub(self, s0, min(s0 + self.sub, self.N), carry, ht,
                           None)
                for k in range(self.K):
                    x0, x1 = (x[:, sub.sl] for x in self.ins[k])
                    et = self.et(k, s0)
                    if self.nph == 1:
                        kind = self.kind1
                        pr = sub._vals(kind, self.kc[kind], k,
                                       *(x0, x1) * 3,
                                       pt=et if kind == CN else None)[2]
                        carry[k] = pr.carry_out
                        continue
                    kbe, kcn, kbdf = (self.kc[x] for x in (BE, CN, BDF))
                    s = 4 * k
                    b = sub._vals(BE, kbe, s, *(x0, x1) * 3)
                    c = sub._vals(CN, kcn, s + 1, b[0], b[1], *(x0, x1) * 2,
                                  pt=et)
                    hs0, hs1 = ((c[0], c[1]) if self.snap_cn
                                else (b[0], b[1]))
                    d = sub._vals(BE, kbe, s + 2, c[0], c[1], x0, x1, hs0,
                                  hs1)
                    f = sub._vals(BDF, kbdf, s + 3, d[0], d[1], x0, x1, hs0,
                                  hs1, pt=et, ht=ht[k])
                    for i, pr in enumerate((b[2], c[2], d[2], f[2])):
                        carry[s + i] = pr.carry_out
                    ht[k] = hs1[:, -1:]
        return out


def _wave_half(m, lam0, C, order, rng):
    """One half's rows through the wavefront on C blocks: `order` "random"
    (units in an order drawn from `rng`) or "serial" (sub-tile after
    sub-tile). Returns (ce0, ce1, each slot's lambda leaving the row's
    first cell, the three packs summed per block then in rank order)."""
    entries = m.prologue()
    G = len(entries)
    S = m.nph * m.K
    subs = []
    for u in range(G):
        g = G - 1 - u
        s0 = g * m.sub
        subs.append(_Sub(m, s0, min(s0 + m.sub, m.N), *entries[g], lam0))
    queues = [[(u, j) for u in range(r, G, C) for j in range(S)]
              for r in range(C)]
    mailbox = {}
    lam_out = [None] * S
    while any(queues):
        ready = [q for q in queues
                 if q and (q[0][0] == 0 or (q[0][0] - 1, q[0][1]) in mailbox)]
        assert ready, f"deadlock: C={C} G={G}"
        if order == "serial":
            q = min(ready, key=lambda q: q[0])
        else:
            q = rng.choice(ready)
        u, j = q.pop(0)
        got = subs[u].run(j, mailbox.pop((u - 1, j), None))
        if u + 1 < G:
            assert (u, j) not in mailbox
            mailbox[u, j] = got
        else:
            k, p = m.K - 1 - j // m.nph, m.nph - 1 - j % m.nph
            lam_out[m.nph * k + p] = got[0]
    assert not mailbox
    ce = [torch.cat([subs[G - 1 - g].oc[i] for g in range(G)], 1)
          for i in (0, 1)]
    packs = []
    for kind in range(3):
        total = torch.zeros((m.Bh, cs._NCOEF), dtype=torch.float64)
        for r in range(C):
            part = torch.zeros_like(total)
            for u in range(r, G, C):
                part = part + subs[u].gacc[kind]
            total = total + part
        packs.append(total)
    return ce, lam_out, packs


def _wave_launch(eng, ts_method, K, x, cots, recs, sub, C, order, seed):
    """A whole B10 (K = 1) or B12 launch in the model on (2, Bh, N) float64
    planes: the mu>0 half, then the mu<0 half, its lambdas from zero or, on
    a reflective slab, from s times the flipped mu>0 inflow cotangents.
    Returns (ce0, ce1, cbc, gbe, gcn, gbdf) as the kernels do."""
    rng = random.Random(seed)
    nph = 4 if ts_method == 3 else 1
    S = nph * K
    s_of = ([eng.kcs[k].s for k in (BE, CN, BE, BDF)] if ts_method == 3
            else [eng.kcs[BE if ts_method == 1 else CN].s])
    e0, e1, ri0, ri1 = x
    rc, ret, rht = recs
    Bh, N = e0.shape[1:]
    ce0, ce1 = torch.empty_like(e0), torch.empty_like(e0)
    cbc = torch.zeros((2, Bh, 1), dtype=torch.float64)
    gpack = [torch.zeros((2, Bh, cs._NCOEF), dtype=torch.float64)
             for _ in range(3)]
    zt = torch.zeros((Bh, 1), dtype=torch.float64)
    nb = N // MBLK
    tiles = range(0, N, NSUB * sub)
    inflow = None
    for h in (1, 0):
        if h == 0 and eng.reflective:
            lam0 = [s_of[i % nph] * inflow[i][eng.flip.long()]
                    for i in range(S)]
        else:
            lam0 = [zt] * S
        kc = {k: cs._unpack_coef(eng.coef[k][h].double()) for k in eng.coef}
        ins = [(e0[h], e1[h])] + [(ri0[k - 1][h], ri1[k - 1][h])
                                  for k in range(1, K)]
        # The records at each record tile's first cell: the plain
        # versions' at the block that starts there.
        rec_at = [t0 * nb // N for t0 in tiles]
        m = _Half(ts_method, K, kc,
                  bool(eng.cfg.bdf2_symmetric_half) or h == 0, ins,
                  (cots[0][h], cots[1][h]),
                  (cots[2][h], cots[3][h]),
                  (cots[4][h], cots[5][h]) if len(cots) > 4 else None,
                  [[rc[h, i, :, b:b + 1] for i in range(S)] for b in rec_at],
                  [[ret[h, k, :, b:b + 1] for k in range(K)]
                   for b in rec_at],
                  [[rht[h, k, :, b:b + 1] for k in range(K)]
                   for b in rec_at], sub)
        m.ret = [list(z) for z in zip(*m.ret)]      # [k][tile]
        (ce0[h], ce1[h]), inflow, packs = _wave_half(m, lam0, C, order, rng)
        if h == 0 or not eng.reflective:
            acc = torch.zeros_like(zt)
            for i in range(S):
                acc = acc + s_of[i % nph] * inflow[i]
            cbc[h] = acc
        if ts_method == 3:
            for g, pk in zip(gpack, packs):
                g[h] = pk
        else:
            gpack[ts_method - 1][h] = packs[0]
    return (ce0, ce1, cbc, *gpack)


@functools.cache
def _model_engine(ts_method: int, reflective: bool, symmetric: bool):
    """The gray deck at M = 4 (Bh = 2), N = MN, optically thin (X = 0.002,
    so carries cross sub-tiles), on CudaSweepEngine on the CPU."""
    cfg = port.load_config(
        GRAY, M=4, N=MN, X=0.002, ts_method=ts_method,
        bc_left_indicator=2 if reflective else 1,
        bdf2_symmetric_half=symmetric,
        psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cs.CudaSweepEngine(cfg, tables, block=MBLK, device="cpu")


def _nerr(got, ref) -> float:
    m = float(ref.abs().max())
    d = float((got - ref).abs().max())
    return d / m if m > 0 else d


def _walk_cases():
    for ts_method, name in ((1, "BE"), (2, "CN"), (3, "BDF2")):
        for refl in (True, False):
            for sname in MSUB:
                yield pytest.param(ts_method, 1, refl, False, sname,
                                   id=f"B10-{name}-{'refl' if refl else 'src'}"
                                   f"-{sname}")
    for K, refl, sym, sname in ((1, True, True, "ragged"),
                                (1, False, True, "below-one-tile"),
                                (2, True, False, "ragged"),
                                (2, False, True, "whole"),
                                (3, False, False, "ragged"),
                                (3, True, True, "below-one-tile"),
                                (4, True, False, "whole"),
                                (4, False, False, "below-one-tile")):
        yield pytest.param(3, K, refl, sym, sname,
                           id=f"{'B10-BDF2' if K == 1 else f'B12-K{K}'}-"
                           f"{'refl' if refl else 'src'}-"
                           f"{'sym' if sym else 'asym'}-{sname}")


@pytest.mark.parametrize("ts_method,K,refl,sym,sname", list(_walk_cases()))
def test_reversed_wavefront_model_matches_plain(ts_method, K, refl, sym,
                                                sname):
    eng = _model_engine(ts_method, refl, sym)
    sub = MSUB[sname]
    G = -(-MN // sub)
    nph = 4 if ts_method == 3 else 1
    rng = np.random.default_rng(100 * ts_method + 10 * K + sub + refl + sym)
    B = float(np.asarray(eng.tables.B)[0])
    e0, e1 = (torch.as_tensor(B * rng.uniform(0.5, 1.5, (2, eng.Bh, MN)))
              for _ in range(2))
    cots = [torch.as_tensor(rng.uniform(-0.5, 0.5, (2, eng.Bh, MN)))
            for _ in range(6 if K > 1 else 4)]
    if ts_method != 3:
        cots[2] = cots[3] = torch.zeros_like(cots[0])
    z = torch.zeros((2, eng.Bh, cs._NCOEF), dtype=torch.float64)
    coef = [eng.coef[k].double() if k in eng.coef else z
            for k in (BE, CN, BDF)]
    npass = {BE: NPASS, CN: NPASS, BDF: NPASS}
    geo = dict(ts_method=ts_method, s_be=eng.kcs[BE].s if BE in eng.kcs
               else 1.0, s_cn=eng.kcs[CN].s if CN in eng.kcs else 2.0,
               s_bdf=eng.kcs[BDF].s if BDF in eng.kcs else 6.0,
               reflective=eng.reflective, symmetric_half=sym, blk=MBLK,
               npass=npass)
    bc = eng.bc.double()
    if K == 1:
        fr = ca.fwd_record_launch_ref(*coef, bc, eng.flip, e0, e1, **geo)
        rc, ret, rht = fr[4], fr[5][:, None], fr[6][:, None]
        ri0 = ri1 = e0.new_empty((0, *e0.shape))
        ref = ca.bwd_launch_ref(*coef, eng.flip, e0, e1, *cots, *fr[4:],
                                **geo)
    else:
        fr = ca.fwd_record_k_launch_ref(*coef, bc, eng.flip, e0, e1, K=K,
                                        **geo)
        rc, ret, rht, ri0, ri1 = fr[6:]
        ref = ca.bwd_k_launch_ref(*coef, eng.flip, e0, e1, ri0, ri1, *cots,
                                  *fr[6:9], K=K, **geo)
    if G > 1:
        # The mail matters: a carry crosses a whole sub-tile.
        a = cs._unpack_coef(coef[ts_method - 1 if ts_method < 3 else 0]
                            .reshape(-1, 10)).a
        assert float((a ** sub).max()) > 1e-2
    run = functools.partial(_wave_launch, eng, ts_method, K,
                            (e0, e1, ri0, ri1), cots, (rc, ret, rht), sub)
    one = run(C=1, order="serial", seed=0)
    for C in sorted({2, min(nph * K, G, 16)} - {1}):
        serial = run(C=C, order="serial", seed=0)
        got = run(C=C, order="random", seed=C)
        assert all(torch.equal(g, r) for g, r in zip(got, serial)), C
        assert all(torch.equal(g, r) for g, r in zip(got[:3], one[:3])), C
    errs = [_nerr(g, r) for g, r in zip(one, ref)]
    assert max(errs) <= 1e-12, errs
