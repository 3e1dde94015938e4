"""Models of B5's and B7's cluster wavefronts, one slot a step, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py phase 3
holds them against their plain versions there). Both run the tiles and
slots of the one-block walks they replaced as a wavefront over (tile,
slot) on a thread block cluster of C blocks, tile t on block t mod C, one
slot a step, each slot's state handed to the next tile's block through
distributed shared memory:

* B5 (csrc/sweep.cu halo_multistep_kernel) on B2's body (csrc/wave.cuh
  multistep_wave) under csrc/cluster.cuh's HaloChains: a packed row's halo
  chain [0, reset_cell) from zero and its seeded chain [reset_cell, X) as
  ONE sequence of tiles on the row's cluster, the seeded chain's first tile
  taking its mail and discarding it (take-and-reseed); the block that ran
  the row's last tile writes the record.
* B7 (csrc/df_sweep.cu df_multistep_kernel) on B15's body
  (df_multistep_wave) under OneChain: a row's tiles from cell 0, tile 0 from
  init_row's (hi, lo) inflow (the boundary value or, for the mu>0 half of a
  reflective slab, the mu<0 half's record through `flip`), every later
  tile's slot state and p1 tail from its mail; the block that ran the row's
  last tile writes the mu<0 record.

These tests hold that design in plain PyTorch:

* (a) B5's walk: each (tile, slot) a unit, the tile's sub-step with an exact
  scan (test_torch_rowsplit._tile_substep), run in a seeded random order C
  blocks could take, mail through a dict, the reseeding tile discarding its
  mail; bit for bit against the serial walk, the record included, and
  within 1e-12 of ``halo_multistep_launch_ref`` evaluated in float64 with
  npass = log2(blk) (its block scan exact). BE and CN; K 1, 3 and 16; reset
  off the tile, reset 0, a one-tile halo chain, T_h >= C, a seeded chain of
  C + 1 tiles; packed rows 2, 4 and 32.
* (b) B7's walk on the plain version's df sub-step
  (``cuda_df._df_substep_block`` over a whole tile with an exact scan),
  both halves as the kernel launches them (a reflective slab's mu>0 half in
  a second launch from the mu<0 record; with a source boundary both halves
  from the boundary): within 1e-12 in hi + lo (max|d(hi+lo)| / max|hi+lo|,
  each half) of ``df_multistep_launch_ref`` with exact block scans (the
  mu>0 half of a reflective slab against the plain version's run from the
  walk's own mu<0 record, and the two records within 1e-12 of each
  other), and bit for bit against the serial walk, the records included.
  BE and CN; reflective and
  source left; use_correction on and off; a one-tile row, T = C + 1 and 19
  tiles with a ragged last.
* (c) Two mutants that must fail (b)'s checks: a tile > 0 whose slot keeps
  init_row's upwind o1 edge instead of its mail's, and the record written
  by block rank 0 rather than by the block that ran the row's last tile.
* (d) B7's function in float64, which chip_smoke.py holds B7 and its plain
  version against on B7's own shapes (check_f64's rule): B2's plain
  version (``multistep_launch_ref``) on the float64 coefficients
  (``fast_sweep.kind_coeffs`` at float64), the hi + lo planes and boundary
  value, its block scans exact, within 1e-11 of ``df_multistep_launch_ref``
  in hi + lo (the double-float kernels' bar against their plain versions:
  on these rows the two lie up to ~1e-12 apart, a wrong coefficient or
  inflow ~1e-7). BE and CN, reflective and source left, the gray and the
  multigroup decks.
* (e) The kernels' multiplier form. The CUDA sub-step (csrc/df_sweep.cu
  df_substep, B6, B7, B14 and B15 alike) scans with g = 1 - a from the
  double-float T0 and q, not with the float32 a, whose half-ulp error
  biases both solves alike and leaves the square of that bias after one
  refinement. The plain version's solves in that form (``_g_form``) lie
  within 1e-12 of B7's function in float64 on 37888-cell rows of the
  multigroup deck's thin groups, where the plain version itself lies
  above 1e-12 at BE; BE and CN, K 1 to 3, reflective and source left.

The protocol of one slot a step (mailboxes, barriers, parity bits, the
reseeding tile's take) is held in test_torch_rowsplit.py (B2-BE, B2-CN
under OneChain, as B7) and test_torch_halowave.py (B15-BE, B15-CN under
HaloChains, whose slots and tails B5 sends alike). No JAX program is
compiled here.
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
from radiative_transfer_tpu_torch.ops import fast_sweep as fs
from radiative_transfer_tpu_torch.ops.fast_sweep import BE, CN
from test_torch_halowave import _DFStepTile, _halo_tiles
from test_torch_rowsplit import _nerr, _tile_substep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
HX = 96                    # cells a (packed) row
HBLK = 8                   # the plain version's block


def _walk(tiles, S, C, rng):
    """Runs the units (t, s) of one row's tiles on C blocks in an order
    drawn from `rng` (tile after tile for C = 1): tile t on block t mod C,
    each block's units in order, a unit ready when tile t-1's mail for its
    slot is in the mailbox. tiles[t].run(s, mail) takes tile t-1's mail
    (None for the row's tile 0) and returns this tile's. Returns, per
    block, the mail its last tile gave for each slot: what the block's
    shared memory holds when it leaves the walk."""
    T = len(tiles)
    assert 1 <= C <= T
    queues = [[(t, s) for t in range(r, T, C) for s in range(S)]
              for r in range(C)]
    mailbox, held = {}, [[None] * S for _ in range(C)]
    while any(queues):
        ready = [r for r, q in enumerate(queues)
                 if q and (q[0][0] == 0 or (q[0][0] - 1, q[0][1]) in mailbox)]
        assert ready, f"deadlock: C={C} T={T} S={S}"
        r = rng.choice(ready)
        t, s = queues[r].pop(0)
        held[r][s] = tiles[t].run(s, mailbox.pop((t - 1, s), None))
        if t + 1 < T:
            assert (t, s) not in mailbox
            mailbox[t, s] = held[r][s]
    assert not mailbox
    return held


def _walk_cs(T, K):
    """The blocks a row to walk with: 2, 3 and the kernel's cap min(K, T,
    5), each at most T (the serial walk, C = 1, is the reference)."""
    return sorted(c for c in {2, 3, min(K, T, 5)} if 2 <= c <= T)


# -- (a) B5's walk in plain PyTorch ------------------------------------------

class _StepTile:
    """One tile of a packed row as multistep_wave runs it, one step's slot
    at a time: the sub-step of `kind` over the tile's cells, under CN step
    k's p1 edge sent with slot k. run(k, mail) takes tile t-1's mail
    (carry, p1 tail) for slot k; the row's tile 0 gets None and the
    chain's first tile past a halo chain (`reseed`) discards what it gets:
    both start from `inflow[k]` and a zero tail."""

    def __init__(self, kind, kc, x0, x1, inflow, reseed):
        self.kind, self.kc, self.inflow, self.reseed = kind, kc, inflow, reseed
        self.x0, self.x1 = x0, x1
        self.zt = torch.zeros_like(x0[:, :1])

    def run(self, k, mail):
        if mail is None or self.reseed:
            carry, tail = self.inflow[k], self.zt
        else:
            carry, tail = mail
        x0, x1 = self.x0, self.x1
        o0, o1, c = _tile_substep(self.kind, self.kc, x0, x1, x0, x1, x0, x1,
                                  tail, self.zt, carry)
        self.p0, self.p1 = x0, x1
        self.x0, self.x1 = o0, o1
        return c, (x1[:, -1:] if self.kind == CN else self.zt)

    def outputs(self):
        return self.x0, self.x1, self.p0, self.p1


@functools.cache
def _f32_engine(kind: int, M: int):
    """The gray deck at M directions (2*Bh = M packed rows), optically thin
    (X = 0.002, so carries cross tiles), BE or CN, on CudaSweepEngine on
    the CPU."""
    cfg = port.load_config(GRAY, M=M, N=HX, X=0.002, ts_method=kind,
                           psi_source=tuple((6.0,) for _ in range(M)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cs.CudaSweepEngine(cfg, tables, block=HBLK, device="cpu")


def _b5_launch(kind, kc, x0, x1, seeds, reset, K, tile, C, seed):
    """A whole B5 launch on packed (rows, X) planes through the unit walk on
    C blocks. Returns halo_multistep_launch's 5 outputs, the record from
    the block that ran the row's last tile."""
    rows, X = x0.shape
    zt = torch.zeros((rows, 1), dtype=x0.dtype)
    seeded = [seeds[:, k:k + 1] for k in range(K)]
    tiles = [_StepTile(kind, kc, x0[:, a:b], x1[:, a:b],
                       seeded if a >= reset else [zt] * K, rs)
             for a, b, rs in _halo_tiles(X, reset, tile)]
    held = _walk(tiles, K, C, random.Random(seed))
    planes = [torch.cat(p, 1) for p in zip(*(t.outputs() for t in tiles))]
    last = held[(len(tiles) - 1) % C]
    return (*planes, torch.cat([m[0] for m in last], 1))


# (reset in plain blocks of HBLK cells, tile): reset off the tile with a
# ragged halo tile (24 + 16) and a ragged seeded last tile (24, 24, 8);
# reset 0 (4 whole tiles); a halo chain of one ragged tile, shorter than C;
# a halo chain of 6 tiles (T_h >= C at every C walked); a seeded chain of
# 6 tiles (5 whole and a ragged 8) behind a one-tile halo chain, C + 1 at
# C = 5.
B5_SHAPES = {"ragged-halo": (5, 24), "reset0": (0, 24),
             "halo-one-tile": (2, 24), "halo-ge-C": (6, 8),
             "seeded-C+1": (1, 16)}
# (kind, shape, K, packed rows).
B5_CASES = [(CN, "ragged-halo", 3, 4), (BE, "ragged-halo", 3, 4),
            (CN, "ragged-halo", 16, 2), (BE, "ragged-halo", 1, 32),
            (CN, "reset0", 1, 4), (BE, "reset0", 16, 4),
            (CN, "reset0", 3, 32), (BE, "reset0", 3, 2),
            (CN, "halo-one-tile", 16, 4), (BE, "halo-one-tile", 3, 4),
            (CN, "halo-one-tile", 1, 2), (BE, "halo-one-tile", 16, 32),
            (CN, "halo-ge-C", 3, 4), (BE, "halo-ge-C", 16, 4),
            (CN, "halo-ge-C", 16, 32), (BE, "halo-ge-C", 1, 2),
            (CN, "seeded-C+1", 16, 4), (BE, "seeded-C+1", 16, 2),
            (CN, "seeded-C+1", 3, 2), (BE, "seeded-C+1", 3, 32),
            (CN, "seeded-C+1", 1, 32), (BE, "seeded-C+1", 1, 4)]


@pytest.mark.parametrize(
    "kind,shape,K,rows", B5_CASES,
    ids=[f"{'CN' if k == CN else 'BE'}-{s}-K{K}-rows{r}"
         for k, s, K, r in B5_CASES])
def test_b5_step_walk_matches_plain(kind, shape, K, rows):
    reset, tile = B5_SHAPES[shape]
    eng = _f32_engine(kind, rows)
    assert 2 * eng.Bh == rows
    coef = eng.coef[kind].double().reshape(rows, -1)
    kc = cs._unpack_coef(coef)
    rng = np.random.default_rng(100 * kind + 10 * K + rows + reset + tile)
    B = float(np.asarray(eng.tables.B)[0])
    x0, x1 = (torch.as_tensor(B * rng.uniform(0.5, 1.5, (rows, HX)))
              for _ in range(2))
    seeds = torch.as_tensor(B * rng.uniform(0.5, 6.5, (rows, K)))
    tiles = _halo_tiles(HX, reset * HBLK, tile)
    T = len(tiles)
    if T > 1:
        # The mail matters: a carry crosses a whole tile.
        assert float((kc.a ** tile).max()) > 1e-2
    serial = _b5_launch(kind, kc, x0, x1, seeds, reset * HBLK, K, tile, C=1,
                        seed=0)
    for C in _walk_cs(T, K):
        for seed in range(2):
            got = _b5_launch(kind, kc, x0, x1, seeds, reset * HBLK, K, tile,
                             C=C, seed=10 * C + seed)
            assert all(torch.equal(g, r) for g, r in zip(got, serial)), (
                C, seed)
    npass = int(np.log2(HBLK))
    ref = cs.halo_multistep_launch_ref(kind, coef, seeds, reset, x0, x1, K=K,
                                       blk=HBLK, npass=npass)
    errs = [_nerr(g, r) for g, r in zip(serial, ref)]
    assert max(errs) <= 1e-12, errs


# -- (b) B7's walk under OneChain on the plain df sub-step -------------------

class _B7Tile(_DFStepTile):
    """A tile of B7's walk: B15's tile (test_torch_halowave._DFStepTile)
    under OneChain, its `start` init_row's slots. `mutant_inflow`: a tile
    > 0 whose slot keeps init_row's upwind o1 edge instead of the one its
    mail brought."""

    def __init__(self, kind, kb, kd, x, use_corr, start, mutant_inflow):
        super().__init__(kind, kb, kd, x, use_corr, start, False)
        self.mutant_inflow = mutant_inflow

    def run(self, k, mail):
        if mail is not None and self.mutant_inflow:
            slot, tail = mail
            mail = ([slot[0], slot[1], self.start[k][2], slot[3]], tail)
        return super().run(k, mail)


@functools.cache
def _df_engine(kind: int, reflective: bool, use_corr: bool, N: int):
    """The gray deck at M = 4 (Bh = 2), N cells, optically thin, BE or CN,
    on DFCudaEngine on the CPU."""
    cfg = port.load_config(GRAY, M=4, N=N, X=0.002 * N / HX, ts_method=kind,
                           bc_left_indicator=2 if reflective else 1,
                           use_correction=use_corr,
                           psi_source=tuple((6.0,) for _ in range(4)))
    tables, _, _ = port_transport.build_tables(cfg)
    return cd.DFCudaEngine(cfg, tables, block=4, device="cpu")


def _b7_launch(eng, kind, x, K, tile, C, seed, mutant=None):
    """A whole B7 launch on (2, Bh, N) planes through the unit walk on C
    blocks: the mu<0 half, then the mu>0 half from the boundary or, on a
    reflective slab, from the mu<0 half's record through `flip`, as the
    kernel's two launches run them. Returns the 8 planes and each half's
    record (hi, lo), written from the block that ran the row's last tile
    (the mutant "rank0": from block rank 0)."""
    rng = random.Random(seed)
    N = x[0].shape[-1]
    bounds = [(a, min(a + tile, N)) for a in range(0, N, tile)]
    halves, records, slots = [], [], None
    for h in (0, 1):
        start = cd._df_half_inflow(slots, K, eng.bc, eng.bcl, eng.flip, h,
                                   eng.reflective)
        kb = cs._unpack_coef(eng.coef[kind][h])
        kd = cd._unpack_dfc(eng.dcoef[kind][h], kb)
        tiles = [_B7Tile(kind, kb, kd, tuple(p[h][:, a:b] for p in x),
                         bool(eng.cfg.use_correction), start,
                         mutant == "inflow")
                 for a, b in bounds]
        held = _walk(tiles, K, C, rng)
        rank = 0 if mutant == "rank0" else (len(tiles) - 1) % C
        slots = [m[0] for m in held[rank]]
        records += list(cd._df_record(slots))
        halves.append([torch.cat(p, 1)
                       for p in zip(*(t.outputs() for t in tiles))])
    return (*(torch.stack(p) for p in zip(*halves)), *records)


def _df_inputs(eng, seed):
    """(e0 hi, e0 lo, e1 hi, e1 lo) around the equilibrium value, lo parts
    within an ulp of the hi parts."""
    rng = np.random.default_rng(seed)
    B = float(np.asarray(eng.tables.B)[0])
    shape = (2, eng.Bh, eng.cfg.N)
    his = [torch.as_tensor(B * rng.uniform(0.5, 1.5, shape),
                           dtype=torch.float32) for _ in range(2)]
    los = [h * torch.as_tensor(rng.uniform(-0.5, 0.5, shape) * 2.0 ** -24,
                               dtype=torch.float32) for h in his]
    return his[0], los[0], his[1], los[1]


# Row shapes (N, tile): one tile (a 96-cell row below one 128-cell tile);
# T = C + 1 (4 tiles of 24 at C = 3); 19 tiles of 8 with a ragged last of 4.
B7_SHAPES = {"one-tile": (96, 128), "T=C+1": (96, 24),
             "ragged-19": (148, 8)}
# (kind, shape, K, reflective, use_correction).
B7_CASES = [(CN, "one-tile", 3, True, True), (BE, "one-tile", 1, False, True),
            (CN, "one-tile", 8, False, False),
            (BE, "one-tile", 3, True, False),
            (CN, "T=C+1", 3, True, True), (BE, "T=C+1", 3, True, True),
            (CN, "T=C+1", 4, False, False), (BE, "T=C+1", 1, False, False),
            (CN, "T=C+1", 1, True, False), (BE, "T=C+1", 8, False, True),
            (CN, "ragged-19", 3, True, True), (BE, "ragged-19", 3, False, True),
            (CN, "ragged-19", 2, False, False),
            (BE, "ragged-19", 2, True, False),
            (CN, "ragged-19", 5, False, True),
            (BE, "ragged-19", 5, True, True)]


def _plain_halves(eng, kind, x, K, corr, npass, record=None):
    """``df_multistep_launch_ref`` half by half, as the kernel's two
    launches run it: the 8 planes and the mu<0 half's record (hi, lo). With
    `record` (hi, lo) the mu>0 half of a reflective slab starts from that
    record, through `flip`, rather than from its own mu<0 half's."""
    blk = eng.block
    nb, masks, col0, zt = cs._block_setup(x[0], blk, npass)
    outs = [torch.empty_like(x[0]) for _ in range(8)]
    slots = rec = None
    for h in (0, 1):
        if h == 1 and eng.reflective and record is not None:
            rh, rl = (r[eng.flip] for r in record)
            slots = [[rh[:, k:k + 1], torch.zeros_like(zt), rh[:, k:k + 1],
                      rl[:, k:k + 1]] for k in range(K)]
        else:
            slots = cd._df_half_inflow(slots, K, eng.bc, eng.bcl, eng.flip,
                                       h, eng.reflective)
        etails = [(zt, zt)] * K
        kb = cs._unpack_coef(eng.coef[kind][h])
        kd = cd._unpack_dfc(eng.dcoef[kind][h], kb)
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            got = cd._df_multistep_block(
                kind, kb, kd, col0, i == 0, masks, corr,
                tuple(p[h, :, sl] for p in x), slots, etails, K, npass,
                npass)
            for o, g in zip(outs, (*got[0], *got[1])):
                o[h, :, sl] = g
        if h == 0:
            rec = cd._df_record(slots)
    return (*outs, *rec)


def _df_half_err(got, want, h):
    """max|d(hi+lo)| / max|hi+lo| of half h, worst over the 4 plane
    pairs."""
    errs = []
    for i in range(0, 8, 2):
        g = got[i][h].double() + got[i + 1][h].double()
        w = want[i][h].double() + want[i + 1][h].double()
        errs.append(float((g - w).abs().max() / w.abs().max()))
    return max(errs)


@functools.cache
def _b7_plain(kind, shape, K, refl, corr):
    """_plain_halves on (b)'s case, its planes first checked bit-equal to
    ``df_multistep_launch_ref`` with exact block scans."""
    N, _ = B7_SHAPES[shape]
    eng = _df_engine(kind, refl, corr, N)
    x = _df_inputs(eng, 7 * kind + N + 10 * K + 2 * refl + corr)
    npass = int(np.log2(eng.block))
    ref = cd.df_multistep_launch_ref(
        kind, eng.coef[kind], eng.dcoef[kind], eng.bc, eng.bcl, eng.flip, *x,
        K=K, reflective=refl, use_corr=corr, blk=eng.block, npass=npass,
        npass_c=npass)
    plain = _plain_halves(eng, kind, x, K, corr, npass)
    assert all(torch.equal(a, b) for a, b in zip(plain[:8], ref))
    return plain


def _b7_check(kind, shape, K, refl, corr, Cs=None, seeds=2, mutant=None):
    """(b)'s checks for one case; AssertionError if one fails."""
    N, tile = B7_SHAPES[shape]
    eng = _df_engine(kind, refl, corr, N)
    assert eng.reflective == refl
    x = _df_inputs(eng, 7 * kind + N + 10 * K + 2 * refl + corr)
    T = -(-N // tile)
    serial = _b7_launch(eng, kind, x, K, tile, C=1, seed=0, mutant=mutant)
    for C in Cs or ([T - 1] if shape == "T=C+1" else _walk_cs(T, K)):
        for seed in range(seeds):
            got = _b7_launch(eng, kind, x, K, tile, C=C, seed=10 * C + seed,
                             mutant=mutant)
            assert all(torch.equal(g, r) for g, r in zip(got, serial)), (
                C, seed)
    npass = int(np.log2(eng.block))
    plain = _b7_plain(kind, shape, K, refl, corr)
    ref = plain[:8]
    assert _df_half_err(serial, ref, 0) <= 1e-12
    if not refl:
        assert _df_half_err(serial, ref, 1) <= 1e-12
        return
    # The mu>0 half starts from the mu<0 record, which the two scan orders
    # round apart: the records are held to each other, and the walk's mu>0
    # half against the plain version's started from the walk's record.
    rec = [a.double() + b.double() for a, b in (serial[8:10], plain[8:10])]
    assert float((rec[0] - rec[1]).abs().max()
                 / rec[1].abs().max()) <= 1e-12
    same_in = _plain_halves(eng, kind, x, K, corr, npass, serial[8:10])
    assert _df_half_err(serial, same_in, 1) <= 1e-12


@pytest.mark.parametrize(
    "kind,shape,K,refl,corr", B7_CASES,
    ids=[f"{'CN' if k == CN else 'BE'}-{s}-K{K}-{'refl' if r else 'src'}-"
         f"corr{int(c)}" for k, s, K, r, c in B7_CASES])
def test_b7_step_walk_matches_plain(kind, shape, K, refl, corr):
    _b7_check(kind, shape, K, refl, corr)


# -- (c) mutants that must fail (b)'s checks ---------------------------------

# (mutant, kind, shape, K, reflective, use_correction, C): the record mutant
# on a reflective slab (the mu>0 half reads the mu<0 record) where the row's
# last tile is not block 0's (T - 1 not a multiple of C).
MUTANT_CASES = [("inflow", CN, "T=C+1", 3, True, True, 3),
                ("inflow", BE, "ragged-19", 2, False, False, 2),
                ("inflow", CN, "ragged-19", 3, False, True, 4),
                ("inflow", BE, "T=C+1", 1, True, False, 2),
                ("rank0", CN, "T=C+1", 3, True, True, 2),
                ("rank0", BE, "ragged-19", 3, True, False, 4),
                ("rank0", CN, "ragged-19", 2, True, True, 4),
                ("rank0", BE, "ragged-19", 5, True, True, 5)]


@pytest.mark.parametrize(
    "mutant,kind,shape,K,refl,corr,C", MUTANT_CASES,
    ids=[f"{m}-{'CN' if k == CN else 'BE'}-{s}-K{K}-C{C}"
         for m, k, s, K, r, c, C in MUTANT_CASES])
def test_b7_mutant_fails(mutant, kind, shape, K, refl, corr, C):
    # The design itself passes at the same case and blocks.
    _b7_check(kind, shape, K, refl, corr, Cs=[C], seeds=1)
    with pytest.raises(AssertionError):
        _b7_check(kind, shape, K, refl, corr, Cs=[C], seeds=3,
                  mutant=mutant)


# -- (d) B7's function in float64 ---------------------------------------------

def _f64_multistep(eng, kind, x, K):
    """B7's function on the double-float planes `x` in float64: B2's plain
    version on the float64 coefficients, the hi + lo planes and boundary
    value, its block scans exact (chip_smoke.py's df_truth). Returns (e0,
    e1, p0, p1)."""
    kc = fs.kind_coeffs(eng.cfg, eng.tables, np.float64)[kind]
    coef = torch.as_tensor(np.concatenate(
        [np.asarray(c)[0] for c in (kc.w, kc.T0, kc.q, kc.inv_det, kc.a,
                                    kc.Sbase, kc.c1, kc.c0, kc.k_ee, kc.k_p)],
        axis=-1))
    x0, x1 = (x[i].double() + x[i + 1].double() for i in (0, 2))
    return cs.multistep_launch_ref(
        kind, coef, eng.bc.double() + eng.bcl.double(), eng.flip, x0, x1,
        K=K, s=kc.s, reflective=eng.reflective, blk=eng.block,
        npass=int(np.ceil(np.log2(eng.block))))


# (deck, kind, K, reflective).
F64_CASES = [("gray", CN, 3, True), ("gray", BE, 3, False),
             ("mg", CN, 2, False), ("mg", BE, 3, True),
             ("mg", CN, 1, True), ("gray", BE, 1, True)]


@pytest.mark.parametrize(
    "deck,kind,K,refl", F64_CASES,
    ids=[f"{d}-{'CN' if k == CN else 'BE'}-K{K}-{'refl' if r else 'src'}"
         for d, k, K, r in F64_CASES])
def test_b7_function_in_float64(deck, kind, K, refl):
    if deck == "gray":
        eng = _df_engine(kind, refl, True, HX)
    else:
        cfg = port.load_config(MG, M=4, G=2, N=512, ts_method=kind,
                               bc_left_indicator=2 if refl else 1)
        tables, _, _ = port_transport.build_tables(cfg)
        eng = cd.DFCudaEngine(cfg, tables, block=128, device="cpu")
    assert eng.reflective == refl
    x = _df_inputs(eng, 31 * kind + K + refl)
    got = cd.df_multistep_launch_ref(
        kind, eng.coef[kind], eng.dcoef[kind], eng.bc, eng.bcl, eng.flip, *x,
        K=K, reflective=refl, use_corr=bool(eng.cfg.use_correction),
        blk=eng.block, npass=eng.scan_npass[kind],
        npass_c=eng.corr_npass[kind])
    want = _f64_multistep(eng, kind, x, K)
    errs = [_nerr(got[2 * i].double() + got[2 * i + 1].double(), w)
            for i, w in enumerate(want)]
    assert max(errs) <= 1e-11, errs


# -- (e) the kernels' multiplier form -----------------------------------------

def _one_minus_a(kb, kd):
    """csrc/df_sweep.cu load_kind's g = 1 - a, in the same operations:
    (T0 - q)(T0 + q) * idet, T0 - q from the double-float T0 and q."""
    return ((kb.T0 - kb.q) + (kd.T0.lo - kd.q.lo)) * (kb.T0 + kb.q) * kb.idet


def _g_form(monkeypatch):
    """Runs the df plain versions' two solves in the kernels' multiplier
    form (csrc/df_sweep.cu KindCoef, tiles.cuh block_exclusive_scan<true>):
    the scan over the maps x -> (1 - g)*x + b_j, 1 - a^(2^k) carried as
    gp + (gp - gp*gp) through the passes, never the float32 a."""
    gs = {}
    unpack = cd._unpack_dfc

    def unpack_g(c, kb):
        kd = unpack(c, kb)
        gs[id(kb)] = (kb, _one_minus_a(kb, kd))
        return kd

    def solve_g(kb, col0, masks, r0, r1, c0, npass):
        g = gs[id(kb)][1]
        b = (kb.q * r0 + kb.T0 * r1) * kb.idet
        pref, gp = torch.where(col0, b + (c0 - g * c0), b), g
        for k in range(npass):
            rolled = torch.roll(pref, 1 << k, dims=1) * masks[k]
            pref = pref + (rolled - gp * rolled)
            gp = gp + (gp - gp * gp)
        cin = torch.where(col0, c0, torch.roll(pref, 1, dims=1))
        u = r0 + kb.w * cin
        return ((kb.T0 * u - kb.q * r1) * kb.idet,
                (kb.q * u + kb.T0 * r1) * kb.idet, pref[:, -1:])

    monkeypatch.setattr(cd, "_unpack_dfc", unpack_g)
    monkeypatch.setattr(cd, "_solve_block", solve_g)


# (kind, K, reflective, the float32 multiplier's bias above the bar): the
# multigroup deck's thin groups (1/(1 - a) up to ~110 at BE) on rows of
# 37888 cells.
G_CASES = [(BE, 3, False, True), (BE, 3, True, True), (BE, 1, True, True),
           (CN, 2, False, False)]


@pytest.mark.parametrize(
    "kind,K,refl,biased", G_CASES,
    ids=[f"{'CN' if k == CN else 'BE'}-K{K}-{'refl' if r else 'src'}"
         for k, K, r, _ in G_CASES])
def test_b7_multiplier_form(monkeypatch, kind, K, refl, biased):
    cfg = port.load_config(MG, M=4, G=4, N=37888, ts_method=kind,
                           bc_left_indicator=2 if refl else 1)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = cd.DFCudaEngine(cfg, tables, device="cpu")
    assert eng.reflective == refl
    x = _df_inputs(eng, 41 + K)
    want = _f64_multistep(eng, kind, x, K)

    def err():
        got = cd.df_multistep_launch_ref(
            kind, eng.coef[kind], eng.dcoef[kind], eng.bc, eng.bcl, eng.flip,
            *x, K=K, reflective=refl, use_corr=bool(cfg.use_correction),
            blk=eng.block, npass=eng.scan_npass[kind],
            npass_c=eng.corr_npass[kind])
        return max(_nerr(got[2 * i].double() + got[2 * i + 1].double(), w)
                   for i, w in enumerate(want))

    plain = err()
    _g_form(monkeypatch)
    g = err()
    assert g <= 1e-12, (g, plain)
    if biased:
        assert plain > 1e-12, (g, plain)
