"""Double-float (f64-grade) sweep engine on hand-written CUDA kernels.

Port of radiative_transfer_tpu/ops/df_sweep.py (DFPallasEngine and its
four kernel factories). Two kernel wrappers carry the engine:

* ``df_bdf2_launch``      — K whole double-float BDF2 four-phase steps
  (B6, ``_make_df_bdf2_kernel``): 4 planes in, 12 out;
* ``df_multistep_launch`` — K whole double-float BE or CN steps (B7,
  ``_make_df_multistep_kernel``): 4 planes in, 8 out;

and two more carry the packed-rows df halo engine
(parallel/df_halo_cuda.py):

* ``df_halo_bdf2_launch``      — B14, ``_make_df_halo_bdf2_kernel``;
* ``df_halo_multistep_launch`` — B15, ``_make_df_halo_multistep_kernel``:
  the same steps over (2*Bh, X) packed rows, mu<0 rows first, each row's
  chain restarted at block `reset` from (hi, lo) seeds, with every row's
  corrected outflow recorded per (step, phase).

A value is carried as hi + lo, two float32 planes (ops/df.py). Every
sub-step is iterative refinement inside the kernel, as in the JAX engine:

1. capture the exact double-float right-hand side (r, r_err);
2. BASE: the plain float32 solve of csrc/sweep.cu's sub-step (b-build,
   scan, 2x2 reconstruct);
3. RESIDUAL: rho = r_true - A*x_base, from the base OUTPUTS alone, with
   error-free products and two_sum cascades;
4. CORRECT: a second float32 scan solve of A*delta = rho, then
   out = two_sum(x_base, delta).

Every float32 error of the base solve (rounding, the scan, the carry
across blocks or tiles) lands in the output-based residual, so the result
tracks the float64 engine to double-float precision whatever scan the
base ran. That is why the CUDA kernels (csrc/df_sweep.cu), which scan each
tile exactly, and the plain versions here (``*_launch_ref``), which keep
the JAX kernels' blocks, truncated Hillis-Steele scans (``npass`` from
scan_tol, ``npass_c`` from CORR_SCAN_TOL) and operation order,
agree to double-float precision and not bit for bit: compare hi + lo in
float64, never the hi planes alone.

Each wrapper launches its kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs the plain version. Each counts its
kernel launches in ``<wrapper>.launches``.

State: ``DFState(hi, lo)``, two FlatStates of (2, Bh, N) float32 planes.
The JAX state's opaque ``one`` exists only to stop XLA from folding its
FMA freeze; eager PyTorch and the kernels' ``__f*_rn`` intrinsics need
none (ops/df.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.config import Config
from . import cuda_sweep as cs
from . import df
from . import fast_sweep as fs
from ._cuda_build import load as load_kernels
from .fast_sweep import BDF, BE, CN, FlatState

# Double-float coefficient pack: 3 columns (lo, hh, hl) per constant in
# _DF_ORDER (the hi part is the f32 base coefficient of the _NCOEF pack,
# asserted identical at pack time), then the 2-column additive source
# S0 = Sbase + c0.
_DF_ORDER = ("T0", "q", "w", "kee", "kp", "c1")
_NDF = 3 * len(_DF_ORDER) + 2

# Accuracy bound of the plain versions' truncated correction scan (the JAX
# engine's corr_scan_tol): the correction is ~1e-7 of the state, so 1e-6
# of it lies far below double-float roundoff.
CORR_SCAN_TOL = 1e-6


def _pack_df_coeffs(cfg: Config, tables, kind: int, ts: float) -> np.ndarray:
    """(2, Bh, _NDF) float32 double-float coefficient pack (host side)."""
    kc64 = fs.build_kind_coeffs(cfg, tables, kind, ts, np.float64)
    kc32 = fs.build_kind_coeffs(cfg, tables, kind, ts, np.float32)

    def flat(kc, name):
        return np.asarray(getattr(kc, name))[0, :, :, 0]   # (2, Bh)

    names = {"T0": "T0", "q": "q", "w": "w", "kee": "k_ee", "kp": "k_p",
             "c1": "c1"}
    cols = []
    for n in _DF_ORDER:
        hi, lo = df.np_df(flat(kc64, names[n]))
        # The hi part must equal the f32 base coefficient the base solve
        # uses (both round the same f64 value); the residual assumes it.
        assert np.array_equal(hi, flat(kc32, names[n])), n
        hh, hl = df.np_split(hi)
        cols += [lo[..., None], hh[..., None], hl[..., None]]
    s0h, s0l = df.np_df(flat(kc64, "Sbase") + flat(kc64, "c0"))
    cols += [s0h[..., None], s0l[..., None]]
    packed = np.concatenate(cols, axis=-1)
    assert packed.shape[-1] == _NDF
    return packed.astype(np.float32)


def select_block(cfg: Config, block: Optional[int] = None,
                 interpret: bool = False) -> int:
    """The JAX df block-selection walk (df_sweep.py:759-793), kept as is:
    divisor walk from 2048, shrink to Bh*block <= the live-plane target,
    small-batch growth back to it, then the Mosaic lane rule (block % 128
    == 0 or whole N; an explicit block is kept when `interpret`). It
    shapes the plain versions' blocked scans; the CUDA kernels tile N
    their own way."""
    auto_block = block is None
    if auto_block:
        block = 2048
    blk = block
    while cfg.N % blk != 0 or (blk & (blk - 1)):
        blk //= 2
        if blk == 0:
            raise ValueError(f"N={cfg.N} has no power-of-two block")
    Bh = (cfg.M // 2) * cfg.G
    target = ((1 << 14) if Bh <= 4 else
              (1 << 16) if Bh <= 16 else (1 << 17))
    while auto_block and Bh * blk > target and blk > 512:
        blk //= 2
    if auto_block:
        while (Bh * blk * 2 <= target and blk < cfg.N
               and cfg.N % (blk * 2) == 0):
            blk *= 2
    if blk % 128 != 0 and blk != cfg.N:
        if not interpret or auto_block:
            blk = cfg.N
    return blk


def whole_n_feasible(cfg: Config) -> bool:
    """The JAX auto gate (df_sweep.py:796-806): False where select_block
    lands on a whole-N block too large for TPU VMEM. The port's selection
    does not route on it (the CUDA kernels tile any N); it is kept so
    that the tests can hold the two packages' walks equal."""
    blk = select_block(cfg, None, interpret=False)
    Bh = (cfg.M // 2) * cfg.G
    return not (blk == cfg.N and Bh * cfg.N > (1 << 18))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (the blocked TPU algorithm)
# ---------------------------------------------------------------------------

class _DFC(NamedTuple):
    T0: df.DFConst
    q: df.DFConst
    w: df.DFConst
    kee: df.DFConst
    kp: df.DFConst
    c1: df.DFConst
    S0h: torch.Tensor
    S0l: torch.Tensor


def _unpack_dfc(c: torch.Tensor, kb: cs._Coef) -> _DFC:
    """(Bh, _NDF) pack -> the constants as (Bh, 1) columns; the hi parts
    are the f32 base coefficients."""
    his = (kb.T0, kb.q, kb.w, kb.kee, kb.kp, kb.c1)
    consts = [df.DFConst(hi, c[:, 3 * k:3 * k + 1], c[:, 3 * k + 1:3 * k + 2],
                         c[:, 3 * k + 2:3 * k + 3])
              for k, hi in enumerate(his)]
    b = 3 * len(_DF_ORDER)
    return _DFC(*consts, c[:, b:b + 1], c[:, b + 1:b + 2])


def _cap(c: df.DFConst, v, vh, vl, vlo=None):
    """Captured product: p = fl(c.hi*v) and e with p + e ~= c * v_df to
    ~2^-48 relative (vh, vl: the split of v; vlo: v's lo part)."""
    p = c.hi * v
    e = df.prod_err(p, c.hh, c.hl, vh, vl) + c.lo * v
    if vlo is not None:
        e = e + c.hi * vlo
    return p, e


def _solve_block(kb: cs._Coef, col0, masks, r0, r1, c0, npass: int):
    """Solve A*x = r in f32 on one block from the carry `c0`: b-build,
    truncated scan, 2x2 reconstruct (the base solve of the right-hand
    side and the correction solve of the residual alike). Returns (x0,
    x1, carry leaving the block)."""
    b = (kb.q * r0 + kb.T0 * r1) * kb.idet
    b_adj = torch.where(col0, b + kb.a * c0, b)
    pref = cs._hillis_steele(b_adj, kb.a, masks, npass)
    cin = torch.where(col0, c0, torch.roll(pref, 1, dims=1))
    u = r0 + kb.w * cin
    x0 = (kb.T0 * u - kb.q * r1) * kb.idet
    x1 = (kb.q * u + kb.T0 * r1) * kb.idet
    return x0, x1, pref[:, -1:]


def _df_substep_block(kind: int, kb: cs._Coef, kd: _DFC, col0, first: bool,
                      masks, use_corr: bool, e, p, h, ptail, htail, slot,
                      npass: int, npass_c: int):
    """One double-float sub-step on one (Bh, blk) block (``_df_substep``).

    e/p/h: (x0h, x0l, x1h, x1l) planes (p/h None where the kind ignores
    them); ptail/htail: the upwind block's p1/h1 (hi, lo) edge; `first`:
    this is the half's first block, whose history fills are the slot's
    double-float inflow. `slot` = [carry, ccarry, otail_h, otail_l] of
    this (step, phase), updated in place: the base and correction carries
    and the upwind base o1 edge. Returns (o0h, o0l, o1h, o1l)."""
    e0h, e0l, e1h, e1l = e
    carry, ccarry, ofh, ofl = slot
    sp = df.split
    two = df.two_sum

    def shift1(x, fill):
        return torch.where(col0, fill, torch.roll(x, 1, dims=1))

    # -- RHS with capture ----------------------------------------------------
    if use_corr:
        tpsi, epsi = two(e0h, e1h)
        psi = 0.5 * tpsi
        psil = 0.5 * (epsi + (e0l + e1l))
        pc, epc = _cap(kd.c1, psi, *sp(psi), psil)
        S, eS = two(kd.S0h, pc)
        S_err = eS + (kd.S0l + epc)
    else:
        S, S_err = kd.S0h, kd.S0l

    se0, se1 = sp(e0h), sp(e1h)
    if kind == BE:
        m0, em0 = _cap(kd.kee, e0h, *se0, e0l)
        m1, em1 = _cap(kd.kee, e1h, *se1, e1l)
        r0, ea = two(S, m0)
        r0_err = (S_err + em0) + ea
        r1, eb = two(S, m1)
        r1_err = (S_err + em1) + eb
    elif kind == CN:
        pf_h, pf_l = (ofh, ofl) if first else ptail
        p1sh = shift1(p[2], pf_h)
        p1sl = shift1(p[3], pf_l)
        m0, em0 = _cap(kd.kee, e0h, *se0, e0l)
        m1, em1 = _cap(kd.q, e1h, *se1, e1l)
        m2, em2 = _cap(kd.w, p1sh, *sp(p1sh), p1sl)
        t1_, ea = two(S, m0)
        t2_, eb = two(t1_, -m1)
        r0, ec = two(t2_, m2)
        r0_err = ((S_err + em0) - em1) + (em2 + (ea + eb + ec))
        m3, em3 = _cap(kd.q, e0h, *se0, e0l)
        m4, em4 = _cap(kd.kee, e1h, *se1, e1l)
        t3_, ed = two(S, m3)
        r1, ee = two(t3_, m4)
        r1_err = (S_err + em3) + (em4 + (ed + ee))
    else:  # BDF
        p0h_, p0l_, p1h_, p1l_ = p
        h0h_, h0l_, h1h_, h1l_ = h
        pf_h, pf_l = (ofh, ofl) if first else ptail
        hf_h, hf_l = (ofh, ofl) if first else htail
        p1sh, p1sl = shift1(p1h_, pf_h), shift1(p1l_, pf_l)
        h1sh, h1sl = shift1(h1h_, hf_h), shift1(h1l_, hf_l)
        sp0, sp1 = sp(p0h_), sp(p1h_)
        sh0, sh1 = sp(h0h_), sp(h1h_)
        n1, en1 = _cap(kd.kee, h0h_, *sh0, h0l_)
        n2, en2 = _cap(kd.w, h1h_, *sh1, h1l_)
        n3, en3 = _cap(kd.kp, p0h_, *sp0, p0l_)
        n4, en4 = _cap(kd.q, p1h_, *sp1, p1l_)
        n5, en5 = _cap(kd.w, h1sh, *sp(h1sh), h1sl)
        n6, en6 = _cap(kd.w, p1sh, *sp(p1sh), p1sl)
        t1_, ea = two(S, n1)
        t2_, eb = two(t1_, -2.0 * n2)
        t3_, ec = two(t2_, -n3)
        t4_, ed = two(t3_, -n4)
        t5_, ee = two(t4_, 4.0 * n5)
        r0, ef = two(t5_, n6)
        r0_err = (((S_err + en1) - (2.0 * en2 + en3)) - en4) + (
            (4.0 * en5 + en6) + ((ea + eb) + (ec + ed) + (ee + ef)))
        n7, en7 = _cap(kd.w, h0h_, *sh0, h0l_)
        n8, en8 = _cap(kd.kee, h1h_, *sh1, h1l_)
        n9, en9 = _cap(kd.q, p0h_, *sp0, p0l_)
        n10, en10 = _cap(kd.kp, p1h_, *sp1, p1l_)
        u1_, eg = two(S, 2.0 * n7)
        u2_, eh_ = two(u1_, n8)
        u3_, ei = two(u2_, n9)
        r1, ej = two(u3_, -n10)
        r1_err = ((S_err + 2.0 * en7) + (en8 + en9)) - en10 + (
            (eg + eh_) + (ei + ej))

    # -- base: the plain f32 solve ------------------------------------------
    o0, o1, carry_out = _solve_block(kb, col0, masks, r0, r1, carry, npass)

    # -- output-based residual (module doc) ----------------------------------
    # The upwind coupling: the df inflow or the upwind block's base o1 edge
    # (otail) at the block start, the rolled base o1 inside.
    s0, s1 = sp(o0), sp(o1)
    o1r = shift1(o1, ofh)
    o1r_l = torch.where(col0, ofl, torch.zeros_like(o1))
    pT0, eT0 = _cap(kd.T0, o0, *s0)
    pQ1, eQ1 = _cap(kd.q, o1, *s1)
    pW, eW = _cap(kd.w, o1r, *sp(o1r), o1r_l)
    t, x1 = two(r0, -pT0)
    t, x2 = two(t, -pQ1)
    t, x3 = two(t, pW)
    rho0 = t + ((x1 + x2 + x3) + (r0_err - (eT0 + eQ1) + eW))
    pQ0, eQ0 = _cap(kd.q, o0, *s0)
    pT1, eT1 = _cap(kd.T0, o1, *s1)
    t, y1 = two(r1, pQ0)
    t, y2 = two(t, -pT1)
    rho1 = t + ((y1 + y2) + (r1_err + eQ0 - eT1))

    # -- correction: the same f32 solve of A*delta = rho ---------------------
    d0, d1, ccarry_out = _solve_block(kb, col0, masks, rho0, rho1, ccarry,
                                      npass_c)
    # The next block's residual couples against the BASE o1 edge.
    slot[:] = [carry_out, ccarry_out, o1[:, -1:], torch.zeros_like(ofh)]
    o0h, o0l = df.renorm(o0, d0)
    o1h, o1l = df.renorm(o1, d1)
    return o0h, o0l, o1h, o1l


def _df_half_inflow(slots, nslots: int, bc, bcl, flip, h: int,
                    reflective: bool):
    """Slots [carry, ccarry, otail_h, otail_l] entering half h
    (``_half_init``): the (hi, lo) boundary value, or for the mu>0 half of
    a reflective slab the mu<0 half's corrected outflow two_sum(base o1
    edge, correction carry) of the same slot, flipped m -> Mh-1-m
    (solver.cpp:679-683). The base carry starts at the plain inflow hi
    part: the history fills enter the right-hand side as true values."""
    if h == 1 and reflective:
        vals = [df.two_sum(oth, cc) for _, cc, oth, _ in slots]
        vals = [(vh[flip], vl[flip]) for vh, vl in vals]
    else:
        vals = [(bc[h], bcl[h])] * nslots
    return [[vh, torch.zeros_like(vh), vh, vl] for vh, vl in vals]


def _df_bdf2_block(kbs, kds, col0, first: bool, masks, use_corr: bool, x,
                   slots, etails, htails, K: int, snap_cn: bool, npass,
                   npass_c):
    """K whole double-float BDF2 steps on one block; `slots` (4K, index
    4k+p for step k phase p), `etails` and `htails` (K (hi, lo) pairs) are
    updated in place; `snap_cn` as in ``cs._pick``. Returns (ends, half,
    prev), each a 4-tuple."""
    for k in range(K):
        et, ht = etails[k], htails[k]

        def phase(ph, kind, e, p=None, hpl=None, ptail=None, htail=None):
            return _df_substep_block(
                kind, kbs[kind], kds[kind], col0, first, masks, use_corr, e,
                p, hpl, ptail, htail, slots[4 * k + ph], npass[kind],
                npass_c[kind])

        # Phase 0: BE(dt/2) predictor.
        b = phase(0, BE, x)
        # Phase 1: CN(dt/2) corrector (p1 = step input e1).
        hc = phase(1, CN, b, p=x, ptail=et)
        # Half snapshot: CN output for mu<0, phase-0 BE output for mu>0
        # (reference quirk, solver.cpp:733 vs 784-787) unless symmetric;
        # a (rows, 1) mask blends packed rows.
        hs = tuple(cs._pick(snap_cn, a, bb) for a, bb in zip(hc, b))
        # Phase 2: second BE(dt/2) predictor.
        d = phase(2, BE, hc)
        # Phase 3: BDF2 corrector (prev = step input, half = hs).
        f = phase(3, BDF, d, p=x, hpl=hs, ptail=et, htail=ht)
        etails[k] = (x[2][:, -1:], x[3][:, -1:])
        htails[k] = (hs[2][:, -1:], hs[3][:, -1:])
        prev, x = x, f
    return x, hs, prev


def _df_multistep_block(kind: int, kb, kd, col0, first: bool, masks,
                        use_corr: bool, x, slots, etails, K: int, npass: int,
                        npass_c: int):
    """K whole double-float BE or CN steps on one block. Returns (ends,
    prev), each a 4-tuple."""
    for k in range(K):
        f = _df_substep_block(
            kind, kb, kd, col0, first, masks, use_corr, x,
            x if kind == CN else None, None, etails[k], None, slots[k],
            npass, npass_c)
        etails[k] = (x[2][:, -1:], x[3][:, -1:])
        prev, x = x, f
    return x, prev


def df_bdf2_launch_ref(cbe, ccn, cbdf, dbe, dcn, dbdf, bc, bcl, flip, e0h,
                       e0l, e1h, e1l, *, K: int, reflective: bool,
                       symmetric_half: bool, use_corr: bool, blk: int,
                       npass: dict, npass_c: dict):
    """Plain version of B6 (``_make_df_bdf2_kernel``): K whole
    double-float BDF2 steps. `npass`/`npass_c`: {kind: passes} of the
    base and correction scans. Returns the 12 planes (ends0 hi, lo,
    ends1 hi, lo, half0 hi, lo, half1 hi, lo, prev0 hi, lo, prev1 hi,
    lo), prev being the last step's input."""
    nb, masks, col0, zt = cs._block_setup(
        e0h, blk, max(*npass.values(), *npass_c.values()))
    outs = [torch.empty_like(e0h) for _ in range(12)]
    slots = None
    for h in (0, 1):
        slots = _df_half_inflow(slots, 4 * K, bc, bcl, flip, h, reflective)
        etails, htails = [(zt, zt)] * K, [(zt, zt)] * K
        kbs = {kind: cs._unpack_coef(c[h])
               for kind, c in ((BE, cbe), (CN, ccn), (BDF, cbdf))}
        kds = {kind: _unpack_dfc(d[h], kbs[kind])
               for kind, d in ((BE, dbe), (CN, dcn), (BDF, dbdf))}
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            x = tuple(pl[h, :, sl] for pl in (e0h, e0l, e1h, e1l))
            got = _df_bdf2_block(kbs, kds, col0, i == 0, masks, use_corr, x,
                                 slots, etails, htails, K,
                                 symmetric_half or h == 0, npass, npass_c)
            for o, g in zip(outs, (*got[0], *got[1], *got[2])):
                o[h, :, sl] = g
    return tuple(outs)


def df_multistep_launch_ref(kind: int, coef, dcoef, bc, bcl, flip, e0h, e0l,
                            e1h, e1l, *, K: int, reflective: bool,
                            use_corr: bool, blk: int, npass: int,
                            npass_c: int):
    """Plain version of B7 (``_make_df_multistep_kernel``): K whole
    double-float BE or CN steps; prev = the last step's input. Returns
    the 8 planes (ends0 hi, lo, ends1 hi, lo, prev0 hi, lo, prev1 hi,
    lo)."""
    if kind not in (BE, CN):
        raise ValueError(f"df multistep kernel runs BE or CN, got {kind}")
    nb, masks, col0, zt = cs._block_setup(e0h, blk, max(npass, npass_c))
    outs = [torch.empty_like(e0h) for _ in range(8)]
    slots = None
    for h in (0, 1):
        slots = _df_half_inflow(slots, K, bc, bcl, flip, h, reflective)
        etails = [(zt, zt)] * K
        kb = cs._unpack_coef(coef[h])
        kd = _unpack_dfc(dcoef[h], kb)
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            x = tuple(pl[h, :, sl] for pl in (e0h, e0l, e1h, e1l))
            got = _df_multistep_block(kind, kb, kd, col0, i == 0, masks,
                                      use_corr, x, slots, etails, K, npass,
                                      npass_c)
            for o, g in zip(outs, (*got[0], *got[1])):
                o[h, :, sl] = g
    return tuple(outs)


def _df_chain_slots(nslots: int, seeds_h, seeds_l, zt):
    """Slots [carry, ccarry, otail_h, otail_l] where a packed chain starts:
    zeros at block 0, the (hi, lo) seed columns at the reset block (base
    carry and upwind o1 edge at the seed's hi part, the inflow's lo part
    at its lo part; no s-multiplier fold)."""
    if seeds_h is None:
        return [[zt, zt, zt, zt] for _ in range(nslots)]
    return [[seeds_h[:, c:c + 1], zt, seeds_h[:, c:c + 1],
             seeds_l[:, c:c + 1]] for c in range(nslots)]


def _df_record(slots):
    """(rows, C) hi and lo of each slot's corrected outflow two_sum(base
    o1 edge, correction carry) after the last block."""
    vals = [df.two_sum(oth, cc) for _, cc, oth, _ in slots]
    return (torch.cat([h for h, _ in vals], dim=1),
            torch.cat([l for _, l in vals], dim=1))


def df_halo_bdf2_launch_ref(cbe, ccn, cbdf, dbe, dcn, dbdf, seeds_h, seeds_l,
                            reset: int, e0h, e0l, e1h, e1l, *, K: int,
                            symmetric_half: bool, use_corr: bool, blk: int,
                            npass: dict, npass_c: dict):
    """Plain version of B14 (``_make_df_halo_bdf2_kernel``): K whole
    double-float BDF2 steps over packed (rows, X) planes, mu<0 rows first,
    both halves in each block visit. Coefficients are (rows, NCOEF) and
    (rows, _NDF). The slots and history tails start at zero at block 0 and
    restart at block `reset` from the (hi, lo) `seeds_*` (rows, 4K; column
    4k+p is step k phase p) with zero tails; the half snapshot blends per
    row unless `symmetric_half`. Returns the 12 planes of
    ``df_bdf2_launch_ref`` and the (rows, 4K) record's hi and lo."""
    nb, masks, col0, zt = cs._block_setup(
        e0h, blk, max(*npass.values(), *npass_c.values()))
    rows = e0h.shape[0]
    outs = [torch.empty_like(e0h) for _ in range(12)]
    kbs = {kind: cs._unpack_coef(c)
           for kind, c in ((BE, cbe), (CN, ccn), (BDF, cbdf))}
    kds = {kind: _unpack_dfc(d, kbs[kind])
           for kind, d in ((BE, dbe), (CN, dcn), (BDF, dbdf))}
    snap_cn = (True if symmetric_half else
               torch.arange(rows, device=e0h.device)[:, None] < rows // 2)
    for i in range(nb):
        if i in (0, reset):
            slots = _df_chain_slots(4 * K, seeds_h if i == reset else None,
                                    seeds_l, zt)
            etails, htails = [(zt, zt)] * K, [(zt, zt)] * K
        sl = slice(i * blk, (i + 1) * blk)
        x = tuple(pl[:, sl] for pl in (e0h, e0l, e1h, e1l))
        got = _df_bdf2_block(kbs, kds, col0, i == reset, masks, use_corr, x,
                             slots, etails, htails, K, snap_cn, npass,
                             npass_c)
        for o, g in zip(outs, (*got[0], *got[1], *got[2])):
            o[:, sl] = g
    return (*outs, *_df_record(slots))


def df_halo_multistep_launch_ref(kind: int, coef, dcoef, seeds_h, seeds_l,
                                 reset: int, e0h, e0l, e1h, e1l, *, K: int,
                                 use_corr: bool, blk: int, npass: int,
                                 npass_c: int):
    """Plain version of B15 (``_make_df_halo_multistep_kernel``): K whole
    double-float BE or CN steps over packed (rows, X) planes, seeded as in
    ``df_halo_bdf2_launch_ref`` from (rows, K) seeds. Returns the 8 planes
    of ``df_multistep_launch_ref`` and the (rows, K) record's hi and lo."""
    if kind not in (BE, CN):
        raise ValueError(
            f"df halo multistep kernel runs BE or CN, got {kind}")
    nb, masks, col0, zt = cs._block_setup(e0h, blk, max(npass, npass_c))
    outs = [torch.empty_like(e0h) for _ in range(8)]
    kb = cs._unpack_coef(coef)
    kd = _unpack_dfc(dcoef, kb)
    for i in range(nb):
        if i in (0, reset):
            slots = _df_chain_slots(K, seeds_h if i == reset else None,
                                    seeds_l, zt)
            etails = [(zt, zt)] * K
        sl = slice(i * blk, (i + 1) * blk)
        x = tuple(pl[:, sl] for pl in (e0h, e0l, e1h, e1l))
        got = _df_multistep_block(kind, kb, kd, col0, i == reset, masks,
                                  use_corr, x, slots, etails, K, npass,
                                  npass_c)
        for o, g in zip(outs, (*got[0], *got[1])):
            o[:, sl] = g
    return (*outs, *_df_record(slots))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_df(name: str, coefs, dcoefs, bc, bcl, flip, planes):
    """Validate a df kernel's inputs; returns (Bh, N)."""
    Bh, N = cs._check_cuda(name, coefs, bc, flip, planes)
    dev = planes[0].device
    for t, cols, what in [(d, _NDF, "df coefficients") for d in dcoefs] + [
            (bcl, 1, "bcl")]:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (2, Bh, cols) or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"(2, {Bh}, {cols}) on {dev}")
    return Bh, N


def _plane_array(ins, outs):
    """The C interface's array of plane pointers: inputs, then outputs."""
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


# B6's launch shape: at most this many threads a block (a tile is 4 cells
# a thread) and blocks a row (above 8 a non-portable cluster size); the
# kernel takes fewer blocks a row where the card cannot hold every row's
# cluster at once. 512 threads beat 256, and 16 blocks beat 8 at gray_s8
# (chip_smoke.py times both).
DF_BDF2_THREADS = 512
DF_BDF2_MAX_CLUSTER = 16


def df_bdf2_geometry(N: int, K: int, rows: int) -> Tuple[int, int, int]:
    """B6's launch shape for `rows` rows a launch (Bh for a reflective
    boundary, else 2*Bh) of N cells at K steps: (threads a block, blocks a
    row, i.e. the cluster size, tiles a row)."""
    out = (ctypes.c_int * 3)()
    load_kernels().rt_df_bdf2_geometry(N, K, DF_BDF2_THREADS,
                                       DF_BDF2_MAX_CLUSTER, rows, out)
    return tuple(out)


def df_halo_bdf2_geometry(X: int, K: int, reset_cell: int,
                          rows: int) -> Tuple[int, int, int, int]:
    """B14's launch shape for `rows` packed rows of X cells at K steps with
    the seeded chains from cell reset_cell: (threads a block, blocks a
    chain, i.e. the cluster size, tiles of the seeded chain [reset_cell,
    X), tiles of the chain [0, reset_cell) from zero). B6's tiles and caps;
    one cluster a chain."""
    out = (ctypes.c_int * 4)()
    cs._raise_on("df_halo_bdf2_geometry",
                 load_kernels().rt_df_halo_bdf2_geometry(
                     X, K, reset_cell, DF_BDF2_THREADS, DF_BDF2_MAX_CLUSTER,
                     rows, out))
    return tuple(out)


def df_bdf2_launch(cbe, ccn, cbdf, dbe, dcn, dbdf, bc, bcl, flip, e0h, e0l,
                   e1h, e1l, *, K: int, reflective: bool,
                   symmetric_half: bool, use_corr: bool, blk: int,
                   npass: dict, npass_c: dict):
    """B6: K whole double-float BDF2 steps in one launch (see
    ``df_bdf2_launch_ref``). `blk`/`npass`/`npass_c` shape the plain
    version's blocked scans; the kernel scans its own tiles exactly, each
    row's tiles as a wavefront over a cluster of blocks
    (``df_bdf2_geometry``)."""
    if e0h.device.type == "cpu":
        return df_bdf2_launch_ref(
            cbe, ccn, cbdf, dbe, dcn, dbdf, bc, bcl, flip, e0h, e0l, e1h,
            e1l, K=K, reflective=reflective, symmetric_half=symmetric_half,
            use_corr=use_corr, blk=blk, npass=npass, npass_c=npass_c)
    name = "df_bdf2_launch"
    ins = (e0h, e0l, e1h, e1l)
    Bh, N = _check_df(name, (cbe, ccn, cbdf), (dbe, dcn, dbdf), bc, bcl,
                      flip, ins)
    cs._check_K(name, K)
    lib = load_kernels()
    outs = [torch.empty_like(e0h) for _ in range(12)]
    rec = torch.empty((Bh, 2, 4 * K), dtype=torch.float32, device=e0h.device)
    planes = _plane_array(ins, outs)
    with torch.cuda.device(e0h.device):
        rc = lib.rt_df_bdf2(
            *map(cs._ptr, (cbe, ccn, cbdf, dbe, dcn, dbdf, bc, bcl, flip,
                           rec)),
            planes, Bh, N, K, int(symmetric_half), int(reflective),
            int(use_corr), DF_BDF2_THREADS, DF_BDF2_MAX_CLUSTER,
            cs._stream(e0h.device))
    cs._raise_on(name, rc)
    df_bdf2_launch.launches += 1
    return tuple(outs)


def df_multistep_launch(kind: int, coef, dcoef, bc, bcl, flip, e0h, e0l, e1h,
                        e1l, *, K: int, reflective: bool, use_corr: bool,
                        blk: int, npass: int, npass_c: int):
    """B7: K whole double-float BE or CN steps in one launch (see
    ``df_multistep_launch_ref``)."""
    if e0h.device.type == "cpu":
        return df_multistep_launch_ref(
            kind, coef, dcoef, bc, bcl, flip, e0h, e0l, e1h, e1l, K=K,
            reflective=reflective, use_corr=use_corr, blk=blk, npass=npass,
            npass_c=npass_c)
    name = "df_multistep_launch"
    if kind not in (BE, CN):
        raise ValueError(f"{name}: runs BE or CN, got kind {kind}")
    ins = (e0h, e0l, e1h, e1l)
    Bh, N = _check_df(name, (coef,), (dcoef,), bc, bcl, flip, ins)
    cs._check_K(name, K)
    lib = load_kernels()
    outs = [torch.empty_like(e0h) for _ in range(8)]
    rec = torch.empty((Bh, 2, K), dtype=torch.float32, device=e0h.device)
    planes = _plane_array(ins, outs)
    with torch.cuda.device(e0h.device):
        rc = lib.rt_df_multistep(
            kind, *map(cs._ptr, (coef, dcoef, bc, bcl, flip, rec)), planes,
            Bh, N, K, int(reflective), int(use_corr),
            cs._stream(e0h.device))
    cs._raise_on(name, rc)
    df_multistep_launch.launches += 1
    return tuple(outs)


def _check_df_packed(name: str, coefs, dcoefs, seeds_h, seeds_l, planes,
                     C: int, reset: int, blk: int):
    """Validate a packed-rows df kernel's inputs; returns (rows, X)."""
    rows, X = cs._check_packed(name, coefs, seeds_h, planes, C, reset, blk)
    dev = planes[0].device
    for t, cols, what in [(d, _NDF, "df coefficients") for d in dcoefs] + [
            (seeds_l, C, "seeds_l")]:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (rows, cols) or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"({rows}, {cols}) on {dev}")
    return rows, X


def df_halo_bdf2_launch(cbe, ccn, cbdf, dbe, dcn, dbdf, seeds_h, seeds_l,
                        reset: int, e0h, e0l, e1h, e1l, *, K: int,
                        symmetric_half: bool, use_corr: bool, blk: int,
                        npass: dict, npass_c: dict):
    """B14: K whole seeded double-float BDF2 steps over packed (rows, X)
    planes in one launch (see ``df_halo_bdf2_launch_ref``). The kernel
    restarts the chains at cell reset*blk and scans exactly, each chain a
    wavefront over a cluster of blocks on B6's tiles
    (``df_halo_bdf2_geometry``). Returns the 12 planes and the record's hi
    and lo."""
    if e0h.device.type == "cpu":
        return df_halo_bdf2_launch_ref(
            cbe, ccn, cbdf, dbe, dcn, dbdf, seeds_h, seeds_l, reset, e0h,
            e0l, e1h, e1l, K=K, symmetric_half=symmetric_half,
            use_corr=use_corr, blk=blk, npass=npass, npass_c=npass_c)
    name = "df_halo_bdf2_launch"
    cs._check_K(name, K)
    ins = (e0h, e0l, e1h, e1l)
    rows, X = _check_df_packed(name, (cbe, ccn, cbdf), (dbe, dcn, dbdf),
                               seeds_h, seeds_l, ins, 4 * K, reset, blk)
    lib = load_kernels()
    outs = [torch.empty_like(e0h) for _ in range(12)]
    rec = torch.empty((2, rows, 4 * K), dtype=torch.float32,
                      device=e0h.device)
    planes = _plane_array(ins, outs)
    with torch.cuda.device(e0h.device):
        rc = lib.rt_df_halo_bdf2(
            *map(cs._ptr, (cbe, ccn, cbdf, dbe, dcn, dbdf, seeds_h, seeds_l,
                           rec)),
            planes, rows, X, K, reset * blk, int(symmetric_half),
            int(use_corr), DF_BDF2_THREADS, DF_BDF2_MAX_CLUSTER,
            cs._stream(e0h.device))
    cs._raise_on(name, rc)
    df_halo_bdf2_launch.launches += 1
    return (*outs, rec[0], rec[1])


def df_halo_multistep_launch(kind: int, coef, dcoef, seeds_h, seeds_l,
                             reset: int, e0h, e0l, e1h, e1l, *, K: int,
                             use_corr: bool, blk: int, npass: int,
                             npass_c: int):
    """B15: K whole seeded double-float BE or CN steps over packed (rows,
    X) planes in one launch. Returns the 8 planes and the record's hi and
    lo."""
    if e0h.device.type == "cpu":
        return df_halo_multistep_launch_ref(
            kind, coef, dcoef, seeds_h, seeds_l, reset, e0h, e0l, e1h, e1l,
            K=K, use_corr=use_corr, blk=blk, npass=npass, npass_c=npass_c)
    name = "df_halo_multistep_launch"
    if kind not in (BE, CN):
        raise ValueError(f"{name}: runs BE or CN, got kind {kind}")
    cs._check_K(name, K)
    ins = (e0h, e0l, e1h, e1l)
    rows, X = _check_df_packed(name, (coef,), (dcoef,), seeds_h, seeds_l,
                               ins, K, reset, blk)
    lib = load_kernels()
    outs = [torch.empty_like(e0h) for _ in range(8)]
    rec = torch.empty((2, rows, K), dtype=torch.float32, device=e0h.device)
    planes = _plane_array(ins, outs)
    with torch.cuda.device(e0h.device):
        rc = lib.rt_df_halo_multistep(
            kind, *map(cs._ptr, (coef, dcoef, seeds_h, seeds_l, rec)),
            planes, rows, X, K, reset * blk, int(use_corr),
            cs._stream(e0h.device))
    cs._raise_on(name, rc)
    df_halo_multistep_launch.launches += 1
    return (*outs, rec[0], rec[1])


def reset_launch_counts() -> None:
    """Zero every df wrapper's count of kernel launches."""
    for w in (df_bdf2_launch, df_multistep_launch, df_halo_bdf2_launch,
              df_halo_multistep_launch):
        w.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class DFState(NamedTuple):
    """Double-float sweep state: value = hi + lo, each a FlatState of
    (2, Bh, N) float32 planes."""

    hi: FlatState
    lo: FlatState


class DFLayout:
    """State layout shared by the double-float engines: DFState planes
    (2, Bh, N) float32 on `self.device`, converted to and from the global
    float64 (M, G, N, 2) edge arrays. Needs cfg, tables, device, Mh, G and
    Bh. A mesh engine's planes are its rank's shard: it overrides `_local`
    and `_gather`, as for cuda_sweep.FlatLayout."""

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def init_state(self) -> DFState:
        """psi = ends = B_g everywhere (solver.cpp:165-181), split to
        double-float so the initial condition is exact to ~2^-48."""
        B64 = np.broadcast_to(
            np.asarray(self.tables.B, dtype=np.float64)[None, :],
            (self.Mh, self.G)).reshape(self.Bh)

        def plane(v):
            x = torch.as_tensor(v, device=self.device)[None, :, None]
            return self._local(x.expand(2, self.Bh, self.cfg.N)).contiguous()

        bh, bl = df.np_df(B64)
        ph, plo = plane(bh), plane(bl)
        return DFState(FlatState(ph, ph, ph, ph, ph, ph),
                       FlatState(plo, plo, plo, plo, plo, plo))

    def from_ends(self, ends, prev, half) -> DFState:
        """Global float64 (M, G, N, 2) arrays -> DFState on the engine's
        device."""
        his, los = [], []
        for x in (ends, prev, half):
            x = torch.as_tensor(x).to(device=self.device,
                                      dtype=torch.float64)
            for plane in fs.from_ends(x):
                plane = self._local(plane)
                hi = plane.float()
                his.append(hi)
                los.append((plane - hi.double()).float())
        return DFState(FlatState(*his), FlatState(*los))

    def ends_pair(self, hi0, lo0, hi1, lo1) -> torch.Tensor:
        """(hi, lo) edge planes -> global float64 (M, G, N, 2)."""
        g = self._gather
        return fs.ends_pair(g(hi0).double() + g(lo0).double(),
                            g(hi1).double() + g(lo1).double(), self.Mh,
                            self.G)

    def ends(self, st: DFState) -> torch.Tensor:
        return self.ends_pair(st.hi.e0, st.lo.e0, st.hi.e1, st.lo.e1)

    def prev_half_ends(self, st: DFState):
        """(prev_ends, half_ends) as global float64 (M, G, N, 2) arrays."""
        return (self.ends_pair(st.hi.p0, st.lo.p0, st.hi.p1, st.lo.p1),
                self.ends_pair(st.hi.h0, st.lo.h0, st.hi.h1, st.lo.h1))


class DFCudaEngine(DFLayout):
    """The counterpart of DFPallasEngine: f64-grade K-step fused sweeps
    over double-float (2, Bh, N) planes on `device` (the CUDA kernels B6
    and B7 on a card, their plain versions on the CPU)."""

    def __init__(self, cfg: Config, tables, block: Optional[int] = None,
                 scan_tol: float = 1e-10, device="cuda"):
        self.cfg = cfg
        self.tables = tables
        self.device = torch.device(device)
        Mh, G = cfg.M // 2, cfg.G
        self.Mh, self.G = Mh, G
        self.Bh = Mh * G
        # The JAX walk; an explicit block is pinned, as under its
        # interpreter.
        self.block = select_block(cfg, block, interpret=True)
        self.nblocks = cfg.N // self.block

        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)

        def npass(tol):
            return {kind: cs._scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))),
                self.block, tol) for kind, kc in self.kcs.items()}

        self.scan_npass = npass(scan_tol)
        self.corr_npass = npass(CORR_SCAN_TOL)

        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float64)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros(self.Bh)                    # unused
        bch, bcl = df.np_df(np.stack([bc_neg, bc_pos]))
        dev = self.device
        self.bc = torch.as_tensor(bch[..., None], device=dev)    # (2, Bh, 1)
        self.bcl = torch.as_tensor(bcl[..., None], device=dev)
        self.flip = torch.as_tensor(
            fs._refl_flip_indices(Mh, G).astype(np.int32), device=dev)
        self.coef = {kind: torch.as_tensor(cs._pack_coeffs(kc), device=dev)
                     for kind, kc in self.kcs.items()}
        self.dcoef = {kind: torch.as_tensor(
            _pack_df_coeffs(cfg, tables, kind, kc.ts), device=dev)
            for kind, kc in self.kcs.items()}

    # -- stepping -------------------------------------------------------------

    def max_steps_per_launch(self) -> int:
        """Fusion depth: the JAX df engine's choice (df_sweep.py:972-990),
        kept until it is re-derived on the card."""
        p = self.Bh * self.block
        if self.cfg.ts_method in (1, 2):
            return 8 if self.Bh <= 16 else 4
        if self.Bh <= 4:
            return 4
        if p <= (1 << 15):
            return 8
        if p < (1 << 16):
            return 4
        if p == (1 << 16):
            return 2
        return 4

    def step(self, st: DFState) -> DFState:
        return self.multi_step(st, 1)

    def multi_step(self, st: DFState, K: int) -> DFState:
        """K whole timesteps in ONE kernel launch."""
        hi, lo = st
        ins = (hi.e0, lo.e0, hi.e1, lo.e1)
        kw = dict(K=K, reflective=self.reflective,
                  use_corr=bool(self.cfg.use_correction), blk=self.block)
        if self.cfg.ts_method in (1, 2):
            kind = BE if self.cfg.ts_method == 1 else CN
            (o0h, o0l, o1h, o1l, p0h, p0l, p1h, p1l) = df_multistep_launch(
                kind, self.coef[kind], self.dcoef[kind], self.bc, self.bcl,
                self.flip, *ins, npass=self.scan_npass[kind],
                npass_c=self.corr_npass[kind], **kw)
            return DFState(FlatState(o0h, o1h, p0h, p1h, hi.h0, hi.h1),
                           FlatState(o0l, o1l, p0l, p1l, lo.h0, lo.h1))
        (o0h, o0l, o1h, o1l, h0h, h0l, h1h, h1l,
         p0h, p0l, p1h, p1l) = df_bdf2_launch(
            self.coef[BE], self.coef[CN], self.coef[BDF], self.dcoef[BE],
            self.dcoef[CN], self.dcoef[BDF], self.bc, self.bcl, self.flip,
            *ins, symmetric_half=self.cfg.bdf2_symmetric_half,
            npass=self.scan_npass, npass_c=self.corr_npass, **kw)
        return DFState(FlatState(o0h, o1h, p0h, p1h, h0h, h1h),
                       FlatState(o0l, o1l, p0l, p1l, h0l, h1l))

    def solve(self, state: Optional[DFState] = None,
              num_steps: Optional[int] = None,
              steps_per_launch: Optional[int] = None) -> DFState:
        """Run n timesteps, K whole steps per kernel launch (default
        max_steps_per_launch(), or as many as remain)."""
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        K = steps_per_launch or min(self.max_steps_per_launch(), max(n, 1))
        K = min(K, cs.MAX_FUSED_STEPS)
        body, tail = divmod(n, K)
        for _ in range(body):
            state = self.multi_step(state, K)
        if tail:
            state = self.multi_step(state, tail)
        return state
