"""Kernel-rate adjoint: differentiable whole timesteps on CUDA kernels.

Port of radiative_transfer_tpu/ops/pallas_adjoint.py. Four kernel wrappers
carry it:

* ``fwd_record_launch`` — one step plus per-tile records of each phase's
  carry at tile entry and of the upwind e1 / hs1 edges (B9,
  ``_make_fwd_record_kernel``);
* ``bwd_launch`` — the transposed step: tiles visited downstream to
  upstream, the forward recomputed from the inputs and records, the
  sub-step adjoint in reverse phase order, the coefficient and boundary
  cotangents accumulated (B10, ``_make_bwd_kernel``);
* ``fwd_record_k_launch`` — K whole BDF2 steps in one launch with each
  step's records and the intermediate steps' input planes (B11,
  ``_make_fwd_record_kernel_bdf2_k``);
* ``bwd_k_launch`` — the transposed K-step launch, the steps newest to
  oldest at every tile, each recomputed from its own input plane (B12,
  ``_make_bwd_kernel_bdf2_k``).

Three structural facts keep it compact (module doc of the JAX original):
the step is affine in the state, so the state adjoint is the transposed
affine cycle; the adjoint of the carry scan carry_j = a*carry_{j-1} + b_j
is the same scan run in the reversed direction; and the coefficient
gradients need the primal values, which the backward recomputes from the
step's input planes and the tiny records. One grad step therefore costs
about one forward (the recompute) and one transposed cycle on top of the
forward itself.

Each wrapper launches its kernel in csrc/adjoint.cu for a CUDA tensor and
raises if it cannot; for a CPU tensor it runs its plain PyTorch version
(``*_launch_ref``), which keeps the JAX kernels' blocks, truncated
Hillis-Steele scans (forward and reversed), (half, block) visit order and
operation order (the K-step plain versions are K plain steps: the JAX
K-step kernels are their exact composition). The records follow the visit
unit: the plain versions record per JAX block, (2, nph, Bh, N // blk), the
kernels per CUDA tile, (2, nph, Bh, record_tiles(N)); each backward refuses
the other's. The kernels scan exactly, so on the card the backward is the
exact adjoint of the card's own forward. On the card B10 and B12 run each
row as a wavefront over (1024-cell sub-tile, slot) from the row's end on a
cluster of blocks (``bwd_geometry``), after a prologue that recomputes
each sub-tile's entering forward carries into a scratch the wrapper
allocates; B11 runs each row as B1's wavefront over (tile, slot) on a
cluster (``fwd_k_geometry``); B9 runs one block a tile of each row, the
step's phases chained across the tiles by a multi-slot decoupled look-back
(``fwd_geometry``), in a status scratch the wrapper allocates. Each wrapper
counts its launches.

``DiffCudaStep`` and ``DiffCudaStepK`` (the counterparts of
``DiffPallasStep`` and ``DiffPallasStepK``) are the
``torch.autograd.Function``s over the pairs, and ``make_diff_solve_cuda``
(``make_diff_solve_pallas``) the differentiable solve built on them, K-fused
by default at BDF2 as JAX's, with the parameters entering through
adjoint.traced_tables -> fast_sweep.build_kind_coeffs_traced ->
``_pack_coeffs_traced``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..adjoint import _PARAM_KEYS, traced_initial_state, traced_tables
from ..config.config import Config
from ..models.transport import State
from . import cuda_sweep as cs
from . import fast_sweep as fs
from ._cuda_build import load as load_kernels
from .cuda_sweep import _NCOEF, _Coef, _unpack_coef
from .fast_sweep import BDF, BE, CN, FlatState

# B9's record tile (csrc/adjoint.cu, B1's tile in csrc/sweep.cu): kFwdCells
# cells a thread, at most kFwdThreads threads a row block.
_K_CELLS, _MAX_THREADS = 8, 512

# B9's look-back tile: at most this many threads a block (a power of two;
# 8 cells a thread, so the tile divides the 4096-cell record tile).
ADJ_FWD_THREADS = 64

# B10's and B12's launch shape: at most this many threads a block (a power
# of two; a sub-tile is 4 cells a thread, 256 keeps four 1024-cell
# sub-tiles a 4096-cell record tile) and blocks a row (a cluster; above 8 a
# non-portable size). The kernels take fewer blocks a row where the card
# cannot hold every row's cluster at once.
ADJ_BWD_THREADS = 256
ADJ_BWD_MAX_CLUSTER = 16


def record_tiles(N: int) -> int:
    """Tiles of a row in B9, the last axis of the kernels' records: the
    block has enough warps for N cells at _K_CELLS a thread, at most
    _MAX_THREADS (tiles.cuh pick_threads)."""
    t = -(-N // _K_CELLS)
    t = min(max(-(-t // 32) * 32, 32), _MAX_THREADS)
    return -(-N // (t * _K_CELLS))


# ---------------------------------------------------------------------------
# Reversed truncated scan and the shifts
# ---------------------------------------------------------------------------

def _rev_scan_masks(blk: int) -> np.ndarray:
    """masks[k, 0, col] = 1.0 iff col < blk - stride_k (the mirror of
    cuda_sweep._scan_masks): pass k of the reversed scan pulls from
    col + stride."""
    col = np.arange(blk)[None, :]
    return np.asarray([col < blk - d for d in cs._scan_strides(blk)],
                      dtype=np.float32).reshape(-1, 1, blk)


def _hillis_steele_rev(x, a, mrev, npass: int):
    """out_i = sum_{j>=i} a^{j-i} x_j along axis 1, truncated to `npass`
    passes: the transpose of cuda_sweep._hillis_steele."""
    pref = x
    apow = a
    for k in range(npass):
        rolled = torch.roll(pref, -(1 << k), dims=1)
        pref = pref + (apow * mrev[k]) * rolled
        apow = apow * apow
    return pref


def _shift_up(x, last, tail=None):
    """Adjoint of shift1 (x_j -> x_{j-1} with a tail fill): y_j = x_{j+1}
    for j < blk-1, and y_{blk-1} = tail (the cotangent arriving from the
    downstream block's first cell), default 0."""
    rolled = torch.roll(x, -1, dims=1)
    fill = torch.zeros_like(x[:, :1]) if tail is None else tail
    return torch.where(last, fill, rolled)


# ---------------------------------------------------------------------------
# Forward sub-step with its primals, and its adjoint
# ---------------------------------------------------------------------------

class _SubPrimals(NamedTuple):
    r0: torch.Tensor
    r1: torch.Tensor
    psi: torch.Tensor
    cin: torch.Tensor
    u: torch.Tensor
    p1s: torch.Tensor        # zeros for BE
    h1s: torch.Tensor        # zeros for BE and CN
    o1: torch.Tensor
    carry_out: torch.Tensor


def _substep_vals(kind, kc: _Coef, first, masks, e0, e1, p0, p1, h0, h1,
                  c_in, ptail, htail, npass: int):
    """cuda_sweep._substep_block with the primal intermediates the
    adjoint's coefficient gradients need (same algebra and order;
    reference solver.cpp:319-587). Returns (o0, o1, _SubPrimals)."""

    def shift1(x, tail):
        return torch.where(first, tail, torch.roll(x, 1, dims=1))

    psi = 0.5 * (e0 + e1)
    S = kc.Sb + kc.c1 * psi + kc.c0
    z = torch.zeros_like(e0)
    p1s = h1s = z
    if kind == BE:
        r0 = S + kc.kee * e0
        r1 = S + kc.kee * e1
    elif kind == CN:
        p1s = shift1(p1, ptail)
        r0 = S + kc.kee * e0 - kc.q * e1 + kc.w * p1s
        r1 = S + kc.q * e0 + kc.kee * e1
    else:
        p1s = shift1(p1, ptail)
        h1s = shift1(h1, htail)
        r0 = (S + kc.kee * h0 - 2.0 * kc.w * h1 - kc.kp * p0 - kc.q * p1
              + kc.w * (4.0 * h1s + p1s))
        r1 = S + 2.0 * kc.w * h0 + kc.kee * h1 + kc.q * p0 - kc.kp * p1

    b = (kc.q * r0 + kc.T0 * r1) * kc.idet
    b_adj = torch.where(first, b + kc.a * c_in, b)
    pref = cs._hillis_steele(b_adj, kc.a, masks, npass)
    carry_out = pref[:, -1:]
    cin = torch.where(first, c_in, torch.roll(pref, 1, dims=1))
    u = r0 + kc.w * cin
    o0 = (kc.T0 * u - kc.q * r1) * kc.idet
    o1 = (kc.q * u + kc.T0 * r1) * kc.idet
    return o0, o1, _SubPrimals(r0, r1, psi, cin, u, p1s, h1s, o1, carry_out)


class _SubCots(NamedTuple):
    e0: torch.Tensor
    e1: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    h0: torch.Tensor
    h1: torch.Tensor
    c_in: torch.Tensor       # (Bh, 1) cotangent on the incoming carry
    ptail: torch.Tensor      # (Bh, 1) cotangent on the upstream p1 edge
    htail: torch.Tensor      # (Bh, 1) cotangent on the upstream hs1 edge
    coef: torch.Tensor       # (Bh, NCOEF) gradient rows (cell-summed)


def _substep_adj(kind, kc: _Coef, last, mrev, pr: _SubPrimals,
                 e0, e1, p0, p1, h0, h1, o0c, o1c, carry_out_c,
                 npass: int) -> _SubCots:
    """Transpose of _substep_vals: cotangents on (o0, o1, carry_out) ->
    cotangents on the input planes, the incoming carry, the upstream
    edges, and the per-row coefficient gradients summed over the block's
    cells, in the packed column order [w, T0, q, idet, a, Sb, c1, c0, kee,
    kp]. The state adjoint needs only the coefficients (the step is
    affine in the state); the input planes and primals feed the
    coefficient gradients."""
    # Reconstruct adjoint: o0 = idet(T0 u - q r1), o1 = idet(q u + T0 r1).
    u_c = kc.idet * (kc.T0 * o0c + kc.q * o1c)
    r1_c = kc.idet * (kc.T0 * o1c - kc.q * o0c)
    cin_c = kc.w * u_c

    # Scan adjoint: the pref cotangent is the rolled-up cin cotangent with
    # the outgoing carry's cotangent in the last column (cin_0 reads c_in
    # directly; pref[-1] feeds only carry_out).
    pref_c = _shift_up(cin_c, last, carry_out_c)
    b_adj_c = _hillis_steele_rev(pref_c, kc.a, mrev, npass)
    c_in_c = kc.a * b_adj_c[:, :1] + cin_c[:, :1]
    b_c = b_adj_c
    r0_c = u_c + kc.idet * kc.q * b_c
    r1_c = r1_c + kc.idet * kc.T0 * b_c

    S_c = r0_c + r1_c
    z = torch.zeros_like(o0c)
    zc = torch.zeros_like(o0c[:, :1])
    p0c = p1c = h0c = h1c = z
    ptail_c = htail_c = zc
    half = 0.5 * kc.c1 * S_c

    def rs(x):
        return torch.sum(x, dim=1, keepdim=True)

    if kind == BE:
        e0c = kc.kee * r0_c + half
        e1c = kc.kee * r1_c + half
        g_kee = rs(e0 * r0_c + e1 * r1_c)
        g_kp = g_w_rhs = g_q_rhs = zc
    elif kind == CN:
        e0c = kc.kee * r0_c + kc.q * r1_c + half
        e1c = -kc.q * r0_c + kc.kee * r1_c + half
        p1s_c = kc.w * r0_c
        p1c = _shift_up(p1s_c, last)
        ptail_c = p1s_c[:, :1]
        g_kee = rs(e0 * r0_c + e1 * r1_c)
        g_kp = zc
        g_w_rhs = rs(pr.p1s * r0_c)
        g_q_rhs = rs(-e1 * r0_c + e0 * r1_c)
    else:
        e0c = half
        e1c = half
        h0c = kc.kee * r0_c + 2.0 * kc.w * r1_c
        h1c = -2.0 * kc.w * r0_c + kc.kee * r1_c
        p0c = -kc.kp * r0_c + kc.q * r1_c
        p1c = -kc.q * r0_c - kc.kp * r1_c
        p1s_c = kc.w * r0_c
        h1s_c = 4.0 * kc.w * r0_c
        p1c = p1c + _shift_up(p1s_c, last)
        h1c = h1c + _shift_up(h1s_c, last)
        ptail_c = p1s_c[:, :1]
        htail_c = h1s_c[:, :1]
        g_kee = rs(h0 * r0_c + h1 * r1_c)
        g_kp = rs(-p0 * r0_c - p1 * r1_c)
        g_w_rhs = rs((-2.0 * h1 + 4.0 * pr.h1s + pr.p1s) * r0_c
                     + 2.0 * h0 * r1_c)
        g_q_rhs = rs(-p1 * r0_c + p0 * r1_c)

    P0 = kc.T0 * pr.u - kc.q * pr.r1        # o0 = idet * P0
    P1 = kc.q * pr.u + kc.T0 * pr.r1        # o1 = idet * P1
    qr = kc.q * pr.r0 + kc.T0 * pr.r1       # b = idet * qr
    g_idet = rs(P0 * o0c + P1 * o1c + qr * b_c)
    g_T0 = rs(kc.idet * (pr.u * o0c + pr.r1 * o1c + pr.r1 * b_c))
    g_q = g_q_rhs + rs(kc.idet * (-pr.r1 * o0c + pr.u * o1c
                                  + pr.r0 * b_c))
    g_a = rs(pr.cin * b_adj_c)              # scan-transpose identity
    g_Sb = rs(S_c)
    g_c0 = rs(S_c)
    g_c1 = rs(pr.psi * S_c)
    g_w = g_w_rhs + rs(pr.cin * u_c)
    coef = torch.cat([g_w, g_T0, g_q, g_idet, g_a, g_Sb, g_c1, g_c0,
                      g_kee, g_kp], dim=1)
    return _SubCots(e0c, e1c, p0c, p1c, h0c, h1c, c_in_c, ptail_c,
                    htail_c, coef)


# ---------------------------------------------------------------------------
# Plain versions of B9 and B10 (the blocked TPU algorithm)
# ---------------------------------------------------------------------------

def _phase_setup(ts_method: int, s_be: float, s_cn: float, s_bdf: float):
    """(bdf2, number of phases, s of each phase, the BE/CN step's kind)."""
    bdf2 = ts_method == 3
    kind1 = BE if ts_method == 1 else CN
    s_of = ([s_be, s_cn, s_be, s_bdf] if bdf2
            else [s_be if ts_method == 1 else s_cn])
    return bdf2, (4 if bdf2 else 1), s_of, kind1


def _masks(e0, blk: int, npass: dict):
    """(nb, forward masks, reversed masks, first, last, zero column)."""
    nb, masks, first, zt = cs._block_setup(e0, blk, max(npass.values()))
    mrev = torch.as_tensor(_rev_scan_masks(blk)[:masks.shape[0]],
                           device=e0.device)
    last = torch.arange(blk, device=e0.device)[None, :] == blk - 1
    return nb, masks, mrev, first, last, zt


def fwd_record_launch_ref(cbe, ccn, cbdf, bc, flip, e0, e1, *,
                          ts_method: int, s_be: float, s_cn: float,
                          s_bdf: float, reflective: bool,
                          symmetric_half: bool, blk: int, npass: dict):
    """Plain version of B9 (``_make_fwd_record_kernel``): one whole step
    (BE, CN, or the BDF2 four-phase cycle) in the (half, block) order, with
    each block's entry records. Returns (o0, o1, h0, h1, rc, ret, rht):
    the new ends, the half snapshot (for BE/CN the input planes
    themselves, which the step leaves untouched), rc (2, nph, Bh, nb) each
    phase's carry entering each block, ret/rht (2, Bh, nb) the upwind e1 and
    hs1 edges entering it."""
    bdf2, nph, s_of, kind1 = _phase_setup(ts_method, s_be, s_cn, s_bdf)
    nb, masks, _, first, _, zt = _masks(e0, blk, npass)
    Bh = e0.shape[1]
    o0, o1 = torch.empty_like(e0), torch.empty_like(e0)
    h0, h1 = (torch.empty_like(e0), torch.empty_like(e0)) if bdf2 else (e0,
                                                                       e1)
    rc = torch.zeros((2, nph, Bh, nb), dtype=e0.dtype, device=e0.device)
    ret = torch.zeros((2, Bh, nb), dtype=e0.dtype, device=e0.device)
    rht = torch.zeros_like(ret)
    carries = None
    for h in (0, 1):
        carries = cs._half_inflow(carries, s_of, bc, flip, h, reflective)
        etail = htail = zt
        kbe, kcn, kbdf = (_unpack_coef(c[h]) for c in (cbe, ccn, cbdf))
        for i in range(nb):
            for p in range(nph):
                rc[h, p, :, i] = carries[p][:, 0]
            ret[h, :, i] = etail[:, 0]
            rht[h, :, i] = htail[:, 0]
            sl = slice(i * blk, (i + 1) * blk)
            x0, x1 = e0[h, :, sl], e1[h, :, sl]

            def sub(kind, kc, p, a0, a1, pp0, pp1, hh0, hh1, pt, ht):
                f0, f1, pr = _substep_vals(kind, kc, first, masks, a0, a1,
                                           pp0, pp1, hh0, hh1, carries[p],
                                           pt, ht, npass[kind])
                carries[p] = pr.carry_out
                return f0, f1

            if bdf2:
                b0, b1 = sub(BE, kbe, 0, x0, x1, x0, x1, x0, x1, zt, zt)
                c0, c1 = sub(CN, kcn, 1, b0, b1, x0, x1, x0, x1, etail, zt)
                snap_cn = symmetric_half or h == 0
                hs0, hs1 = (c0, c1) if snap_cn else (b0, b1)
                d0, d1 = sub(BE, kbe, 2, c0, c1, x0, x1, hs0, hs1, zt, zt)
                f0, f1 = sub(BDF, kbdf, 3, d0, d1, x0, x1, hs0, hs1, etail,
                             htail)
                htail = hs1[:, -1:]
                h0[h, :, sl], h1[h, :, sl] = hs0, hs1
            else:
                kc1 = kbe if ts_method == 1 else kcn
                f0, f1 = sub(kind1, kc1, 0, x0, x1, x0, x1, x0, x1, etail,
                             zt)
            etail = x1[:, -1:]
            o0[h, :, sl], o1[h, :, sl] = f0, f1
    return o0, o1, h0, h1, rc, ret, rht


def bwd_launch_ref(cbe, ccn, cbdf, flip, e0, e1, co0, co1, coh0, coh1, rc,
                   ret, rht, *, ts_method: int, s_be: float, s_cn: float,
                   s_bdf: float, reflective: bool, symmetric_half: bool,
                   blk: int, npass: dict):
    """Plain version of B10 (``_make_bwd_kernel``): the transposed step.
    Visits the mu>0 half first, blocks downstream to upstream, then the
    mu<0 half, so the adjoint carries flow in visit order and, for a
    reflective slab, the mu>0 inflow cotangent (flipped, s-scaled) seeds
    the mu<0 half's outflow. Per block it recomputes the forward phases
    from the inputs and the block's records, then runs _substep_adj in
    reverse phase order. (co0, co1, coh0, coh1) are the cotangents of
    (o0, o1, h0, h1); the h ones are read for BDF2 only. Returns (ce0, ce1,
    cbc (2, Bh, 1), gbe, gcn, gbdf (2, Bh, 10)); the packs of kinds the
    step does not run are zero."""
    bdf2, nph, s_of, kind1 = _phase_setup(ts_method, s_be, s_cn, s_bdf)
    nb, masks, mrev, first, last, zt = _masks(e0, blk, npass)
    if rc.shape[-1] != nb:
        raise ValueError(f"bwd_launch_ref: records of {rc.shape[-1]} blocks, "
                         f"the step has {nb}")
    Bh = e0.shape[1]
    ce0, ce1 = torch.empty_like(e0), torch.empty_like(e0)
    cbc = torch.zeros((2, Bh, 1), dtype=e0.dtype, device=e0.device)
    gpack = [torch.zeros((2, Bh, _NCOEF), dtype=e0.dtype, device=e0.device)
             for _ in range(3)]
    lam = None
    for g0 in (0, 1):
        h = 1 - g0
        if reflective and g0 == 1:
            # Entering the mu<0 half: its outflow carry's cotangent is the
            # flipped, s-scaled mu>0 inflow cotangent left in lam.
            lam = [s_of[p] * lam[p][flip] for p in range(nph)]
        else:
            lam = [zt] * nph
        cet = cht = zt
        gacc = [torch.zeros((Bh, _NCOEF), dtype=e0.dtype, device=e0.device)
                for _ in range(3)]
        kbe, kcn, kbdf = (_unpack_coef(c[h]) for c in (cbe, ccn, cbdf))
        snap_cn = symmetric_half or h == 0
        for g1 in range(nb):
            i = nb - 1 - g1
            sl = slice(i * blk, (i + 1) * blk)
            x0, x1 = e0[h, :, sl], e1[h, :, sl]
            et_rec = ret[h, :, i:i + 1]
            ht_rec = rht[h, :, i:i + 1]
            rcs = [rc[h, p, :, i:i + 1] for p in range(nph)]
            f0c, f1c = co0[h, :, sl], co1[h, :, sl]

            def vals(kind, kc, p, *planes, pt=zt, ht=zt):
                return _substep_vals(kind, kc, first, masks, *planes, rcs[p],
                                     pt, ht, npass[kind])

            def adj(kind, kc, pr, planes, oc0, oc1, p):
                return _substep_adj(kind, kc, last, mrev, pr, *planes,
                                    oc0, oc1, lam[p], npass[kind])

            if bdf2:
                # Forward recompute (the records give the block carries).
                b0, b1, prB = vals(BE, kbe, 0, x0, x1, x0, x1, x0, x1)
                c0, c1, prC = vals(CN, kcn, 1, b0, b1, x0, x1, x0, x1,
                                   pt=et_rec)
                hs0, hs1 = (c0, c1) if snap_cn else (b0, b1)
                d0, d1, prD = vals(BE, kbe, 2, c0, c1, x0, x1, hs0, hs1)
                _, _, prF = vals(BDF, kbdf, 3, d0, d1, x0, x1, hs0, hs1,
                                 pt=et_rec, ht=ht_rec)

                # Adjoint, reverse phase order.
                hs0c = coh0[h, :, sl]
                hs1c = coh1[h, :, sl] + torch.where(last, cht, 0.0)
                A3 = adj(BDF, kbdf, prF, (d0, d1, x0, x1, hs0, hs1), f0c,
                         f1c, 3)
                lam[3] = A3.c_in
                A2 = adj(BE, kbe, prD, (c0, c1, x0, x1, hs0, hs1), A3.e0,
                         A3.e1, 2)
                lam[2] = A2.c_in
                hs0c = hs0c + A3.h0
                hs1c = hs1c + A3.h1
                if snap_cn:
                    c0c, c1c = A2.e0 + hs0c, A2.e1 + hs1c
                    b0c, b1c = torch.zeros_like(hs0c), torch.zeros_like(hs1c)
                else:
                    c0c, c1c = A2.e0, A2.e1
                    b0c, b1c = hs0c, hs1c
                A1 = adj(CN, kcn, prC, (b0, b1, x0, x1, x0, x1), c0c, c1c, 1)
                lam[1] = A1.c_in
                A0 = adj(BE, kbe, prB, (x0, x1, x0, x1, x0, x1),
                         b0c + A1.e0, b1c + A1.e1, 0)
                lam[0] = A0.c_in
                e0c = A0.e0 + A3.p0
                e1c = A0.e1 + A3.p1 + A1.p1
                e1c = e1c + torch.where(last, cet, 0.0)
                cet = A1.ptail + A3.ptail
                cht = A3.htail
                gacc[0] = gacc[0] + A0.coef + A2.coef
                gacc[1] = gacc[1] + A1.coef
                gacc[2] = gacc[2] + A3.coef
            else:
                kc1 = kbe if ts_method == 1 else kcn
                _, _, pr = vals(kind1, kc1, 0, x0, x1, x0, x1, x0, x1,
                                pt=et_rec)
                A0 = adj(kind1, kc1, pr, (x0, x1, x0, x1, x0, x1), f0c, f1c,
                         0)
                lam[0] = A0.c_in
                e0c = A0.e0
                e1c = A0.e1 + A0.p1
                e1c = e1c + torch.where(last, cet, 0.0)
                cet = A0.ptail
                gacc[0] = gacc[0] + A0.coef
            ce0[h, :, sl], ce1[h, :, sl] = e0c, e1c

        # The half's start reached: the inflow cotangents fold into bc (s of
        # each phase); for a reflective slab bc feeds the mu<0 half only.
        acc = torch.zeros_like(zt)
        for p in range(nph):
            acc = acc + s_of[p] * lam[p]
        if not reflective or g0 == 1:
            cbc[h] = acc
        if bdf2:
            for g, a in zip(gpack, gacc):
                g[h] = a
        else:
            gpack[ts_method - 1][h] = gacc[0]
    return (ce0, ce1, cbc, *gpack)


def _bdf2_only(name: str, ts_method: int) -> None:
    if ts_method != 3:
        raise ValueError(f"{name}: the K-fused kernels run BDF2 (ts_method "
                         f"3), got ts_method {ts_method}")


def fwd_record_k_launch_ref(cbe, ccn, cbdf, bc, flip, e0, e1, *, K: int,
                            ts_method: int, s_be: float, s_cn: float,
                            s_bdf: float, reflective: bool,
                            symmetric_half: bool, blk: int, npass: dict):
    """Plain version of B11 (``_make_fwd_record_kernel_bdf2_k``): K whole
    BDF2 steps with each step's records, as K plain B9 steps (the fused
    program is exactly their composition: the JAX kernel runs B9's block
    body per (step, block)). Returns (o0, o1, h0, h1, p0, p1, rc, ret, rht,
    ri0, ri1): the last step's ends and half snapshot, p the last step's
    input, rc (2, 4K, Bh, nb) with slot 4k+p step k's phase-p carries,
    ret/rht (2, K, Bh, nb) step k's upwind edges, ri0/ri1 (K-1, 2, Bh, N)
    the inputs of steps 1..K-1."""
    _bdf2_only("fwd_record_k_launch_ref", ts_method)
    geo = dict(ts_method=3, s_be=s_be, s_cn=s_cn, s_bdf=s_bdf,
               reflective=reflective, symmetric_half=symmetric_half,
               blk=blk, npass=npass)
    ins, recs = [(e0, e1)], []
    for _ in range(K):
        o0, o1, h0, h1, *rec = fwd_record_launch_ref(
            cbe, ccn, cbdf, bc, flip, *ins[-1], **geo)
        recs.append(rec)
        ins.append((o0, o1))
    p0, p1 = ins[K - 1] if K > 1 else (e0.clone(), e1.clone())
    rc = torch.cat([r[0] for r in recs], dim=1)
    ret, rht = (torch.stack([r[i] for r in recs], dim=1) for i in (1, 2))
    ri0, ri1 = (torch.stack([x[i] for x in ins[1:K]]) if K > 1 else
                e0.new_empty((0, *e0.shape)) for i in (0, 1))
    return o0, o1, h0, h1, p0, p1, rc, ret, rht, ri0, ri1


def bwd_k_launch_ref(cbe, ccn, cbdf, flip, e0, e1, ri0, ri1, co0, co1, coh0,
                     coh1, cop0, cop1, rc, ret, rht, *, K: int,
                     ts_method: int, s_be: float, s_cn: float, s_bdf: float,
                     reflective: bool, symmetric_half: bool, blk: int,
                     npass: dict):
    """Plain version of B12 (``_make_bwd_kernel_bdf2_k``): the transposed K
    steps, newest to oldest, as K plain B10 steps. Step k recomputes from
    its own input (e for k = 0, ri[k-1] otherwise) and its records; its
    output cotangent is step k+1's input cotangent. The external cotangents
    enter at step K-1 (JAX's order): (co0, co1) of the ends and (coh0,
    coh1) of the half snapshot as its outputs', (cop0, cop1) of prev, which
    is step K-1's input, added to its input's; the half cotangent of the
    steps before is zero. Returns (ce0, ce1, cbc, gbe, gcn, gbdf), cbc and
    the packs summed over the steps."""
    _bdf2_only("bwd_k_launch_ref", ts_method)
    if ri0.shape[0] != K - 1 or rc.shape[1] != 4 * K or ret.shape[1] != K:
        raise ValueError(f"bwd_k_launch_ref: records of another K than {K}")
    geo = dict(ts_method=3, s_be=s_be, s_cn=s_cn, s_bdf=s_bdf,
               reflective=reflective, symmetric_half=symmetric_half,
               blk=blk, npass=npass)
    zero = torch.zeros_like(co0)
    oc0, oc1 = co0, co1
    sums = []
    for k in reversed(range(K)):
        x0, x1 = (e0, e1) if k == 0 else (ri0[k - 1], ri1[k - 1])
        hc = (coh0, coh1) if k == K - 1 else (zero, zero)
        oc0, oc1, *rest = bwd_launch_ref(
            cbe, ccn, cbdf, flip, x0, x1, oc0, oc1, *hc,
            rc[:, 4 * k:4 * k + 4], ret[:, k], rht[:, k], **geo)
        if k == K - 1:
            oc0, oc1 = oc0 + cop0, oc1 + cop1
        sums.append(rest)
    cbc, gbe, gcn, gbdf = (sum(s[i] for s in reversed(sums)) for i in range(4))
    return oc0, oc1, cbc, gbe, gcn, gbdf


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_records(name: str, device, N: int, *pairs) -> int:
    """Refuses records that are not contiguous float32 on `device` in the
    kernels' shapes: `pairs` of (tensor, shape), each shape's last entry
    None for the kernels' record_tiles(N). Returns record_tiles(N)."""
    nt = record_tiles(N)
    for t, shape in pairs:
        shape = tuple(nt if d is None else d for d in shape)
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: records must be contiguous float32 "
                             f"{shape} on {device} (the kernels' "
                             f"{nt} tiles), got {tuple(t.shape)}")
    return nt


def fwd_geometry(N: int) -> Tuple[int, int, int]:
    """B9's launch shape for rows of N cells: (threads a block, look-back
    tiles a row, blocks a multiprocessor holds at once); the kernel runs
    one block a tile. Kept per (N, threads): the wrapper sizes its scratch
    from it at every launch."""
    return _fwd_geometry(N, ADJ_FWD_THREADS)


@functools.lru_cache(maxsize=None)
def _fwd_geometry(N: int, max_threads: int) -> Tuple[int, int, int]:
    out = (ctypes.c_int * 3)()
    cs._raise_on("fwd_geometry",
                 load_kernels().rt_adj_fwd_geometry(N, max_threads, out))
    return tuple(out)


def fwd_record_launch(cbe, ccn, cbdf, bc, flip, e0, e1, *, ts_method: int,
                      s_be: float, s_cn: float, s_bdf: float,
                      reflective: bool, symmetric_half: bool, blk: int,
                      npass: dict):
    """B9: one whole step with its records (see fwd_record_launch_ref).
    On the card the step's phases are the slots of a look-back scan over
    tiles of ``fwd_geometry`` (one block a tile, both halves in one
    launch, the mu<0 half's tiles first for a reflective boundary), and
    the records are per record tile (B1's 4096-cell tile), (2, nph, Bh,
    record_tiles(N)); `blk`/`npass` shape the plain version only."""
    if e0.device.type == "cpu":
        return fwd_record_launch_ref(
            cbe, ccn, cbdf, bc, flip, e0, e1, ts_method=ts_method,
            s_be=s_be, s_cn=s_cn, s_bdf=s_bdf, reflective=reflective,
            symmetric_half=symmetric_half, blk=blk, npass=npass)
    name = "fwd_record_launch"
    if ts_method not in (1, 2, 3):
        raise ValueError(f"{name}: unknown ts_method {ts_method}")
    Bh, N = cs._check_cuda(name, (cbe, ccn, cbdf), bc, flip, (e0, e1))
    bdf2, nph, _, _ = _phase_setup(ts_method, s_be, s_cn, s_bdf)
    nt = record_tiles(N)
    lib = load_kernels()
    o0, o1 = torch.empty_like(e0), torch.empty_like(e0)
    h0, h1 = (torch.empty_like(e0), torch.empty_like(e0)) if bdf2 else (e0,
                                                                       e1)
    rc = torch.empty((2, nph, Bh, nt), dtype=torch.float32, device=e0.device)
    ret = torch.empty((2, Bh, nt), dtype=torch.float32, device=e0.device)
    rht = torch.empty_like(ret)
    # The look-back's words, one a (slot or hs1 edge, row, tile), and the
    # tile counter: the entry point zeroes them before the launch.
    _, tiles, _ = fwd_geometry(N)
    status = torch.empty((nph + bdf2) * 2 * Bh * tiles + 1, dtype=torch.int64,
                         device=e0.device)
    hp = (h0, h1) if bdf2 else (None, None)
    with torch.cuda.device(e0.device):
        rc_ = lib.rt_adj_fwd_record(
            ts_method, *map(_ptr, (cbe, ccn, cbdf, bc, flip, e0, e1, o0, o1,
                                   *hp, rc, ret, rht, status)),
            Bh, N, nt, s_be, s_cn, s_bdf, int(symmetric_half),
            int(reflective), ADJ_FWD_THREADS, cs._stream(e0.device))
    cs._raise_on(name, rc_)
    fwd_record_launch.launches += 1
    return o0, o1, h0, h1, rc, ret, rht


def bwd_launch(cbe, ccn, cbdf, flip, e0, e1, co0, co1, coh0, coh1, rc, ret,
               rht, *, ts_method: int, s_be: float, s_cn: float,
               s_bdf: float, reflective: bool, symmetric_half: bool,
               blk: int, npass: dict):
    """B10: the transposed step (see bwd_launch_ref). On the card it takes
    fwd_record_launch's per-tile records and refuses any other shape; each
    row's sub-tiles run as a wavefront from the row's end over a cluster of
    blocks (``bwd_geometry``)."""
    if e0.device.type == "cpu":
        return bwd_launch_ref(
            cbe, ccn, cbdf, flip, e0, e1, co0, co1, coh0, coh1, rc, ret, rht,
            ts_method=ts_method, s_be=s_be, s_cn=s_cn, s_bdf=s_bdf,
            reflective=reflective, symmetric_half=symmetric_half, blk=blk,
            npass=npass)
    name = "bwd_launch"
    if ts_method not in (1, 2, 3):
        raise ValueError(f"{name}: unknown ts_method {ts_method}")
    bdf2, nph, _, _ = _phase_setup(ts_method, s_be, s_cn, s_bdf)
    cots = (co0, co1, coh0, coh1) if bdf2 else (co0, co1)
    cbc = torch.zeros((2, e0.shape[1], 1), dtype=torch.float32,
                      device=e0.device)
    Bh, N = cs._check_cuda(name, (cbe, ccn, cbdf), cbc, flip,
                           (e0, e1, *cots))
    nt = _check_records(name, e0.device, N, (rc, (2, nph, Bh, None)),
                        (ret, (2, Bh, None)), (rht, (2, Bh, None)))
    lib = load_kernels()
    ce0, ce1 = torch.empty_like(e0), torch.empty_like(e0)
    gpack = [torch.zeros((2, Bh, _NCOEF), dtype=torch.float32,
                         device=e0.device) for _ in range(3)]
    inflow = torch.empty((Bh, nph), dtype=torch.float32, device=e0.device)
    hc = (coh0, coh1) if bdf2 else (None, None)
    with torch.cuda.device(e0.device):
        scr = _bwd_scratch(N, 1, Bh, nph, reflective, e0.device)
        rc_ = lib.rt_adj_bwd(
            ts_method, *map(_ptr, (cbe, ccn, cbdf, flip, inflow, e0, e1, co0,
                                   co1, *hc, rc, ret, rht, scr, ce0, ce1, cbc,
                                   *gpack)),
            Bh, N, nt, s_be, s_cn, s_bdf, int(symmetric_half),
            int(reflective), ADJ_BWD_THREADS, ADJ_BWD_MAX_CLUSTER,
            cs._stream(e0.device))
    cs._raise_on(name, rc_)
    bwd_launch.launches += 1
    return (ce0, ce1, cbc, *gpack)


def fwd_record_k_launch(cbe, ccn, cbdf, bc, flip, e0, e1, *, K: int,
                        ts_method: int, s_be: float, s_cn: float,
                        s_bdf: float, reflective: bool, symmetric_half: bool,
                        blk: int, npass: dict):
    """B11: K whole BDF2 steps in one launch with their records (see
    fwd_record_k_launch_ref). On the card the records are per kernel tile,
    rc (2, 4K, Bh, record_tiles(N)), ret/rht (2, K, Bh, record_tiles(N));
    each row's tiles run as B1's wavefront over a cluster of blocks
    (``fwd_k_geometry``); `blk`/`npass` shape the plain version only."""
    name = "fwd_record_k_launch"
    _bdf2_only(name, ts_method)
    cs._check_K(name, K)
    if e0.device.type == "cpu":
        return fwd_record_k_launch_ref(
            cbe, ccn, cbdf, bc, flip, e0, e1, K=K, ts_method=ts_method,
            s_be=s_be, s_cn=s_cn, s_bdf=s_bdf, reflective=reflective,
            symmetric_half=symmetric_half, blk=blk, npass=npass)
    Bh, N = cs._check_cuda(name, (cbe, ccn, cbdf), bc, flip, (e0, e1))
    nt = record_tiles(N)
    lib = load_kernels()

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=e0.device)

    outs = [torch.empty_like(e0) for _ in range(6)]
    rc, ret, rht = new(2, 4 * K, Bh, nt), new(2, K, Bh, nt), new(2, K, Bh, nt)
    ri0, ri1 = new(K - 1, 2, Bh, N), new(K - 1, 2, Bh, N)
    outflow = new(Bh, 4 * K)
    ri = (ri0, ri1) if K > 1 else (None, None)
    with torch.cuda.device(e0.device):
        rc_ = lib.rt_adj_fwd_record_k(
            *map(_ptr, (cbe, ccn, cbdf, bc, flip, outflow, e0, e1, *outs, rc,
                        ret, rht, *ri)),
            Bh, N, K, nt, s_be, s_cn, s_bdf, int(symmetric_half),
            int(reflective), cs.SWEEP_MAX_CLUSTER, cs._stream(e0.device))
    cs._raise_on(name, rc_)
    fwd_record_k_launch.launches += 1
    return (*outs, rc, ret, rht, ri0, ri1)


def bwd_k_launch(cbe, ccn, cbdf, flip, e0, e1, ri0, ri1, co0, co1, coh0,
                 coh1, cop0, cop1, rc, ret, rht, *, K: int, ts_method: int,
                 s_be: float, s_cn: float, s_bdf: float, reflective: bool,
                 symmetric_half: bool, blk: int, npass: dict):
    """B12: the transposed K steps in one launch (see bwd_k_launch_ref). On
    the card it takes fwd_record_k_launch's per-tile records and refuses
    any other shape; each row's sub-tiles run as a wavefront from the
    row's end over a cluster of blocks (``bwd_geometry``)."""
    name = "bwd_k_launch"
    _bdf2_only(name, ts_method)
    cs._check_K(name, K)
    if e0.device.type == "cpu":
        return bwd_k_launch_ref(
            cbe, ccn, cbdf, flip, e0, e1, ri0, ri1, co0, co1, coh0, coh1,
            cop0, cop1, rc, ret, rht, K=K, ts_method=ts_method, s_be=s_be,
            s_cn=s_cn, s_bdf=s_bdf, reflective=reflective,
            symmetric_half=symmetric_half, blk=blk, npass=npass)
    cbc = torch.zeros((2, e0.shape[1], 1), dtype=torch.float32,
                      device=e0.device)
    Bh, N = cs._check_cuda(name, (cbe, ccn, cbdf), cbc, flip,
                           (e0, e1, co0, co1, coh0, coh1, cop0, cop1))
    nt = _check_records(name, e0.device, N, (rc, (2, 4 * K, Bh, None)),
                        (ret, (2, K, Bh, None)), (rht, (2, K, Bh, None)),
                        (ri0, (K - 1, 2, Bh, N)), (ri1, (K - 1, 2, Bh, N)))
    lib = load_kernels()
    ce0, ce1 = torch.empty_like(e0), torch.empty_like(e0)
    gpack = [torch.zeros((2, Bh, _NCOEF), dtype=torch.float32,
                         device=e0.device) for _ in range(3)]
    inflow = torch.empty((Bh, 4 * K), dtype=torch.float32, device=e0.device)
    ri = (ri0, ri1) if K > 1 else (None, None)
    with torch.cuda.device(e0.device):
        scr = _bwd_scratch(N, K, Bh, 4, reflective, e0.device)
        rc_ = lib.rt_adj_bwd_k(
            *map(_ptr, (cbe, ccn, cbdf, flip, inflow, e0, e1, *ri, co0, co1,
                        coh0, coh1, cop0, cop1, rc, ret, rht, scr, ce0, ce1,
                        cbc, *gpack)),
            Bh, N, K, nt, s_be, s_cn, s_bdf, int(symmetric_half),
            int(reflective), ADJ_BWD_THREADS, ADJ_BWD_MAX_CLUSTER,
            cs._stream(e0.device))
    cs._raise_on(name, rc_)
    bwd_k_launch.launches += 1
    return (ce0, ce1, cbc, *gpack)


def fwd_k_geometry(N: int, K: int, rows: int) -> Tuple[int, int, int]:
    """B11's launch shape for `rows` rows a launch (Bh for a reflective
    boundary, else 2*Bh) of N cells at K steps: (threads a block, blocks a
    row, i.e. the cluster size, tiles a row). The tiles are the record
    tiles (``record_tiles``), B1's at cuda_sweep.SWEEP_THREADS; at most
    cuda_sweep.SWEEP_MAX_CLUSTER blocks a row, as B1."""
    out = (ctypes.c_int * 3)()
    lib = load_kernels()
    cs._raise_on("fwd_k_geometry", lib.rt_adj_fwd_record_k_geometry(
        N, K, cs.SWEEP_MAX_CLUSTER, rows, out))
    return tuple(out)


def bwd_geometry(N: int, K: int, rows: int,
                 slots_per_step: int = 4) -> Tuple[int, int, int]:
    """B10's and B12's launch shape for `rows` rows a launch (Bh for a
    reflective boundary, else 2*Bh) of N cells at K steps of
    `slots_per_step` slots (4: BDF2, B12 or B10; 1: B10 at BE or CN, K =
    1): (threads a block, blocks a row, i.e. the cluster size, sub-tiles a
    row)."""
    out = (ctypes.c_int * 3)()
    cs._raise_on("bwd_geometry", load_kernels().rt_adj_bwd_geometry(
        N, K, slots_per_step, ADJ_BWD_THREADS, ADJ_BWD_MAX_CLUSTER, rows,
        out))
    return tuple(out)


def _bwd_scratch(N: int, K: int, Bh: int, slots_per_step: int,
                 reflective: bool, device) -> torch.Tensor:
    """The prologue scratch of B10/B12: each sub-tile's entering forward
    carries and hs1 edges, (2, Bh, sub-tiles, slots + K) float32."""
    subs = bwd_geometry(N, K, Bh if reflective else 2 * Bh,
                        slots_per_step)[2]
    return torch.empty((2, Bh, subs, slots_per_step * K + K),
                       dtype=torch.float32, device=device)


def _ptr(t) -> "object":
    """A tensor's device address for ctypes (None for an absent plane)."""
    return None if t is None else cs._ptr(t)


def reset_launch_counts() -> None:
    """Zero the four wrappers' counts of kernel launches."""
    for w in (fwd_record_launch, bwd_launch, fwd_record_k_launch,
              bwd_k_launch):
        w.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# The differentiable step and solve
# ---------------------------------------------------------------------------

def _pack_coeffs_traced(kc: fs.KindCoeffs) -> torch.Tensor:
    """Differentiable twin of cuda_sweep._pack_coeffs: KindCoeffs float64
    planes (1, 2, Bh, 1) -> (2, Bh, NCOEF) float32."""
    cols = [kc.w, kc.T0, kc.q, kc.inv_det, kc.a, kc.Sbase, kc.c1, kc.c0,
            kc.k_ee, kc.k_p]
    return torch.cat([torch.as_tensor(c)[0] for c in cols],
                     dim=-1).to(torch.float32)


def step_geometry(eng: cs.CudaSweepEngine) -> dict:
    """The two kernels' keyword arguments from an engine: the kinds' s
    (JAX's defaults 1, 2, 6 for kinds the step does not run), the
    boundary kind, the half-snapshot mode, and the plain versions' block
    and scan passes (all passes for kinds the engine does not run)."""
    full = len(cs._scan_strides(eng.block))
    s = {k: float(eng.kcs[k].s) if k in eng.kcs else d
         for k, d in ((BE, 1.0), (CN, 2.0), (BDF, 6.0))}
    return dict(ts_method=eng.cfg.ts_method, s_be=s[BE], s_cn=s[CN],
                s_bdf=s[BDF], reflective=eng.reflective,
                symmetric_half=bool(eng.cfg.bdf2_symmetric_half),
                blk=eng.block,
                npass={k: eng.scan_npass.get(k, full) for k in (BE, CN, BDF)})


class DiffCudaStep(torch.autograd.Function):
    """A differentiable whole timestep on the engine's plane layout:

        DiffCudaStep.apply(eng, e0, e1, cbe, ccn, cbdf, bc)
            -> (o0, o1, h0, h1)

    forward = B9, backward = B10 -> (ce0, ce1, gbe, gcn, gbdf, cbc). For
    BDF2 the h outputs are the step's half snapshot; a BE/CN step leaves
    the h planes alone (h0, h1 are e0, e1), and their cotangents are
    routed by the solve, so the backward zeroes them. prev planes are by
    definition the input ends, so the caller forms them. Geometry (block,
    scan passes, boundary, flip, the kinds' s) comes from `eng`, a
    CudaSweepEngine; the residuals are the input planes, the packs and
    the records."""

    @staticmethod
    def forward(ctx, eng, e0, e1, cbe, ccn, cbdf, bc):
        geo = step_geometry(eng)
        o0, o1, h0, h1, rc, ret, rht = fwd_record_launch(
            cbe, ccn, cbdf, bc, eng.flip, e0, e1, **geo)
        ctx.geo = geo
        ctx.flip = eng.flip
        ctx.save_for_backward(e0, e1, cbe, ccn, cbdf, rc, ret, rht)
        return o0, o1, h0, h1

    @staticmethod
    def backward(ctx, o0c, o1c, h0c, h1c):
        e0, e1, cbe, ccn, cbdf, rc, ret, rht = ctx.saved_tensors
        cots = [c.to(torch.float32).contiguous() for c in (o0c, o1c)]
        if ctx.geo["ts_method"] == 3:
            cots += [c.to(torch.float32).contiguous() for c in (h0c, h1c)]
        else:
            # The h planes never enter a BE/CN step.
            cots += [torch.zeros_like(cots[0])] * 2
        ce0, ce1, cbc, gbe, gcn, gbdf = bwd_launch(
            cbe, ccn, cbdf, ctx.flip, e0, e1, *cots, rc, ret, rht,
            **ctx.geo)
        return None, ce0, ce1, gbe, gcn, gbdf, cbc


class DiffCudaStepK(torch.autograd.Function):
    """K fused differentiable BDF2 timesteps (the counterpart of
    ``DiffPallasStepK``):

        DiffCudaStepK.apply(eng, K, e0, e1, cbe, ccn, cbdf, bc)
            -> (o0, o1, h0, h1, p0, p1)

    forward = B11, backward = B12 -> (ce0, ce1, gbe, gcn, gbdf, cbc). prev
    is the LAST step's input (the K-step sweep's contract), returned because
    the intermediate ends never leave the launch. The residuals are the
    input planes, the packs, the records and the K-1 intermediate inputs:
    two planes a step, as K = 1 keeps. Cotangents of outputs the loss does
    not use arrive as zeros."""

    @staticmethod
    def forward(ctx, eng, K, e0, e1, cbe, ccn, cbdf, bc):
        geo = step_geometry(eng)
        o0, o1, h0, h1, p0, p1, *res = fwd_record_k_launch(
            cbe, ccn, cbdf, bc, eng.flip, e0, e1, K=K, **geo)
        ctx.geo = geo
        ctx.K = K
        ctx.flip = eng.flip
        ctx.save_for_backward(e0, e1, cbe, ccn, cbdf, *res)
        return o0, o1, h0, h1, p0, p1

    @staticmethod
    def backward(ctx, *cots):
        e0, e1, cbe, ccn, cbdf, rc, ret, rht, ri0, ri1 = ctx.saved_tensors
        cots = [c.to(torch.float32).contiguous() for c in cots]
        ce0, ce1, cbc, gbe, gcn, gbdf = bwd_k_launch(
            cbe, ccn, cbdf, ctx.flip, e0, e1, ri0, ri1, *cots, rc, ret, rht,
            K=ctx.K, **ctx.geo)
        return None, None, ce0, ce1, gbe, gcn, gbdf, cbc


def make_diff_solve_cuda(cfg: Config, tables, num_steps=None,
                         remat_group: Optional[int] = None,
                         steps_per_launch: Optional[int] = None,
                         device="cuda"):
    """Differentiable solve at kernel rate (JAX make_diff_solve_pallas).

    ``solve_fn(params, state=None) -> State`` in the global (M, G, N, 2)
    float64 layout on `device`. ``params`` holds any of adjoint._PARAM_KEYS
    (numpy arrays or tensors); omitted ones stay at their ``tables``
    values. ``state=None`` starts from psi = B_g built from the traced B,
    so a T gradient includes the initial condition. Forward and backward
    run the CUDA kernels (the plain versions for ``device='cpu'``);
    gradients are the exact adjoint of that float32 program, f32-grade
    against the float64 adjoints.

    ``steps_per_launch`` (BDF2 only), JAX's rule: None fuses K =
    min(max_steps_per_launch(), 4, num_steps) steps a launch on
    ``DiffCudaStepK`` (B11-B12), an explicit value max(1, K); K = 1, or
    num_steps < K, runs one step a launch on ``DiffCudaStep`` (B9-B10), as
    BE and CN always do. num_steps % K tail steps run on ``DiffCudaStep``.
    The kernels run at most ``MAX_FUSED_STEPS`` (64) steps a launch, so a
    larger K splits each K-step group into launches of 64 steps and one
    of the rest, as CudaSweepEngine.solve splits its own (K = 100: 64 +
    36); the program, and so the trajectory and its gradient, is the same
    as one K-step launch's to float32 roundoff.

    Memory: the residuals are two input planes a step (a K-step launch
    keeps its input and its K-1 intermediate inputs) plus the tiny records.
    ``remat_group=g`` (or None with num_steps > 256, which picks g ~
    sqrt(number of launches)) runs the launches in groups of g under
    ``torch.utils.checkpoint``: only the group-boundary states and one
    group's residuals are held at a time, for one extra forward a group.
    It counts K-step groups, as JAX counts its launches: a group that K >
    64 splits into several launches counts as one.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_diff_solve_cuda: no CUDA device; pass "
                           "device='cpu' for the plain versions")
    n = cfg.max_timesteps if num_steps is None else num_steps
    eng = cs.CudaSweepEngine(cfg, tables, device=device)
    if steps_per_launch is None:
        K = (min(eng.max_steps_per_launch(), 4, max(n, 1))
             if cfg.ts_method == 3 else 1)
    else:
        K = max(1, steps_per_launch)
    if cfg.ts_method != 3 or n < K:
        K = 1
    split = [cs.MAX_FUSED_STEPS] * (K // cs.MAX_FUSED_STEPS)
    if K % cs.MAX_FUSED_STEPS:
        split.append(K % cs.MAX_FUSED_STEPS)
    Mh, G, Bh = cfg.M // 2, cfg.G, eng.Bh
    if cfg.ts_method == 1:
        kinds = {BE: cfg.dt}
    elif cfg.ts_method == 2:
        kinds = {CN: cfg.dt}
    else:
        half = cfg.dt / 2.0
        kinds = {BE: half, CN: half, BDF: half}

    def solve_fn(params: dict, state=None):
        unknown = set(params) - set(_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown differentiable parameters {sorted(unknown)}; "
                f"supported: {_PARAM_KEYS}")
        t = traced_tables(cfg, tables, **params)
        packs = {k: _pack_coeffs_traced(
            fs.build_kind_coeffs_traced(cfg, t, k, ts)).to(device)
            for k, ts in kinds.items()}
        zeros = torch.zeros((2, Bh, _NCOEF), dtype=torch.float32,
                            device=device)
        cbe, ccn, cbdf = (packs.get(k, zeros) for k in (BE, CN, BDF))
        # Boundary value planes, as CudaSweepEngine builds them (incl. the
        # left-vacuum fallthrough to the source, solver.cpp:667-671); the
        # reflective/fixed structure is static.
        psi_plane = fs._to_plane(t.psi_source, Mh, G)
        zb = torch.zeros(Bh, dtype=torch.float64)
        bc_neg = psi_plane[0] if cfg.bc_right_indicator == 1 else zb
        bc_pos = zb if cfg.bc_left_indicator == 2 else psi_plane[1]
        bc = torch.stack([bc_neg, bc_pos])[..., None].to(
            device=device, dtype=torch.float32).contiguous()

        if state is None:   # B on the device: the broadcast fills there
            state = traced_initial_state(cfg, t._replace(B=t.B.to(device)))
        pairs = [fs.from_ends(torch.as_tensor(x).to(
            device=device, dtype=torch.float32)) for x in state]
        st = FlatState(*(p for pair in pairs for p in pair))

        def steps(s: FlatState, count: int) -> FlatState:
            """`count` launches of one step each."""
            for _ in range(count):
                o0, o1, h0, h1 = DiffCudaStep.apply(eng, s.e0, s.e1, cbe,
                                                    ccn, cbdf, bc)
                if cfg.ts_method == 3:
                    s = FlatState(o0, o1, s.e0, s.e1, h0, h1)
                else:
                    s = FlatState(o0, o1, s.e0, s.e1, s.h0, s.h1)
            return s

        def launches(s: FlatState, count: int) -> FlatState:
            """`count` groups of K steps each, each group one launch a
            piece of `split`."""
            if K == 1:
                return steps(s, count)
            for _ in range(count):
                for k in split:
                    o0, o1, h0, h1, p0, p1 = DiffCudaStepK.apply(
                        eng, k, s.e0, s.e1, cbe, ccn, cbdf, bc)
                    s = FlatState(o0, o1, p0, p1, h0, h1)
            return s

        n_launch, n_tail = divmod(n, K)
        g = remat_group
        if g is None and n > 256:
            g = max(1, int(math.sqrt(n_launch)))
        if g and g > 1 and n_launch > g:
            ngroups, gtail = divmod(n_launch, g)
            for _ in range(ngroups):
                st = FlatState(*checkpoint(
                    lambda *planes: tuple(launches(FlatState(*planes), g)),
                    *st, use_reentrant=False))
            st = launches(st, gtail)
        else:
            st = launches(st, n_launch)
        st = steps(st, n_tail)

        def pair(x0, x1):
            return fs.ends_pair(x0.to(torch.float64), x1.to(torch.float64),
                                Mh, G)

        return State(ends=pair(st.e0, st.e1), prev_ends=pair(st.p0, st.p1),
                     half_ends=pair(st.h0, st.h1))

    return solve_fn
