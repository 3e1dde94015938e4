"""Single-pass sweep engine on hand-written CUDA kernels.

Port of radiative_transfer_tpu/ops/pallas_sweep.py (PallasEngine and its
kernel factories). Three kernel wrappers carry the engine:

* ``substep_launch``   — one BE, CN or BDF sub-step (B3, ``_make_kernel``;
  one block a tile, decoupled look-back, ``substep_geometry``);
* ``multistep_launch`` — K whole BE or CN steps (B2,
  ``_make_multistep_kernel``);
* ``bdf2_launch``      — K whole BDF2 four-phase steps (B1,
  ``_make_bdf2_kernel``).

Two more carry the packed-rows halo engine (parallel/halo_cuda.py):

* ``halo_bdf2_launch``      — seeded K-step BDF2 over packed rows (B4,
  ``_make_halo_bdf2_kernel``);
* ``halo_multistep_launch`` — seeded K-step BE or CN (B5,
  ``_make_halo_multistep_kernel``).

One carries the per-sub-step mesh engine (parallel/sharded_cuda.py):

* ``sharded_substep_launch`` — a zero-inflow BE, CN or BDF sub-step over
  packed rows, the pending corrections applied on load (B8,
  ``_make_sharded_packed_kernel``; csrc/sharded.cu).

Each wrapper launches its kernel in csrc/sweep.cu (B8: csrc/sharded.cu)
for a CUDA tensor and raises if it cannot (B1, B2, B4 and B5 walk each row
as a wavefront over a thread block cluster, ``sweep_geometry``,
``halo_bdf2_geometry`` and ``halo_multistep_geometry``; a refused cluster
launch raises too); for a CPU
tensor it runs its plain PyTorch version
(``*_launch_ref``), which keeps the JAX kernel's blocked algorithm: the
same (half, block) visit order, the same truncated Hillis-Steele scan
(_scan_npass passes) and the same operation order, so on the CPU it
agrees with the JAX kernel in interpret mode to f32 roundoff. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

State layout: flat sweep-order planes (2, Bh, N) float32 (ops/fast_sweep
module doc). Coefficients: (2, Bh, 10) float32 per sub-step kind, in the
column order _W.._KP. The halo kernels take the same arrays packed as
(rows, X) = (2*Bh, X), the mu<0 rows first.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.config import Config
from . import fast_sweep as fs
from ._cuda_build import load as load_kernels
from .fast_sweep import BDF, BE, CN, FlatState

# Packed per-(half, batch) coefficient plane column indices.
_W, _T0, _Q, _IDET, _A, _SB, _C1, _C0, _KEE, _KP = range(10)
_NCOEF = 10

# Steps one CUDA launch can fuse (csrc/sweep.cu kMaxSlots / 4).
MAX_FUSED_STEPS = 64


def _pack_coeffs(kc: fs.KindCoeffs) -> np.ndarray:
    """KindCoeffs (1, 2, Bh, 1) planes -> (2, Bh, NCOEF) float32."""
    cols = [kc.w, kc.T0, kc.q, kc.inv_det, kc.a, kc.Sbase, kc.c1, kc.c0,
            kc.k_ee, kc.k_p]
    packed = np.concatenate([np.asarray(c)[0, :, :, :] for c in cols],
                            axis=-1)
    return packed.astype(np.float32)


def _scan_strides(blk: int) -> Tuple[int, ...]:
    """The Hillis-Steele pass strides 1, 2, 4, ... below blk."""
    out = []
    d = 1
    while d < blk:
        out.append(d)
        d *= 2
    return tuple(out)


def _scan_masks(blk: int) -> np.ndarray:
    """Per-pass edge masks: masks[k, 0, col] = 1.0 iff col >= stride_k."""
    col = np.arange(blk)[None, :]
    return np.asarray([col >= d for d in _scan_strides(blk)],
                      dtype=np.float32).reshape(-1, 1, blk)


def _scan_npass(a_max: float, blk: int, tol: float) -> int:
    """Passes needed for the truncated scan to be `tol`-accurate: the
    smallest k with a^(2^k)/(1-a) < tol (the neglected upwind tail, a < 1
    being the carry multiplier); tol=0 keeps all log2(blk) passes."""
    full = len(_scan_strides(blk))
    if tol <= 0.0 or not np.isfinite(a_max):
        return full
    a = min(max(float(a_max), 0.0), 1.0 - 1e-12)
    for k in range(full):
        if a ** (1 << k) / (1.0 - a) < tol:
            return k
    return full


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (the blocked TPU algorithm)
# ---------------------------------------------------------------------------

class _Coef(NamedTuple):
    w: torch.Tensor
    T0: torch.Tensor
    q: torch.Tensor
    idet: torch.Tensor
    a: torch.Tensor
    Sb: torch.Tensor
    c1: torch.Tensor
    c0: torch.Tensor
    kee: torch.Tensor
    kp: torch.Tensor


def _unpack_coef(c: torch.Tensor) -> _Coef:
    """(Bh, NCOEF) -> ten (Bh, 1) columns."""
    return _Coef(*(c[:, k:k + 1] for k in range(_NCOEF)))


def _hillis_steele(b, a, masks, npass: int):
    """Inclusive prefix of carry_j = a*carry_{j-1} + b_j along axis 1
    (zero init), truncated to `npass` roll + mul + add passes."""
    pref = b
    apow = a
    for k in range(npass):
        rolled = torch.roll(pref, 1 << k, dims=1)
        pref = pref + (apow * masks[k]) * rolled
        apow = apow * apow
    return pref


def _substep_block(kind, kc: _Coef, first, masks, e0, e1, p0, p1, h0, h1,
                   c_in, ptail, htail, npass: int):
    """One sub-step on one (Bh, blk) block: RHS build, truncated in-block
    scan, 2x2 reconstruct. `c_in` is the carry entering the block and
    `ptail`/`htail` the previous block's last p1/h1 edge values.
    Returns (o0, o1, carry leaving the block)."""

    def shift1(x, tail):
        return torch.where(first, tail, torch.roll(x, 1, dims=1))

    psi = 0.5 * (e0 + e1)
    S = kc.Sb + kc.c1 * psi + kc.c0

    if kind == BE:
        r0 = S + kc.kee * e0
        r1 = S + kc.kee * e1
    elif kind == CN:
        r0 = S + kc.kee * e0 - kc.q * e1 + kc.w * shift1(p1, ptail)
        r1 = S + kc.q * e0 + kc.kee * e1
    else:  # BDF
        r0 = (
            S + kc.kee * h0 - 2.0 * kc.w * h1 - kc.kp * p0 - kc.q * p1
            + kc.w * (4.0 * shift1(h1, htail) + shift1(p1, ptail))
        )
        r1 = S + 2.0 * kc.w * h0 + kc.kee * h1 + kc.q * p0 - kc.kp * p1

    b = (kc.q * r0 + kc.T0 * r1) * kc.idet

    b_adj = torch.where(first, b + kc.a * c_in, b)
    pref = _hillis_steele(b_adj, kc.a, masks, npass)
    carry_in = torch.where(first, c_in, torch.roll(pref, 1, dims=1))

    u = r0 + kc.w * carry_in
    o0 = (kc.T0 * u - kc.q * r1) * kc.idet
    o1 = (kc.q * u + kc.T0 * r1) * kc.idet
    return o0, o1, pref[:, -1:]


def _block_setup(e0: torch.Tensor, blk: int, npass_max: int):
    N = e0.shape[-1]
    if N % blk:
        raise ValueError(f"block {blk} does not divide N={N}")
    masks = torch.as_tensor(_scan_masks(blk)[:max(1, npass_max)],
                            device=e0.device)
    first = torch.arange(blk, device=e0.device)[None, :] < 1
    zt = torch.zeros((e0.shape[-2], 1), dtype=e0.dtype, device=e0.device)
    return N // blk, masks, first, zt


def _half_inflow(carries, s_of, bc, flip, h: int, reflective: bool):
    """Carries entering half h, one per (step, phase) slot: s * the
    boundary value, or for the mu>0 half of a reflective slab s * the
    flipped mu<0 outflow `carries` of the same slot."""
    if h == 1 and reflective:
        return [s * c[flip] for s, c in zip(s_of, carries)]
    return [s * bc[h] for s in s_of]


def _pick(snap_cn, cn, be):
    """The half snapshot: `cn` where `snap_cn` (a bool, or a (rows, 1)
    mask for packed rows), else `be`."""
    if isinstance(snap_cn, bool):
        return cn if snap_cn else be
    return torch.where(snap_cn, cn, be)


def _bdf2_block(kbe, kcn, kbdf, first, masks, x0, x1, carries, etails,
                htails, zt, K: int, snap_cn, npass_be: int, npass_cn: int,
                npass_bdf: int):
    """K whole BDF2 steps on one (rows, blk) block. `carries` (4K slots,
    column 4k+p for step k phase p), `etails` and `htails` (K each) enter
    as the previous block left them and are updated in place. Returns
    (ends0, ends1, half0, half1, prev0, prev1), prev being the last step's
    input."""
    for k in range(K):
        et, ht = etails[k], htails[k]
        c = 4 * k
        # Phase 0: BE(dt/2) predictor.
        b0, b1, carries[c] = _substep_block(
            BE, kbe, first, masks, x0, x1, x0, x1, x0, x1, carries[c], zt,
            zt, npass_be)
        # Phase 1: CN(dt/2) corrector -> half snapshot: the CN output for
        # mu<0, the phase-0 BE output for mu>0 (reference quirk,
        # solver.cpp:733 vs 784-787).
        hc0, hc1, carries[c + 1] = _substep_block(
            CN, kcn, first, masks, b0, b1, x0, x1, x0, x1, carries[c + 1],
            et, zt, npass_cn)
        hs0, hs1 = _pick(snap_cn, hc0, b0), _pick(snap_cn, hc1, b1)
        # Phase 2: second BE(dt/2) predictor.
        d0, d1, carries[c + 2] = _substep_block(
            BE, kbe, first, masks, hc0, hc1, x0, x1, hs0, hs1,
            carries[c + 2], zt, zt, npass_be)
        # Phase 3: BDF2 corrector (prev = step input ends).
        f0, f1, carries[c + 3] = _substep_block(
            BDF, kbdf, first, masks, d0, d1, x0, x1, hs0, hs1,
            carries[c + 3], et, ht, npass_bdf)
        etails[k], htails[k] = x1[:, -1:], hs1[:, -1:]
        p0, p1 = x0, x1
        x0, x1 = f0, f1
    return x0, x1, hs0, hs1, p0, p1


def _multistep_block(kind, kc, first, masks, x0, x1, carries, etails, zt,
                     K: int, npass: int):
    """K whole BE or CN steps on one block, carries and tails updated in
    place. Returns (ends0, ends1, prev0, prev1)."""
    for k in range(K):
        f0, f1, carries[k] = _substep_block(
            kind, kc, first, masks, x0, x1, x0, x1, x0, x1, carries[k],
            etails[k], zt, npass)
        etails[k] = x1[:, -1:]
        p0, p1 = x0, x1
        x0, x1 = f0, f1
    return x0, x1, p0, p1


def bdf2_launch_ref(cbe, ccn, cbdf, bc, flip, e0, e1, *, K: int,
                    s_be: float, s_cn: float, s_bdf: float,
                    reflective: bool, symmetric_half: bool, blk: int,
                    npass_be: int, npass_cn: int, npass_bdf: int):
    """Plain version of B1 (``_make_bdf2_kernel``): K whole BDF2 4-phase
    steps. Returns (ends0, ends1, half0, half1, prev0, prev1)."""
    nb, masks, first, zt = _block_setup(
        e0, blk, max(npass_be, npass_cn, npass_bdf))
    outs = [torch.empty_like(e0) for _ in range(6)]
    s_of = [s for _ in range(K) for s in (s_be, s_cn, s_be, s_bdf)]
    carries = None
    for h in (0, 1):
        carries = _half_inflow(carries, s_of, bc, flip, h, reflective)
        etails, htails = [zt] * K, [zt] * K
        kcs = [_unpack_coef(c[h]) for c in (cbe, ccn, cbdf)]
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            x0, x1, hs0, hs1, p0, p1 = _bdf2_block(
                *kcs, first, masks, e0[h, :, sl], e1[h, :, sl], carries,
                etails, htails, zt, K, symmetric_half or h == 0, npass_be,
                npass_cn, npass_bdf)
            for o, g in zip(outs, (x0, x1, hs0, hs1, p0, p1)):
                o[h, :, sl] = g
    return tuple(outs)


def multistep_launch_ref(kind: int, coef, bc, flip, e0, e1, *, K: int,
                         s: float, reflective: bool, blk: int, npass: int):
    """Plain version of B2 (``_make_multistep_kernel``): K whole BE or CN
    steps; prev = the last step's input. Returns (e0, e1, p0, p1)."""
    if kind not in (BE, CN):
        raise ValueError(f"multistep kernel runs BE or CN, got {kind}")
    nb, masks, first, zt = _block_setup(e0, blk, npass)
    outs = [torch.empty_like(e0) for _ in range(4)]
    carries = None
    for h in (0, 1):
        carries = _half_inflow(carries, [s] * K, bc, flip, h, reflective)
        etails = [zt] * K
        kc = _unpack_coef(coef[h])
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            got = _multistep_block(kind, kc, first, masks, e0[h, :, sl],
                                   e1[h, :, sl], carries, etails, zt, K,
                                   npass)
            for o, g in zip(outs, got):
                o[h, :, sl] = g
    return tuple(outs)


def halo_bdf2_launch_ref(cbe, ccn, cbdf, seeds, reset: int, e0, e1, *,
                         K: int, symmetric_half: bool, blk: int,
                         npass_be: int, npass_cn: int, npass_bdf: int):
    """Plain version of B4 (``_make_halo_bdf2_kernel``): K whole BDF2
    steps over packed (rows, X) planes, mu<0 rows first, both halves in
    each block visit. Coefficients are (rows, NCOEF). The carries and
    upwind tails start at zero at block 0 and restart at block `reset`
    from `seeds` (rows, 4K; column 4k+p is step k phase p, the fill
    multiplier already folded in) with zero tails. The half snapshot
    blends per row (CN output for the mu<0 rows, phase-0 BE for the mu>0
    rows) unless `symmetric_half`. Returns (ends0, ends1, half0, half1,
    prev0, prev1, record), the record (rows, 4K) holding every row's
    carries after the last block."""
    nb, masks, first, zt = _block_setup(
        e0, blk, max(npass_be, npass_cn, npass_bdf))
    rows = e0.shape[0]
    outs = [torch.empty_like(e0) for _ in range(6)]
    kcs = [_unpack_coef(c) for c in (cbe, ccn, cbdf)]
    snap_cn = (True if symmetric_half else
               torch.arange(rows, device=e0.device)[:, None] < rows // 2)
    for i in range(nb):
        if i == 0:
            carries = [zt] * (4 * K)
        if i == reset:
            carries = [seeds[:, c:c + 1] for c in range(4 * K)]
        if i in (0, reset):
            etails, htails = [zt] * K, [zt] * K
        sl = slice(i * blk, (i + 1) * blk)
        got = _bdf2_block(*kcs, first, masks, e0[:, sl], e1[:, sl], carries,
                          etails, htails, zt, K, snap_cn, npass_be,
                          npass_cn, npass_bdf)
        for o, g in zip(outs, got):
            o[:, sl] = g
    return (*outs, torch.cat(carries, dim=1))


def halo_multistep_launch_ref(kind: int, coef, seeds, reset: int, e0, e1, *,
                              K: int, blk: int, npass: int):
    """Plain version of B5 (``_make_halo_multistep_kernel``): K whole BE or
    CN steps over packed (rows, X) planes, seeded as in
    ``halo_bdf2_launch_ref`` from `seeds` (rows, K). Returns (ends0,
    ends1, prev0, prev1, record (rows, K))."""
    if kind not in (BE, CN):
        raise ValueError(f"halo multistep kernel runs BE or CN, got {kind}")
    nb, masks, first, zt = _block_setup(e0, blk, npass)
    outs = [torch.empty_like(e0) for _ in range(4)]
    kc = _unpack_coef(coef)
    for i in range(nb):
        if i == 0:
            carries = [zt] * K
        if i == reset:
            carries = [seeds[:, k:k + 1] for k in range(K)]
        if i in (0, reset):
            etails = [zt] * K
        sl = slice(i * blk, (i + 1) * blk)
        got = _multistep_block(kind, kc, first, masks, e0[:, sl], e1[:, sl],
                               carries, etails, zt, K, npass)
        for o, g in zip(outs, got):
            o[:, sl] = g
    return (*outs, torch.cat(carries, dim=1))


def _substep_planes(kind: int, planes):
    """(e0, e1, p0, p1, h0, h1) from the kind's input planes: BE takes
    (e0, e1), CN (e0, e1, p1), BDF all six; unused slots repeat e."""
    if kind == BDF:
        return tuple(planes)
    if kind == CN:
        e0, e1, p1 = planes
        return e0, e1, e0, p1, e0, e1
    if kind == BE:
        e0, e1 = planes
        return e0, e1, e0, e1, e0, e1
    raise ValueError(f"unknown sub-step kind {kind}")


def substep_launch_ref(kind: int, coef, bc, flip, planes, *, s: float,
                       reflective: bool, blk: int, npass: int):
    """Plain version of B3 (``_make_kernel``): one sub-step. Returns the
    new (e0, e1)."""
    e0, e1, p0, p1, h0, h1 = _substep_planes(kind, planes)
    nb, masks, first, zt = _block_setup(e0, blk, npass)
    o0, o1 = torch.empty_like(e0), torch.empty_like(e0)
    carry = None
    for h in (0, 1):
        carry = _half_inflow(carry, [s], bc, flip, h, reflective)
        ptail = htail = zt
        kc = _unpack_coef(coef[h])
        for i in range(nb):
            sl = slice(i * blk, (i + 1) * blk)
            blocks = [x[h, :, sl] for x in (e0, e1, p0, p1, h0, h1)]
            o0[h, :, sl], o1[h, :, sl], carry[0] = _substep_block(
                kind, kc, first, masks, *blocks, carry[0], ptail, htail,
                npass)
            ptail, htail = blocks[3][:, -1:], blocks[5][:, -1:]
    return o0, o1


def _corrected(z0, z1, corr, j):
    """True planes from zero-inflow planes and a pending inflow correction
    (rows, 4) = (inc, d0, a, ln_a): z0 + d0 a^j inc, z1 + a^{j+1} inc, with
    a^j = exp(j ln_a) on the cell indices `j` (float32)."""
    inc, d0, a, ln_a = (corr[:, k:k + 1] for k in range(4))
    apj = torch.exp(j * ln_a) * inc
    return z0 + d0 * apj, z1 + a * apj


def _sharded_planes(kind: int, planes):
    """The planes of a zero-inflow sub-step of `kind` in kernel order: BE
    (e0, e1), CN (e0, e1, p1), BDF (e0, e1, p0, p1, h0, h1)."""
    n = {BE: 2, CN: 3, BDF: 6}.get(kind)
    if n is None:
        raise ValueError(f"unknown sub-step kind {kind}")
    if len(planes) != n:
        raise ValueError(f"kind {kind} takes {n} planes, got {len(planes)}")
    return tuple(planes)


def sharded_substep_launch_ref(kind: int, coef, corrs, halos, planes, *,
                               blk: int, npass: int):
    """Plain version of B8 (``_make_sharded_packed_kernel``): one sub-step
    of `kind` with zero inflow over packed (rows, N_loc) planes, both
    direction halves side by side. Each input plane pair arrives as
    zero-inflow planes plus a pending correction, (rows, 4) `corrs`: e's
    for BE; e's and p1's for CN; e's, p's and h's for BDF; rebuilt on load.
    The CN/BDF upwind tails of the first block come from the (rows, 1)
    `halos` (p1's; BDF also h1's). Returns the zero-inflow (o0, o1)."""
    planes = _sharded_planes(kind, planes)
    e0r = planes[0]
    nb, masks, first, zt = _block_setup(e0r, blk, npass)
    kc = _unpack_coef(coef)
    o0, o1 = torch.empty_like(e0r), torch.empty_like(e0r)
    carry = zt
    ptail = halos[0] if kind in (CN, BDF) else zt
    htail = halos[1] if kind == BDF else zt
    for i in range(nb):
        sl = slice(i * blk, (i + 1) * blk)
        jloc = torch.arange(i * blk, (i + 1) * blk, dtype=torch.float32,
                            device=e0r.device)[None, :]
        blocks = [x[:, sl] for x in planes]
        e0, e1 = _corrected(blocks[0], blocks[1], corrs[0], jloc)
        if kind == BDF:
            p0, p1 = _corrected(blocks[2], blocks[3], corrs[1], jloc)
            h0, h1 = _corrected(blocks[4], blocks[5], corrs[2], jloc)
        elif kind == CN:
            _, p1 = _corrected(blocks[2], blocks[2], corrs[1], jloc)
            p0, h0, h1 = e0, e0, e1
        else:
            p0, p1, h0, h1 = e0, e1, e0, e1
        o0[:, sl], o1[:, sl], carry = _substep_block(
            kind, kc, first, masks, e0, e1, p0, p1, h0, h1, carry, ptail,
            htail, npass)
        if kind in (CN, BDF):
            ptail = p1[:, -1:]
        if kind == BDF:
            htail = h1[:, -1:]
    return o0, o1


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(name: str, coefs, bc, flip, planes) -> Tuple[int, int]:
    """Validate the kernel's inputs; returns (Bh, N)."""
    e0 = planes[0]
    if e0.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {e0.device}")
    if e0.dim() != 3 or e0.shape[0] != 2:
        raise ValueError(f"{name}: planes must be (2, Bh, N), got "
                         f"{tuple(e0.shape)}")
    _, Bh, N = e0.shape
    for t in planes:
        if (t.device != e0.device or t.dtype != torch.float32
                or t.shape != e0.shape or not t.is_contiguous()):
            raise ValueError(f"{name}: every plane must be a contiguous "
                             f"float32 (2, {Bh}, {N}) tensor on {e0.device}")
    for c in coefs:
        if (c.device != e0.device or c.dtype != torch.float32
                or tuple(c.shape) != (2, Bh, _NCOEF)
                or not c.is_contiguous()):
            raise ValueError(f"{name}: coefficients must be contiguous "
                             f"float32 (2, {Bh}, {_NCOEF}) on {e0.device}")
    if (bc.device != e0.device or bc.dtype != torch.float32
            or tuple(bc.shape) != (2, Bh, 1) or not bc.is_contiguous()):
        raise ValueError(f"{name}: bc must be contiguous float32 "
                         f"(2, {Bh}, 1) on {e0.device}")
    if (flip.device != e0.device or flip.dtype != torch.int32
            or tuple(flip.shape) != (Bh,) or not flip.is_contiguous()):
        raise ValueError(f"{name}: flip must be contiguous int32 ({Bh},) "
                         f"on {e0.device}")
    return Bh, N


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _check_K(name: str, K: int) -> None:
    if not 1 <= K <= MAX_FUSED_STEPS:
        raise ValueError(f"{name}: K={K} outside 1..{MAX_FUSED_STEPS}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# B1's, B2's, B4's and B5's launch shape: at most this many threads a block
# (a tile is 8 cells a thread; 512 keeps the tiles of the one-block walks
# these kernels replaced, so B11 stays bit-equal to B1 and HaloCudaEngine
# to CudaSweepEngine) and blocks a row (a cluster; above 8 a non-portable
# size). The kernel takes fewer blocks a row where the card cannot hold
# every row's cluster at once.
SWEEP_THREADS = 512
SWEEP_MAX_CLUSTER = 16


def sweep_geometry(N: int, K: int, rows: int,
                   slots_per_step: int = 4) -> Tuple[int, int, int]:
    """B1's (slots_per_step = 4) or B2's (1) launch shape for `rows` rows a
    launch (Bh for a reflective boundary, else 2*Bh) of N cells at K
    steps: (threads a block, blocks a row, i.e. the cluster size, tiles a
    row)."""
    out = (ctypes.c_int * 3)()
    _raise_on("sweep_geometry", load_kernels().rt_sweep_geometry(
        N, K, slots_per_step, SWEEP_THREADS, SWEEP_MAX_CLUSTER, rows, out))
    return tuple(out)


def bdf2_launch(cbe, ccn, cbdf, bc, flip, e0, e1, *, K: int, s_be: float,
                s_cn: float, s_bdf: float, reflective: bool,
                symmetric_half: bool, blk: int, npass_be: int,
                npass_cn: int, npass_bdf: int):
    """B1: K whole BDF2 steps in one launch. Returns (ends0, ends1,
    half0, half1, prev0, prev1). `blk`/`npass_*` shape the plain
    version's blocked scan; the kernel scans its own tiles exactly, each
    row's tiles as a wavefront over a cluster of blocks
    (``sweep_geometry``)."""
    if e0.device.type == "cpu":
        return bdf2_launch_ref(
            cbe, ccn, cbdf, bc, flip, e0, e1, K=K, s_be=s_be, s_cn=s_cn,
            s_bdf=s_bdf, reflective=reflective,
            symmetric_half=symmetric_half, blk=blk, npass_be=npass_be,
            npass_cn=npass_cn, npass_bdf=npass_bdf)
    name = "bdf2_launch"
    Bh, N = _check_cuda(name, (cbe, ccn, cbdf), bc, flip, (e0, e1))
    _check_K(name, K)
    lib = load_kernels()
    outs = [torch.empty_like(e0) for _ in range(6)]
    rec = torch.empty((Bh, 4 * K), dtype=torch.float32, device=e0.device)
    with torch.cuda.device(e0.device):
        rc = lib.rt_sweep_bdf2(
            *map(_ptr, (cbe, ccn, cbdf, bc, flip, rec, e0, e1, *outs)),
            Bh, N, K, s_be, s_cn, s_bdf, int(symmetric_half),
            int(reflective), SWEEP_THREADS, SWEEP_MAX_CLUSTER,
            _stream(e0.device))
    _raise_on(name, rc)
    bdf2_launch.launches += 1
    return tuple(outs)


def multistep_launch(kind: int, coef, bc, flip, e0, e1, *, K: int,
                     s: float, reflective: bool, blk: int, npass: int):
    """B2: K whole BE or CN steps in one launch, each row's tiles as a
    wavefront over a cluster of blocks (``sweep_geometry`` with one slot a
    step). Returns (e0, e1, p0, p1)."""
    if e0.device.type == "cpu":
        return multistep_launch_ref(kind, coef, bc, flip, e0, e1, K=K, s=s,
                                    reflective=reflective, blk=blk,
                                    npass=npass)
    name = "multistep_launch"
    if kind not in (BE, CN):
        raise ValueError(f"{name}: runs BE or CN, got kind {kind}")
    Bh, N = _check_cuda(name, (coef,), bc, flip, (e0, e1))
    _check_K(name, K)
    lib = load_kernels()
    outs = [torch.empty_like(e0) for _ in range(4)]
    rec = torch.empty((Bh, K), dtype=torch.float32, device=e0.device)
    with torch.cuda.device(e0.device):
        rc = lib.rt_sweep_multistep(
            kind, *map(_ptr, (coef, bc, flip, rec, e0, e1, *outs)),
            Bh, N, K, s, int(reflective), SWEEP_THREADS, SWEEP_MAX_CLUSTER,
            _stream(e0.device))
    _raise_on(name, rc)
    multistep_launch.launches += 1
    return tuple(outs)


# B3's threads a block at most (a look-back tile is 8 cells a thread; a
# power of two from 32 to 512).
SUBSTEP_THREADS = 64


def substep_geometry(N: int) -> Tuple[int, int]:
    """B3's launch shape for rows of N cells: (threads a block, look-back
    tiles a row); the kernel runs one block a tile."""
    out = (ctypes.c_int * 2)()
    _raise_on("substep_geometry", load_kernels().rt_sweep_substep_geometry(
        N, SUBSTEP_THREADS, out))
    return tuple(out)


def substep_launch(kind: int, coef, bc, flip, planes, *, s: float,
                   reflective: bool, blk: int, npass: int):
    """B3: one sub-step. `planes` is (e0, e1) for BE, (e0, e1, p1) for
    CN, (e0, e1, p0, p1, h0, h1) for BDF. Returns the new (e0, e1). On the
    card one block a tile of ``substep_geometry``, the tiles' carries
    chained by decoupled look-back, both halves in one launch; `blk`/
    `npass` shape the plain version only."""
    if planes[0].device.type == "cpu":
        return substep_launch_ref(kind, coef, bc, flip, planes, s=s,
                                  reflective=reflective, blk=blk,
                                  npass=npass)
    name = "substep_launch"
    e0, e1, p0, p1, h0, h1 = _substep_planes(kind, planes)
    Bh, N = _check_cuda(name, (coef,), bc, flip, tuple(planes))
    lib = load_kernels()
    o0, o1 = torch.empty_like(e0), torch.empty_like(e0)
    # The look-back's status words, a word a (row, tile), and the tile
    # counter: the entry point zeroes them before the launch.
    _, tiles = substep_geometry(N)
    status = torch.empty(2 * Bh * tiles + 1, dtype=torch.int64,
                         device=e0.device)
    with torch.cuda.device(e0.device):
        rc = lib.rt_sweep_substep(
            kind, *map(_ptr, (coef, bc, flip, e0, e1, p0, p1, h0, h1, o0, o1,
                              status)),
            Bh, N, s, int(reflective), SUBSTEP_THREADS, _stream(e0.device))
    _raise_on(name, rc)
    substep_launch.launches += 1
    return o0, o1


# B8's threads a block at most (a tile is 8 cells a thread): small tiles let
# many blocks a SM overlap one tile's scan with another's loads (64 measured
# fastest of 32-512 at the gray rung's shard, chip_smoke.py).
SHARDED_THREADS = 64


def sharded_geometry(N: int) -> Tuple[int, int]:
    """B8's launch shape for rows of N cells: (threads a block, tiles a
    row); the kernel runs one block a tile."""
    out = (ctypes.c_int * 2)()
    load_kernels().rt_sharded_geometry(N, SHARDED_THREADS, out)
    return tuple(out)


def sharded_substep_launch(kind: int, coef, corrs, halos, planes, *,
                           blk: int, npass: int):
    """B8: one zero-inflow sub-step over packed (rows, N_loc) planes with
    the pending corrections applied on load (see
    ``sharded_substep_launch_ref``), one block a tile, the tiles' carries
    chained by decoupled look-back. Returns (o0, o1)."""
    planes = _sharded_planes(kind, planes)
    if planes[0].device.type == "cpu":
        return sharded_substep_launch_ref(kind, coef, corrs, halos, planes,
                                          blk=blk, npass=npass)
    name = "sharded_substep_launch"
    n_corr, n_halo = {BE: (1, 0), CN: (2, 1), BDF: (3, 2)}[kind]
    if len(corrs) != n_corr or len(halos) != n_halo:
        raise ValueError(f"{name}: kind {kind} takes {n_corr} corrections "
                         f"and {n_halo} halo columns")
    rows, N = _check_packed_planes(name, planes)
    for t, cols, what in ([(coef, _NCOEF, "coefficients")]
                          + [(c, 4, "corrections") for c in corrs]
                          + [(h, 1, "halo columns") for h in halos]):
        _check_rows(name, t, planes[0], rows, cols, what)
    lib = load_kernels()
    o0, o1 = torch.empty_like(planes[0]), torch.empty_like(planes[0])
    e0, e1, p0, p1, h0, h1 = _substep_planes(kind, planes)
    pad = list(corrs) + [corrs[0]] * (3 - n_corr)
    hpad = list(halos) + [o0] * (2 - n_halo)    # unread
    # The look-back's status words, a word a tile, and the tile counter:
    # the entry point zeroes them before the launch.
    _, tiles = sharded_geometry(N)
    status = torch.empty(rows * tiles + 1, dtype=torch.int64,
                         device=o0.device)
    with torch.cuda.device(o0.device):
        rc = lib.rt_sharded_substep(
            kind, *map(_ptr, (coef, *pad, *hpad, e0, e1, p0, p1, h0, h1,
                              o0, o1, status)),
            rows, N, SHARDED_THREADS, _stream(o0.device))
    _raise_on(name, rc)
    sharded_substep_launch.launches += 1
    return o0, o1


def _check_packed_planes(name: str, planes) -> Tuple[int, int]:
    """Packed (rows, X) planes on one CUDA device; returns (rows, X)."""
    e0 = planes[0]
    if e0.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {e0.device}")
    if e0.dim() != 2 or e0.shape[0] < 2 or e0.shape[0] % 2:
        raise ValueError(f"{name}: planes must be packed (2*Bh, X), got "
                         f"{tuple(e0.shape)}")
    rows, X = e0.shape
    for t in planes:
        if (t.device != e0.device or t.dtype != torch.float32
                or t.shape != e0.shape or not t.is_contiguous()):
            raise ValueError(f"{name}: every plane must be a contiguous "
                             f"float32 ({rows}, {X}) tensor on {e0.device}")
    return rows, X


def _check_rows(name: str, t, like, rows: int, cols: int, what: str):
    if (t.device != like.device or t.dtype != torch.float32
            or tuple(t.shape) != (rows, cols) or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be contiguous float32 "
                         f"({rows}, {cols}) on {like.device}")


def _check_packed(name: str, coefs, seeds, planes, C: int, reset: int,
                  blk: int) -> Tuple[int, int]:
    """Validate a packed-rows kernel's inputs; returns (rows, X)."""
    rows, X = _check_packed_planes(name, planes)
    for t, cols, what in [(c, _NCOEF, "coefficients") for c in coefs] + [
            (seeds, C, "seeds")]:
        _check_rows(name, t, planes[0], rows, cols, what)
    if not 0 <= reset * blk < X:
        raise ValueError(f"{name}: reset block {reset} x {blk} cells lies "
                         f"outside the {X} cells")
    return rows, X


def halo_bdf2_geometry(X: int, K: int, reset_cell: int,
                       rows: int) -> Tuple[int, int, int, int]:
    """B4's launch shape for `rows` packed rows of X cells at K steps with
    the seeded chains from cell reset_cell: (threads a block, blocks a row,
    i.e. the cluster size, tiles of the seeded chain [reset_cell, X), tiles
    of the halo chain [0, reset_cell) from zero). B1's tiles and caps; one
    cluster a row runs both chains."""
    out = (ctypes.c_int * 4)()
    _raise_on("halo_bdf2_geometry",
              load_kernels().rt_sweep_halo_bdf2_geometry(
                  X, K, reset_cell, SWEEP_THREADS, SWEEP_MAX_CLUSTER, rows,
                  out))
    return tuple(out)


def halo_bdf2_launch(cbe, ccn, cbdf, seeds, reset: int, e0, e1, *, K: int,
                     symmetric_half: bool, blk: int, npass_be: int,
                     npass_cn: int, npass_bdf: int):
    """B4: K whole seeded BDF2 steps over packed (rows, X) planes in one
    launch (see ``halo_bdf2_launch_ref``). The kernel restarts the chains
    at cell reset*blk and scans exactly, each row's two chains one
    wavefront over a cluster of blocks (``halo_bdf2_geometry``). Returns
    (ends0, ends1, half0, half1, prev0, prev1, record)."""
    if e0.device.type == "cpu":
        return halo_bdf2_launch_ref(
            cbe, ccn, cbdf, seeds, reset, e0, e1, K=K,
            symmetric_half=symmetric_half, blk=blk, npass_be=npass_be,
            npass_cn=npass_cn, npass_bdf=npass_bdf)
    name = "halo_bdf2_launch"
    _check_K(name, K)
    rows, X = _check_packed(name, (cbe, ccn, cbdf), seeds, (e0, e1), 4 * K,
                            reset, blk)
    lib = load_kernels()
    outs = [torch.empty_like(e0) for _ in range(6)]
    rec = torch.empty((rows, 4 * K), dtype=torch.float32, device=e0.device)
    with torch.cuda.device(e0.device):
        rc = lib.rt_sweep_halo_bdf2(
            *map(_ptr, (cbe, ccn, cbdf, seeds, rec, e0, e1, *outs)),
            rows, X, K, reset * blk, int(symmetric_half), SWEEP_THREADS,
            SWEEP_MAX_CLUSTER, _stream(e0.device))
    _raise_on(name, rc)
    halo_bdf2_launch.launches += 1
    return (*outs, rec)


def halo_multistep_geometry(X: int, K: int, reset_cell: int,
                            rows: int) -> Tuple[int, int, int, int]:
    """B5's launch shape for `rows` packed rows of X cells at K steps with
    the seeded chains from cell reset_cell: (threads a block, blocks a row,
    i.e. the cluster size, tiles of the seeded chain [reset_cell, X), tiles
    of the halo chain [0, reset_cell) from zero). B2's tiles and caps; one
    cluster a row runs both chains, one slot a step."""
    out = (ctypes.c_int * 4)()
    _raise_on("halo_multistep_geometry",
              load_kernels().rt_sweep_halo_multistep_geometry(
                  X, K, reset_cell, SWEEP_THREADS, SWEEP_MAX_CLUSTER, rows,
                  out))
    return tuple(out)


def halo_multistep_launch(kind: int, coef, seeds, reset: int, e0, e1, *,
                          K: int, blk: int, npass: int):
    """B5: K whole seeded BE or CN steps over packed (rows, X) planes in
    one launch (see ``halo_multistep_launch_ref``). The kernel restarts the
    chains at cell reset*blk and scans exactly, each row's two chains one
    wavefront over a cluster of blocks (``halo_multistep_geometry``).
    Returns (ends0, ends1, prev0, prev1, record)."""
    if e0.device.type == "cpu":
        return halo_multistep_launch_ref(kind, coef, seeds, reset, e0, e1,
                                         K=K, blk=blk, npass=npass)
    name = "halo_multistep_launch"
    if kind not in (BE, CN):
        raise ValueError(f"{name}: runs BE or CN, got kind {kind}")
    _check_K(name, K)
    rows, X = _check_packed(name, (coef,), seeds, (e0, e1), K, reset, blk)
    lib = load_kernels()
    outs = [torch.empty_like(e0) for _ in range(4)]
    rec = torch.empty((rows, K), dtype=torch.float32, device=e0.device)
    with torch.cuda.device(e0.device):
        rc = lib.rt_sweep_halo_multistep(
            kind, *map(_ptr, (coef, seeds, rec, e0, e1, *outs)),
            rows, X, K, reset * blk, SWEEP_THREADS, SWEEP_MAX_CLUSTER,
            _stream(e0.device))
    _raise_on(name, rc)
    halo_multistep_launch.launches += 1
    return (*outs, rec)


def reset_launch_counts() -> None:
    """Zero every wrapper's count of kernel launches."""
    for w in (bdf2_launch, multistep_launch, substep_launch,
              halo_bdf2_launch, halo_multistep_launch,
              sharded_substep_launch):
        w.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

class FlatLayout:
    """State layout shared by the engines: FlatState planes (2, Bh, N)
    float32 on `self.device`, converted to and from the global (M, G, N, 2)
    edge arrays. Needs cfg, tables, device, Mh, G and Bh. A mesh engine's
    planes are its rank's shard: it overrides `_local` (the shard of a
    global plane) and `_gather` (the global plane from every shard),
    parallel/mesh.ShardedLayout."""

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def init_state(self) -> FlatState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        Bg = np.broadcast_to(
            np.asarray(self.tables.B, dtype=np.float64)[None, :],
            (self.Mh, self.G)).reshape(self.Bh).astype(np.float32)
        plane = torch.as_tensor(Bg, device=self.device)[None, :, None]
        plane = self._local(plane.expand(2, self.Bh, self.cfg.N)).contiguous()
        return FlatState(plane, plane, plane, plane, plane, plane)

    def from_ends(self, ends, prev, half) -> FlatState:
        """Global (M, G, N, 2) arrays -> FlatState on the engine's device."""
        def planes(x):
            x = torch.as_tensor(x).to(device=self.device,
                                      dtype=torch.float32)
            return [self._local(p) for p in fs.from_ends(x)]

        (e0, e1), (p0, p1), (h0, h1) = planes(ends), planes(prev), planes(half)
        return FlatState(e0, e1, p0, p1, h0, h1)

    def ends_pair(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        return fs.ends_pair(self._gather(x0), self._gather(x1), self.Mh,
                            self.G)

    def ends(self, st: FlatState) -> torch.Tensor:
        return self.ends_pair(st.e0, st.e1)

    def prev_half_ends(self, st: FlatState):
        return (self.ends_pair(st.p0, st.p1), self.ends_pair(st.h0, st.h1))


class CudaSweepEngine(FlatLayout):
    """The counterpart of PallasEngine: K-step fused sweeps over flat
    (2, Bh, N) float32 planes on `device` (CUDA kernels on a card, their
    plain versions on the CPU)."""

    def __init__(self, cfg: Config, tables, block: Optional[int] = None,
                 scan_tol: float = 1e-10, device="cuda"):
        self.cfg = cfg
        self.tables = tables
        self.scan_tol = scan_tol
        self.device = torch.device(device)
        Mh, G = cfg.M // 2, cfg.G
        self.Mh, self.G = Mh, G
        self.Bh = Mh * G
        self.block = self._select_block(cfg, block)
        self.nblocks = cfg.N // self.block

        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)
        # Accuracy-bounded scan truncation of the plain versions (see
        # _scan_npass), per kind from the largest carry multiplier.
        self.scan_npass = {
            kind: _scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))),
                self.block, scan_tol)
            for kind, kc in self.kcs.items()
        }
        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float32)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros(self.Bh, dtype=np.float32)  # unused
        dev = self.device
        self.bc = torch.as_tensor(
            np.stack([bc_neg, bc_pos])[..., None].astype(np.float32),
            device=dev)                                   # (2, Bh, 1)
        self.flip = torch.as_tensor(
            fs._refl_flip_indices(Mh, G).astype(np.int32), device=dev)
        self.coef = {kind: torch.as_tensor(_pack_coeffs(kc), device=dev)
                     for kind, kc in self.kcs.items()}

    def _select_block(self, cfg: Config, block: Optional[int]) -> int:
        """The JAX engine's block auto-selection (pallas_sweep.py:742-806),
        kept as is: it shapes the plain versions' blocked scan; the CUDA
        kernels tile N their own way. An explicit `block` is pinned."""
        auto_block = block is None
        if auto_block:
            block = 2048
        while cfg.N % block != 0 or (block & (block - 1)):
            block //= 2
            if block == 0:
                raise ValueError(f"N={cfg.N} has no power-of-two block")
        while auto_block and self.Bh * block > (1 << 17) and block > 128:
            block //= 2
        while (auto_block and cfg.ts_method == 3
                and self.Bh * block > (1 << 17) and block > 512):
            block //= 2
        if auto_block:
            target = 1 << 17
            while (self.Bh * block * 2 <= target and block < cfg.N
                   and cfg.N % (block * 2) == 0):
                block *= 2
        # Whole-N fallback for decks with no 128-multiple power-of-two
        # block (N = 100, 50); auto mode only.
        if auto_block and block % 128 != 0 and block != cfg.N:
            block = cfg.N
        return block

    # -- stepping ---------------------------------------------------------------

    def substep(self, kind: int, st: FlatState
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if kind == BDF:
            planes = (st.e0, st.e1, st.p0, st.p1, st.h0, st.h1)
        elif kind == CN:
            planes = (st.e0, st.e1, st.p1)
        else:
            planes = (st.e0, st.e1)
        return substep_launch(
            kind, self.coef[kind], self.bc, self.flip, planes,
            s=self.kcs[kind].s, reflective=self.reflective, blk=self.block,
            npass=self.scan_npass[kind])

    def step(self, st: FlatState) -> FlatState:
        cfg = self.cfg
        if cfg.ts_method == 1:
            ne0, ne1 = self.substep(BE, st)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        if cfg.ts_method == 2:
            st1 = FlatState(st.e0, st.e1, st.e0, st.e1, st.h0, st.h1)
            ne0, ne1 = self.substep(CN, st1)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        # BDF2: the whole 4-phase cycle in one fused kernel launch.
        return self.multi_step(st, 1)

    def max_steps_per_launch(self) -> int:
        """K for the fused multi-step kernel: the JAX engine's choice
        (pallas_sweep.py:1018-1040), kept until it is re-derived on the
        card."""
        p = self.Bh * self.block
        if self.cfg.ts_method in (1, 2):
            return 16 if self.Bh <= 16 else 8
        if p <= (1 << 16):
            return 8
        if p <= (1 << 17):
            return 4
        return 1

    def multi_step(self, st: FlatState, K: int) -> FlatState:
        """K whole timesteps in ONE kernel launch (intermediate steps'
        planes never touch device memory). Same trajectory as K calls of
        step() for BDF2; BE/CN fuse the K sub-steps the same way."""
        if self.cfg.ts_method in (1, 2):
            kind = BE if self.cfg.ts_method == 1 else CN
            ne0, ne1, np0, np1 = multistep_launch(
                kind, self.coef[kind], self.bc, self.flip, st.e0, st.e1,
                K=K, s=self.kcs[kind].s, reflective=self.reflective,
                blk=self.block, npass=self.scan_npass[kind])
            return FlatState(ne0, ne1, np0, np1, st.h0, st.h1)
        ne0, ne1, nh0, nh1, np0, np1 = bdf2_launch(
            self.coef[BE], self.coef[CN], self.coef[BDF], self.bc,
            self.flip, st.e0, st.e1, K=K, s_be=self.kcs[BE].s,
            s_cn=self.kcs[CN].s, s_bdf=self.kcs[BDF].s,
            reflective=self.reflective,
            symmetric_half=self.cfg.bdf2_symmetric_half, blk=self.block,
            npass_be=self.scan_npass[BE], npass_cn=self.scan_npass[CN],
            npass_bdf=self.scan_npass[BDF])
        return FlatState(ne0, ne1, np0, np1, nh0, nh1)

    def solve(self, state: Optional[FlatState] = None,
              num_steps: Optional[int] = None,
              steps_per_launch: Optional[int] = None) -> FlatState:
        """Run n timesteps, K whole steps per kernel launch (default
        max_steps_per_launch(), or as many as remain)."""
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        K = steps_per_launch or min(self.max_steps_per_launch(), max(n, 1))
        K = min(K, MAX_FUSED_STEPS)
        body, tail = divmod(n, K)
        for _ in range(body):
            state = self.multi_step(state, K)
        if tail:
            state = self.multi_step(state, tail)
        return state
