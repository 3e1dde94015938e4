"""The fused one-step kernel of the single-exchange mesh engine
(parallel/fused_exchange_cuda.py).

* ``fused_step_launch`` — B13, ``_make_fused_step_kernel``
  (radiative_transfer_tpu/parallel/fused_exchange.py:149): one whole BDF2
  step a launch over packed (rows, N_loc) planes. Each row first runs
  the previous step's LINEAR correction cycle from its seven boundary
  unknowns ``v`` (zero sources, zero planes), adds it to the zero-boundary
  planes to materialise the step's true input ends, then runs this step's
  zero-boundary four-phase cycle on them and records the (rows, 6) edge
  record [4 phase carries, half-snapshot edge, input-e1 edge]. With
  ``materialize_only`` it returns the corrected planes and the half-plane
  corrections instead (for ends() and prev_half_ends()).

The wrapper launches csrc/fused.cu for a CUDA tensor and raises if it
cannot (one block a tile, the two cycles' eight sub-steps chained across a
row's tiles by a multi-slot decoupled look-back, csrc/lookback.cuh, in a
status scratch the wrapper allocates); for a CPU tensor it runs the plain version ``fused_step_launch_ref``,
a transcription of the JAX kernel (``_corr_cycle_block`` and the step
body, fused_exchange.py:105-249) on the port's ``_substep_block``: the same
blocks, truncated scans and operation order. It counts its launches in
``fused_step_launch.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_sweep as cs
from ._cuda_build import load as load_kernels
from .fast_sweep import BDF, BE, CN

# The unknowns v of a row and the components of its outflow record
# (parallel/step_response.py).
NV = 7
V_BE1, V_CN, V_BE2, V_BDF, V_P1CN, V_P1BDF, V_FILLH = range(NV)
NREC = 6
# The edge words a tile of B13 publishes: the correction cycle's hs1, the
# corrected input e1 and this step's hs1 at its last cell.
NEDGE = 3

# B13's tile: at most this many threads a block (a power of two from 32 to
# 128, the kernel's launch bounds; 8 cells a thread).
FUSED_THREADS = 128


def _lin(kc: cs._Coef) -> cs._Coef:
    """The coefficients of the linear correction cycle: no sources."""
    z = torch.zeros_like(kc.Sb)
    return kc._replace(Sb=z, c0=z)


def fused_step_launch_ref(cbe, ccn, cbdf, v, z0, z1, *,
                          symmetric_half: bool, blk: int, npass: dict,
                          materialize_only: bool = False):
    """Plain version of B13 (``_make_fused_step_kernel``) over packed
    (rows, N) planes, mu<0 rows first: coefficients (rows, 10), the
    previous step's unknowns `v` (rows, 7), its zero-boundary ends z0, z1.
    Returns (o0, o1, oh0, oh1, record (rows, 6)): this step's zero-boundary
    ends and half snapshot; or with `materialize_only` (e0, e1, hc0, hc1):
    the corrected input ends and the half-plane corrections."""
    nb, masks, first, zt = cs._block_setup(z0, blk, max(npass.values()))
    rows = z0.shape[0]
    kbe, kcn, kbdf = (cs._unpack_coef(c) for c in (cbe, ccn, cbdf))
    lbe, lcn, lbdf = _lin(kbe), _lin(kcn), _lin(kbdf)
    is_neg = torch.arange(rows, device=z0.device)[:, None] < rows // 2
    zero = torch.zeros((rows, blk), dtype=z0.dtype, device=z0.device)
    outs = [torch.empty_like(z0) for _ in range(4)]
    # The correction cycle's carries and fills, seeded from v.
    cb1, ccn_c, cb2, cbd, et_cn, et_bdf, ht = (
        v[:, q:q + 1] for q in (V_BE1, V_CN, V_BE2, V_BDF, V_P1CN, V_P1BDF,
                                V_FILLH))
    # This step's cycle: zero carries and tails.
    mb1 = mcn = mb2 = mbd = etail = htail = zt

    def pick(cn, be):
        return cn if symmetric_half else torch.where(is_neg, cn, be)

    for i in range(nb):
        sl = slice(i * blk, (i + 1) * blk)
        # The previous step's linear correction cycle.
        b0, b1, cb1 = cs._substep_block(
            BE, lbe, first, masks, zero, zero, zero, zero, zero, zero, cb1,
            zt, zt, npass[BE])
        c0, c1, ccn_c = cs._substep_block(
            CN, lcn, first, masks, b0, b1, zero, zero, zero, zero, ccn_c,
            et_cn, zt, npass[CN])
        hs0c, hs1c = pick(c0, b0), pick(c1, b1)
        d0, d1, cb2 = cs._substep_block(
            BE, lbe, first, masks, c0, c1, zero, zero, zero, zero, cb2, zt,
            zt, npass[BE])
        f0c, f1c, cbd = cs._substep_block(
            BDF, lbdf, first, masks, d0, d1, zero, zero, hs0c, hs1c, cbd,
            et_bdf, ht, npass[BDF])
        et_cn = et_bdf = zt
        ht = hs1c[:, -1:]
        e0 = z0[:, sl] + f0c
        e1 = z1[:, sl] + f1c
        if materialize_only:
            for o, g in zip(outs, (e0, e1, hs0c, hs1c)):
                o[:, sl] = g
            continue
        # This step's zero-boundary cycle on the true input ends.
        b0, b1, mb1 = cs._substep_block(
            BE, kbe, first, masks, e0, e1, e0, e1, e0, e1, mb1, zt, zt,
            npass[BE])
        hc0, hc1, mcn = cs._substep_block(
            CN, kcn, first, masks, b0, b1, e0, e1, e0, e1, mcn, etail, zt,
            npass[CN])
        hs0, hs1 = pick(hc0, b0), pick(hc1, b1)
        d0, d1, mb2 = cs._substep_block(
            BE, kbe, first, masks, hc0, hc1, e0, e1, hs0, hs1, mb2, zt, zt,
            npass[BE])
        f0, f1, mbd = cs._substep_block(
            BDF, kbdf, first, masks, d0, d1, e0, e1, hs0, hs1, mbd, etail,
            htail, npass[BDF])
        etail, htail = e1[:, -1:], hs1[:, -1:]
        for o, g in zip(outs, (f0, f1, hs0, hs1)):
            o[:, sl] = g
    if materialize_only:
        return tuple(outs)
    rec = torch.cat([mb1, mcn, mb2, mbd, htail, etail], dim=1)
    return (*outs, rec)


def fused_geometry(N: int) -> Tuple[int, int, int]:
    """B13's launch shape for rows of N cells: (threads a block, tiles a
    row, blocks a multiprocessor holds at once); the kernel runs one block
    a tile. Kept per (N, threads): the wrapper sizes its scratch from it
    at every launch."""
    return _fused_geometry(N, FUSED_THREADS)


@functools.lru_cache(maxsize=None)
def _fused_geometry(N: int, max_threads: int) -> Tuple[int, int, int]:
    out = (ctypes.c_int * 3)()
    cs._raise_on("fused_geometry",
                 load_kernels().rt_fused_geometry(N, max_threads, out))
    return tuple(out)


def fused_step_launch(cbe, ccn, cbdf, v, z0, z1, *, symmetric_half: bool,
                      blk: int, npass: dict, materialize_only: bool = False):
    """B13: one whole BDF2 step (or, with `materialize_only`, the
    corrected planes) in one launch; see ``fused_step_launch_ref``. On the
    card the two cycles' eight sub-steps (four) are the slots of a
    look-back scan over tiles of ``fused_geometry``, one block a tile, the
    one-cell edges between tiles passed in edge words; each tile scans
    exactly. `blk`/`npass` shape the plain version's truncated scans."""
    if z0.device.type == "cpu":
        return fused_step_launch_ref(cbe, ccn, cbdf, v, z0, z1,
                                     symmetric_half=symmetric_half, blk=blk,
                                     npass=npass,
                                     materialize_only=materialize_only)
    name = "fused_step_launch"
    rows, N = cs._check_packed_planes(name, (z0, z1))
    for c in (cbe, ccn, cbdf):
        cs._check_rows(name, c, z0, rows, cs._NCOEF, "coefficients")
    cs._check_rows(name, v, z0, rows, NV, "unknowns v")
    lib = load_kernels()
    outs = [torch.empty_like(z0) for _ in range(4)]
    rec = (outs[0] if materialize_only else
           torch.empty((rows, NREC), dtype=torch.float32, device=z0.device))
    # The look-back's words, one a (slot or edge, row, tile), and the tile
    # counter: the entry point zeroes them before the launch.
    _, tiles, _ = fused_geometry(N)
    slots = 4 if materialize_only else 8
    status = torch.empty((slots + NEDGE) * rows * tiles + 1,
                         dtype=torch.int64, device=z0.device)
    with torch.cuda.device(z0.device):
        rc = lib.rt_fused_step(
            *map(cs._ptr, (cbe, ccn, cbdf, v, z0, z1, *outs, rec, status)),
            rows, N, int(symmetric_half), int(materialize_only),
            FUSED_THREADS, cs._stream(z0.device))
    cs._raise_on(name, rc)
    fused_step_launch.launches += 1
    return tuple(outs) if materialize_only else (*outs, rec)


def reset_launch_counts() -> None:
    fused_step_launch.launches = 0


reset_launch_counts()
