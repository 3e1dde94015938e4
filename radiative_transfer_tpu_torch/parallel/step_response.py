"""Host-side linear-response machinery for the single-exchange fused
BDF2 mesh engine (parallel/fused_exchange_cuda.py).

The port's own copy of radiative_transfer_tpu/parallel/step_response.py
(numpy and scipy only), on the port's KindCoeffs; kept line for line so
that its outflow map M is bit-equal to the JAX package's.

The whole BDF2 4-phase cycle is AFFINE in a handful of per-shard scalars
that cross the shard boundary. Everything else a shard needs is local
state or the known upstream e1 edge (one ppermuted value), so one
zero-inflow launch per step plus a single small exchange reconstructs
the exact solution — versus the per-substep engine's four exchanges
(parallel/sharded_cuda.py).

Unknown vector, per packed row (2*Bh flattened (half, Mh*G)):

    v = (inc_be1, inc_cn, inc_be2, inc_bdf,      four phase inflows
         fill_p1@cn, fill_p1@bdf, fill_h1)       one-cell history fills

The fills are the j=0 upwind values of the shifted planes consumed by
the CN and BDF sub-steps (solver.cpp:359/397/540-542). For interior
shards the p1 fills are the KNOWN upstream e1 edge (their unknown
components are zero) and the h1 fill is the upstream half-snapshot edge
(computed in the same launch upstream — hence unknown). At the global
axis start the reference initialises every sweep carry — inflow and
both history fills — to the same bdry_cond (solver.cpp:695-697), so the
fold sets all seven components from the boundary value (mu<0) or the
flipped per-phase mu<0 outflows (reflective mu>0, solver.cpp:679-683).
One unknown convention for every shard -> one response table.

The responses are computed NUMERICALLY in f64 as full per-cell profiles
(rows, NV, N_loc) by running the cycle's linearised recurrences
directly (scipy.signal.lfilter for the constant-coefficient carry
chain). An earlier closed-form expansion over the exponential basis
{abe^j, j*abe^j, acn^j, abdf^j, delta_j0} (see git history) was exact
but ill-conditioned precisely in the untruncatable regime this engine
targets — with all carry multipliers near 1 the mixture coefficients
carry 1/(a_i - a_j) factors that explode while their contributions
cancel. Direct recurrence evaluation is unconditionally stable; the
profiles are cast to f32 planes that every shard reads (replicated —
they are shard-independent under the unified convention).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from ..ops import fast_sweep as fs

BE, CN, BDF = fs.BE, fs.CN, fs.BDF

NV = 7
V_BE1, V_CN, V_BE2, V_BDF, V_P1CN, V_P1BDF, V_FILLH = range(NV)
# outflow-vector components (the t / chain values)
NT = 5
T_BE1, T_CN, T_BE2, T_BDF, T_H1 = range(NT)


class KindRow(NamedTuple):
    """Per-row f64 constants of one sub-step kind, flattened (2*Bh,)."""

    w: np.ndarray
    T0: np.ndarray
    q: np.ndarray
    idet: np.ndarray
    a: np.ndarray
    kee: np.ndarray
    kp: np.ndarray
    c1: np.ndarray


def kind_rows(kc: fs.KindCoeffs) -> KindRow:
    def flat(x):
        return np.asarray(x, np.float64)[0].reshape(-1)   # (2*Bh,)

    return KindRow(flat(kc.w), flat(kc.T0), flat(kc.q), flat(kc.inv_det),
                   flat(kc.a), flat(kc.k_ee), flat(kc.k_p), flat(kc.c1))


def _carry_chain(a: np.ndarray, b: np.ndarray, inc: np.ndarray
                 ) -> np.ndarray:
    """pref[..., j] = a*pref[..., j-1] + b[..., j], pref[..., -1] = inc.
    a: (rows,); b: (rows, NV, N); inc: (rows, NV). Stable f64 IIR."""
    from scipy.signal import lfilter

    rows, nv, N = b.shape
    out = np.empty_like(b)
    zi = np.empty((1,))
    for r in range(rows):
        ar = np.array([1.0, -a[r]])
        for v in range(nv):
            # lfilter with initial condition: state z0 = a * inc
            out[r, v], _ = lfilter([1.0], ar, b[r, v],
                                   zi=np.array([a[r] * inc[r, v]]))
    return out


def _substep_response(k: KindRow, kind: int, de0, de1, dinc,
                      dp0=None, dp1=None, dh0=None, dh1=None,
                      p1f=None, hf=None):
    """Linear response of one sub-step (fast_sweep.rhs + scan +
    reconstruct algebra, reference solver.cpp:319-587) to input-plane
    responses (rows, NV, N), the inflow response `dinc` (rows, NV), and
    the j=0 history-fill responses p1f/hf (rows, NV). Returns
    (do0, do1)."""
    rows, nv, N = de0.shape
    z2 = np.zeros((rows, nv))
    col = lambda x: x[:, None, None]

    def shifted(dx, fill):
        f = (fill if fill is not None else z2)[:, :, None]
        return np.concatenate([f, dx[:, :, :-1]], axis=2)

    dS = 0.5 * col(k.c1) * (de0 + de1)
    if kind == BE:
        dr0 = dS + col(k.kee) * de0
        dr1 = dS + col(k.kee) * de1
    elif kind == CN:
        dp1s = shifted(dp1, p1f)
        dr0 = dS + col(k.kee) * de0 - col(k.q) * de1 + col(k.w) * dp1s
        dr1 = dS + col(k.q) * de0 + col(k.kee) * de1
    else:
        dp1s = shifted(dp1, p1f)
        dh1s = shifted(dh1, hf)
        dr0 = (dS + col(k.kee) * dh0 - 2.0 * col(k.w) * dh1
               - col(k.kp) * dp0 - col(k.q) * dp1
               + col(k.w) * (4.0 * dh1s + dp1s))
        dr1 = (dS + 2.0 * col(k.w) * dh0 + col(k.kee) * dh1
               + col(k.q) * dp0 - col(k.kp) * dp1)

    db = col(k.idet) * (col(k.q) * dr0 + col(k.T0) * dr1)
    dpref = _carry_chain(k.a, db, dinc)
    dcin = np.concatenate([dinc[:, :, None], dpref[:, :, :-1]], axis=2)
    du = dr0 + col(k.w) * dcin
    do0 = col(k.idet) * (col(k.T0) * du - col(k.q) * dr1)
    return do0, dpref


class CycleResponse(NamedTuple):
    """f64 response profiles of one BDF2 cycle to the NV unknowns.

    R_*: (rows, NV, N_loc) per-cell responses of the output planes;
    M: (rows, NT, NV) outflow map — the shard-chain recurrence is
    t_out = t_zero + M @ v with components (out_be1, out_cn, out_be2,
    out_bdf, h1_edge); R_e1_edge: (rows, NV) = R_e1 at the last cell
    (for the halo'd corrected e1 edge)."""

    R_e0: np.ndarray
    R_e1: np.ndarray
    R_h0: np.ndarray
    R_h1: np.ndarray
    M: np.ndarray


def bdf2_cycle_response(kr: Dict[int, KindRow], Bh: int, N_loc: int,
                        symmetric_half: bool, dtype=np.float64,
                        chunk: int = 1 << 14,
                        profiles: bool = True) -> CycleResponse:
    """Responses of the 4-phase BDF2 cycle (fast_sweep.FastEngine.step
    phase order; reference solver.cpp:594-598, 700-811) to the NV
    unknown boundary scalars, as stable per-cell f64 profiles.

    Computed in STREAMING CHUNKS over the cell axis: the internal f64
    working set is O(rows * NV * chunk) regardless of N_loc (a direct
    whole-axis evaluation allocates ~10 temporaries of rows*NV*N_loc
    f64 — tens of GB at production N). All cross-chunk state is the
    per-phase carry-chain values plus the shifted planes' edge columns.
    `dtype` controls only the STORED profiles (the validation tests
    keep f64). `profiles=False` skips storing them entirely and returns
    None planes — for callers that only need the outflow map M (the
    fused-exchange engine evaluates corrections in-kernel by re-running
    the linear cycle instead of reading stored profiles)."""
    rows = kr[BE].a.shape[0]
    is_neg = (np.arange(rows) < Bh)[:, None, None]

    def sel(qv):
        s = np.zeros((rows, NV))
        s[:, qv] = 1.0
        return s

    z2 = np.zeros((rows, NV))
    if profiles:
        R_e0 = np.empty((rows, NV, N_loc), dtype)
        R_e1 = np.empty((rows, NV, N_loc), dtype)
        R_h0 = np.empty((rows, NV, N_loc), dtype)
        R_h1 = np.empty((rows, NV, N_loc), dtype)
    else:
        R_e0 = R_e1 = R_h0 = R_h1 = None

    # Cross-chunk state: per-phase chain carries (the o1 responses at
    # the previous chunk's last cell) and the shifted planes' previous
    # edge columns. At the global start the chain carries are the
    # inflow unknowns and the fills are the fill unknowns.
    inc = {0: sel(V_BE1), 1: sel(V_CN), 2: sel(V_BE2), 3: sel(V_BDF)}
    p1f_cn, p1f_bdf, hf = sel(V_P1CN), sel(V_P1BDF), sel(V_FILLH)

    for j0 in range(0, N_loc, chunk):
        n = min(chunk, N_loc - j0)
        z = np.zeros((rows, NV, n))
        b0, b1 = _substep_response(kr[BE], BE, z, z, inc[0])
        c0, c1 = _substep_response(kr[CN], CN, b0, b1, inc[1],
                                   dp1=z, p1f=p1f_cn)
        # Half snapshot: CN output for mu<0 rows, phase-0 BE output for
        # mu>0 (reference quirk, solver.cpp:733 vs 784-787).
        if symmetric_half:
            hs0, hs1 = c0, c1
        else:
            hs0 = np.where(is_neg, c0, b0)
            hs1 = np.where(is_neg, c1, b1)
        d0, d1 = _substep_response(kr[BE], BE, c0, c1, inc[2])
        f0, f1 = _substep_response(kr[BDF], BDF, d0, d1, inc[3],
                                   dp0=z, dp1=z, dh0=hs0, dh1=hs1,
                                   p1f=p1f_bdf, hf=hf)
        if profiles:
            sl = slice(j0, j0 + n)
            R_e0[:, :, sl] = f0
            R_e1[:, :, sl] = f1
            R_h0[:, :, sl] = hs0
            R_h1[:, :, sl] = hs1
        inc = {0: b1[:, :, -1], 1: c1[:, :, -1],
               2: d1[:, :, -1], 3: f1[:, :, -1]}
        # The shifted planes are the step-INPUT p1 (zero response) and
        # the half snapshot: their next-chunk fills are the edges.
        p1f_cn = p1f_bdf = z2
        hf = hs1[:, :, -1]

    M = np.stack([inc[0], inc[1], inc[2], inc[3], hf], axis=1)
    return CycleResponse(R_e0, R_e1, R_h0, R_h1, M)
