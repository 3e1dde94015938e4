"""The fast engine: tiled layout and constant-coefficient scan, and the
sweep coefficients, boundary planes and flat layout the kernel engines
borrow.

Port of radiative_transfer_tpu/ops/fast_sweep.py. Two layouts live here:

* The flat layout of the kernel engines (ops/pallas_sweep.py:808-845 in
  the JAX package): plane axis 0 is the direction half [mu<0, mu>0],
  axis 1 the flattened (Mh, G) batch Bh = Mh*G, axis 2 the N cells in
  SWEEP order — the mu<0 half is stored N-reversed with its two edges
  swapped, so both halves sweep left to right along the last axis
  (``from_ends``, ``ends_pair``).
* FastEngine's tiled chunk-major layout (chunk, 2, Bh, nc): global cell
  j = i*chunk + t maps to [t, h, :, i], N padded to nc*chunk with pad
  cells at the sweep-downstream end of each half (``_pick_chunk``).

Constant-coefficient recurrence: the per-cell affine carry map
carry_j = a*carry_{j-1} + b_j has a spatially CONSTANT multiplier a
(kappa/rho are per-group vectors), so the scan carries only b and every
prefix power of a is a small cumulative product.

Boundary-fill folding: the first cell's upwind prev/half history fills
(solver.cpp:695-697) enter the recurrence linearly, so they fold into an
inflow multiplier s = 1 (BE), 2 (CN), 6 (BDF2 corrector) on the boundary
intensity; every b is then independent of the boundary value, so both
direction halves (a reflective left boundary included, whose inflow is
the mu<0 half's outflow, solver.cpp:679-683) share one build and scan.

FastEngine's two-level scan: inside a chunk the JAX package runs a
sequential lax.scan over the chunk's positions; eager PyTorch would pay
one round of launches a position, so the port runs a log-step
(Hillis-Steele) prefix over them instead, exact like the sequential one
(every pass composes every pair, the multiplier of pass d is a^d), then
the log-step prefix of the chunk totals (ops/scan.py). The associations
differ from XLA's, so the engine agrees with the JAX package's to
roundoff, not bit for bit. FastEngine is plain PyTorch (the JAX engine is
plain XLA, no Pallas kernel) at float32 or float64 on its device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants
from ..config.config import Config
from .scan import _log_prefix

_C = constants.SPEED_OF_LIGHT

BE, CN, BDF = 1, 2, 3


class FlatState(NamedTuple):
    """Sweep state: each plane is (2, Bh, N) in sweep order for the kernel
    engines, tiled (chunk, 2, Bh, nc) for FastEngine."""

    e0: torch.Tensor  # oriented upwind edge
    e1: torch.Tensor  # oriented downwind edge (the carried one)
    p0: torch.Tensor
    p1: torch.Tensor
    h0: torch.Tensor
    h1: torch.Tensor


class KindCoeffs(NamedTuple):
    """Per-substep-kind spatially-constant coefficients, (1, 2, Bh, 1)."""

    w: np.ndarray
    T0: np.ndarray
    q: np.ndarray
    inv_det: np.ndarray
    a: np.ndarray           # carry multiplier q*w/det
    s: float                # boundary-fill inflow multiplier
    Sbase: np.ndarray       # 0.5*c*ts*dx*rho*kappa*B
    c1: np.ndarray          # correction: S += c1*psi + c0 (pre-scaled)
    c0: np.ndarray
    k_ee: np.ndarray        # BE: 0.5*dx; CN: 0.5*(cC*dx-w); BDF: 0.5*(cC*dx-4w)
    k_p: np.ndarray         # BDF: 0.5*(w + cD*dx)
    ts: float


def _to_plane(x: np.ndarray, Mh: int, G: int) -> np.ndarray:
    """(M, G) -> (2, Mh*G): split direction halves, flatten (Mh, G)."""
    return x.reshape(2, Mh, G).reshape(2, Mh * G)


def _kind_coeff_fields(cfg: Config, kind: int, ts: float, mu, rk,
                       B, cor1, cor2, cor3) -> dict:
    """The coefficient algebra (identical to the reference
    solver.cpp:319-587). ``mu`` is always host numpy (the quadrature is
    never a differentiable parameter); ``rk``/``B``/``cor*`` are float64
    numpy, or float64 torch tensors for the differentiable build
    (build_kind_coeffs_traced), in which case every host constant below
    is lifted to a tensor before it meets them, as the JAX version's
    tracers broadcast numpy. The numpy path is untouched by the lift."""
    traced = isinstance(rk, torch.Tensor)

    def lift(x):
        return torch.as_tensor(x, dtype=torch.float64) if traced else x

    G = cfg.G
    absmu = np.abs(mu)[:, None] * np.ones((1, G))         # (M, G)
    dx = cfg.dx

    if kind == BE:
        w = _C * ts * absmu
        T0 = 0.5 * ((1.0 + _C * ts * rk) * dx + lift(w))
        k_ee = lift(np.full_like(w, 0.5 * dx))
        k_p = lift(np.zeros_like(w))
        s = 1.0
    elif kind == CN:
        tv = 0.5 * _C * ts * rk
        w = 0.5 * _C * ts * absmu
        T0 = 0.5 * ((1.0 + tv) * dx + lift(w))
        k_ee = 0.5 * ((1.0 - tv) * dx - lift(w))
        k_p = lift(np.zeros_like(w))
        s = 2.0
    elif kind == BDF:
        tv = _C * rk * ts / 6.0
        w = _C * absmu * cfg.dt / 6.0   # FULL dt (solver.cpp:501)
        T0 = 0.5 * ((1.0 + tv) * dx + lift(w))
        k_ee = 0.5 * ((1.0 - 4.0 * tv) * dx - 4.0 * lift(w))
        k_p = 0.5 * (lift(w) + tv * dx)
        s = 6.0
    else:
        raise ValueError(f"unknown sub-step kind {kind}")

    w = lift(w)
    q = 0.5 * w
    det = T0 * T0 + q * q
    a = q * w / det

    Sbase = 0.5 * _C * ts * dx * rk * B[None, :]          # (M, G)
    sc = 0.5 * _C * ts * dx
    if cfg.use_correction:
        mb = lift(mu[:, None] * cfg.beta)                  # (M, 1), signed
        c1 = sc * (cor1[None, :] * mb)
        c0 = sc * (cor2[None, :] * mb - cor3[None, :] * mb * mb)
    else:
        c1 = lift(np.zeros((cfg.M, G)))
        c0 = lift(np.zeros((cfg.M, G)))

    return dict(w=w, T0=T0, q=q, inv_det=1.0 / det, a=a, s=s,
                Sbase=Sbase, c1=c1, c0=c0, k_ee=k_ee, k_p=k_p)


def _fields_to_coeffs(fields: dict, ts: float, plane) -> KindCoeffs:
    return KindCoeffs(
        w=plane(fields["w"]), T0=plane(fields["T0"]), q=plane(fields["q"]),
        inv_det=plane(fields["inv_det"]), a=plane(fields["a"]),
        s=float(fields["s"]), Sbase=plane(fields["Sbase"]),
        c1=plane(fields["c1"]), c0=plane(fields["c0"]),
        k_ee=plane(fields["k_ee"]), k_p=plane(fields["k_p"]), ts=float(ts),
    )


def build_kind_coeffs(cfg: Config, tables, kind: int, ts: float,
                      dtype) -> KindCoeffs:
    """Host-side build of the constant coefficient planes for one sub-step
    kind, cast to numpy `dtype`."""
    Mh, G = cfg.M // 2, cfg.G
    mu = np.asarray(tables.mu, dtype=np.float64)          # (M,) ascending
    rhokap = np.asarray(tables.rhokap, dtype=np.float64)  # (G,)
    rk = rhokap[None, :] * np.ones((cfg.M, 1))            # (M, G)
    fields = _kind_coeff_fields(
        cfg, kind, ts, mu, rk,
        np.asarray(tables.B, dtype=np.float64),
        np.asarray(tables.cor1, dtype=np.float64),
        np.asarray(tables.cor2, dtype=np.float64),
        np.asarray(tables.cor3, dtype=np.float64),
    )

    def plane(x):
        return np.asarray(
            _to_plane(np.broadcast_to(np.asarray(x, np.float64),
                                      (cfg.M, G)), Mh, G)[None, :, :, None],
            dtype=np.dtype(dtype),
        )

    return _fields_to_coeffs(fields, ts, plane)


def build_kind_coeffs_traced(cfg: Config, tables, kind: int,
                             ts: float) -> KindCoeffs:
    """Differentiable twin of build_kind_coeffs: the same algebra
    (_kind_coeff_fields), with the per-group leaves of ``tables``
    (adjoint.traced_tables) as float64 tensors that autograd follows, so
    the returned (1, 2, Bh, 1) float64 planes carry the parameter
    dependence into the step."""
    Mh, G = cfg.M // 2, cfg.G
    mu = np.asarray(tables.mu, dtype=np.float64)

    def leaf(x):
        return torch.as_tensor(x, dtype=torch.float64)

    rk = leaf(tables.rhokap)[None, :] * torch.ones((cfg.M, 1),
                                                   dtype=torch.float64)
    fields = _kind_coeff_fields(cfg, kind, ts, mu, rk, leaf(tables.B),
                                leaf(tables.cor1), leaf(tables.cor2),
                                leaf(tables.cor3))

    def plane(x):
        x = torch.broadcast_to(leaf(x), (cfg.M, G))
        return _to_plane(x, Mh, G)[None, :, :, None]

    return _fields_to_coeffs(fields, ts, plane)


def kind_coeffs(cfg: Config, tables, dtype) -> dict:
    """{kind: KindCoeffs} for the sub-step kinds cfg.ts_method runs: BE or
    CN at dt, or BE/CN/BDF at dt/2 for the BDF2 cycle."""
    if cfg.ts_method == 1:
        return {BE: build_kind_coeffs(cfg, tables, BE, cfg.dt, dtype)}
    if cfg.ts_method == 2:
        return {CN: build_kind_coeffs(cfg, tables, CN, cfg.dt, dtype)}
    if cfg.ts_method == 3:
        half = cfg.dt / 2.0
        return {kind: build_kind_coeffs(cfg, tables, kind, half, dtype)
                for kind in (BE, CN, BDF)}
    raise ValueError(f"unknown ts_method {cfg.ts_method}")


def _refl_flip_indices(Mh: int, G: int) -> np.ndarray:
    """Flat gather for the reflective left boundary: positive-half
    direction i takes the mu<0 outflow of direction Mh-1-i, same group
    (m_neg = M/2-1-(i-M/2), solver.cpp:679-683)."""
    idx = np.arange(Mh * G).reshape(Mh, G)
    return idx[::-1].reshape(-1)


def boundary_planes(cfg: Config, tables, dtype
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(bc_neg, bc_pos_fixed): (Bh,) boundary intensities of the mu<0
    (right) and mu>0 (left) halves; bc_pos_fixed is None for a
    reflective left boundary."""
    Mh, G = cfg.M // 2, cfg.G
    psi_source = np.asarray(tables.psi_source, dtype=np.float64)
    bc_neg = np.asarray(
        _to_plane(psi_source, Mh, G)[0]
        if cfg.bc_right_indicator == 1
        else np.zeros(Mh * G),
        dtype=np.dtype(dtype),
    )
    if cfg.bc_left_indicator == 2:
        return bc_neg, None
    # vacuum(0) falls through to source in the reference (missing break,
    # solver.cpp:667-671) — replicated; source(1) ditto.
    return bc_neg, np.asarray(_to_plane(psi_source, Mh, G)[1],
                              dtype=np.dtype(dtype))


# ---------------------------------------------------------------------------
# Flat (2, Bh, N) layout <-> global (M, G, N, 2) edges
# ---------------------------------------------------------------------------

def from_ends(ends: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (M, G, N, 2) edges -> the (e0, e1) flat plane pair."""
    M, G, N, _ = ends.shape
    Mh = M // 2
    neg = ends[:Mh].reshape(Mh * G, N, 2)
    pos = ends[Mh:].reshape(Mh * G, N, 2)
    n0 = torch.flip(neg[..., 1], dims=(-1,))   # oriented: N-reversed,
    n1 = torch.flip(neg[..., 0], dims=(-1,))   # edges swapped
    return (torch.stack([n0, pos[..., 0]], dim=0).contiguous(),
            torch.stack([n1, pos[..., 1]], dim=0).contiguous())


def ends_pair(x0: torch.Tensor, x1: torch.Tensor, Mh: int,
              G: int) -> torch.Tensor:
    """Flat (2, Bh, N) edge planes -> global (M, G, N, 2)."""
    N = x0.shape[-1]
    neg0 = torch.flip(x1[0], dims=(-1,)).reshape(Mh, G, N)
    neg1 = torch.flip(x0[0], dims=(-1,)).reshape(Mh, G, N)
    pos0 = x0[1].reshape(Mh, G, N)
    pos1 = x1[1].reshape(Mh, G, N)
    neg = torch.stack([neg0, neg1], dim=-1)
    pos = torch.stack([pos0, pos1], dim=-1)
    return torch.cat([neg, pos], dim=0)


# ---------------------------------------------------------------------------
# FastEngine: the tiled (chunk, 2, Bh, nc) layout and its two-level scan
# ---------------------------------------------------------------------------

def _pick_chunk(N: int, chunk: int, pad: bool = True) -> Tuple[int, int]:
    """(chunk, N_pad): in-chunk length and padded cell count (JAX's rule).

    Prefers an exact divisor of N near the requested size (no padding).
    When N has no usable power-of-two divisor (odd or prime N) it PADS to
    the next chunk multiple instead of degrading to chunk = 1, which
    would make the chunk level one scan over all N cells. Pad cells sit
    at the sweep-DOWNSTREAM end of each half, so no real cell's result
    can change; the reflective outflow is read at the last REAL cell
    (FastEngine.inflow). ``pad=False`` pins N_pad == N (any divisor)."""
    if N % chunk == 0 and N // chunk >= 2:
        return chunk, N
    c = 1
    while N % (c * 2) == 0 and c * 2 <= max(16, N // 4):
        c *= 2
    if not pad or c >= min(16, chunk):
        return c, N
    half_pow2 = 1 << max(0, (max(N // 4, 1)).bit_length() - 1)
    c = max(min(16, N), min(chunk, half_pow2))
    n_pad = -(-N // c) * c
    return c, n_pad


def _shift1_tiled(x: torch.Tensor) -> torch.Tensor:
    """Shift one cell downwind along N in tiled layout (zero boundary fill;
    the true boundary contribution is folded into the effective inflow):
    new[t, ..., i] = x[t-1, ..., i] for t > 0; new[0, ..., i] =
    x[-1, ..., i-1]."""
    row0 = torch.cat([torch.zeros_like(x[:1, ..., :1]), x[-1:, ..., :-1]],
                     dim=-1)
    return torch.cat([row0, x[:-1]], dim=0)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class FastEngine:
    """The fused constant-coefficient solver for one (Config, Tables)
    problem in plain PyTorch, at `dtype` (torch.float32 or float64) on
    `device` (the card by default; 'cpu' runs the same operations there).
    Its state is a FlatState of tiled (chunk, 2, Bh, nc) planes."""

    def __init__(self, cfg: Config, tables, dtype=torch.float32,
                 chunk: int = 256, pad: bool = True, device="cuda"):
        from ..models.transport import solve_device

        if dtype not in _NP_DTYPE:
            raise ValueError(f"FastEngine runs torch.float32 or "
                             f"torch.float64, got {dtype}")
        self.cfg = cfg
        self.tables = tables
        self.dtype = dtype
        self.device = solve_device(device)
        self.chunk, self.N_pad = _pick_chunk(cfg.N, chunk, pad)
        self.nc = self.N_pad // self.chunk
        self.pad = self.N_pad - cfg.N
        # Tiled position of the last REAL cell (j = i*chunk + t): a padded
        # reflective run reads its outflow there (inflow()).
        self._t_last = (cfg.N - 1) % self.chunk
        self._i_last = (cfg.N - 1) // self.chunk
        Mh, G = cfg.M // 2, cfg.G
        self.Mh, self.G = Mh, G
        self.Bh = Mh * G

        def put(x):
            return torch.as_tensor(np.array(x), device=self.device)

        np_dtype = _NP_DTYPE[dtype]
        bc_neg, bc_pos = boundary_planes(cfg, tables, np_dtype)
        self.bc_neg = put(bc_neg)
        self.bc_pos_fixed = None if bc_pos is None else put(bc_pos)
        self.refl_flip = (put(_refl_flip_indices(Mh, G))
                          if bc_pos is None else None)
        self.kcs = {
            kind: KindCoeffs(*(put(x) if isinstance(x, np.ndarray) else x
                               for x in kc))
            for kind, kc in kind_coeffs(cfg, tables, np_dtype).items()}

    # -- layout conversion -------------------------------------------------

    def tile(self, flat: torch.Tensor) -> torch.Tensor:
        """(2, Bh, N or N_pad) sweep-order plane -> tiled (chunk, 2, Bh,
        nc). Length-N inputs are zero-padded at the sweep-downstream end
        (pad cells never influence real cells)."""
        if self.pad and flat.shape[-1] == self.cfg.N:
            flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1]
                                                   + (self.pad,))], dim=-1)
        x = flat.reshape(2, self.Bh, self.nc, self.chunk)
        return x.permute(3, 0, 1, 2).contiguous()

    def untile(self, tiled: torch.Tensor) -> torch.Tensor:
        """tiled (chunk, 2, Bh, nc) -> (2, Bh, N_pad) sweep-order plane
        (== N when unpadded; ends_pair drops the pad cells)."""
        return tiled.permute(1, 2, 3, 0).reshape(2, self.Bh, self.N_pad)

    def from_ends(self, ends, prev, half) -> FlatState:
        """Global (M, G, N, 2) arrays (any device, float dtype) -> tiled
        FlatState on the engine's device at its dtype."""
        def planes(x):
            x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
            return [self.tile(p) for p in from_ends(x)]

        (e0, e1), (p0, p1), (h0, h1) = planes(ends), planes(prev), planes(half)
        return FlatState(e0, e1, p0, p1, h0, h1)

    def ends_pair(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """Tiled edge planes -> global (M, G, N, 2). Pad cells (sweep-
        downstream: physically left of cell 0 for mu<0, right of N-1 for
        mu>0) are dropped."""
        N = self.cfg.N
        return ends_pair(self.untile(x0)[..., :N], self.untile(x1)[..., :N],
                         self.Mh, self.G)

    def ends(self, st: FlatState) -> torch.Tensor:
        return self.ends_pair(st.e0, st.e1)

    def prev_half_ends(self, st: FlatState):
        """The global (prev_ends, half_ends), as every engine of the port
        gives them (utils/checkpoint.py, ensemble.py)."""
        return (self.ends_pair(st.p0, st.p1), self.ends_pair(st.h0, st.h1))

    def init_state(self) -> FlatState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        Bg = np.broadcast_to(
            np.asarray(self.tables.B, dtype=np.float64)[None, :],
            (self.Mh, self.G)).reshape(self.Bh)
        Bg = torch.tensor(Bg, dtype=self.dtype, device=self.device)
        plane = Bg[None, None, :, None].expand(
            self.chunk, 2, self.Bh, self.nc).contiguous()
        return FlatState(plane, plane, plane, plane, plane, plane)

    # -- one fused sub-step, in stages --------------------------------------

    def rhs(self, kind: int, st: FlatState, shift1=None, kc=None):
        """Carry-independent RHS planes (r0, r1, b). `shift1` overrides the
        one-cell-downwind shift, `kc` the coefficient planes."""
        if kc is None:
            kc = self.kcs[kind]
        if shift1 is None:
            shift1 = _shift1_tiled
        # Source term (the correction is linear in psi, pre-scaled).
        psi = 0.5 * (st.e0 + st.e1)
        S = kc.Sbase + kc.c1 * psi + kc.c0

        # Boundary fills folded out; module doc.
        if kind == BE:
            r0 = S + kc.k_ee * st.e0
            r1 = S + kc.k_ee * st.e1
        elif kind == CN:
            r0 = S + kc.k_ee * st.e0 - kc.q * st.e1 + kc.w * shift1(st.p1)
            r1 = S + kc.q * st.e0 + kc.k_ee * st.e1
        else:  # BDF
            r0 = (S + kc.k_ee * st.h0 - 2.0 * kc.w * st.h1
                  - kc.k_p * st.p0 - kc.q * st.p1
                  + kc.w * (4.0 * shift1(st.h1) + shift1(st.p1)))
            r1 = (S + 2.0 * kc.w * st.h0 + kc.k_ee * st.h1
                  + kc.q * st.p0 - kc.k_p * st.p1)

        b = (kc.q * r0 + kc.T0 * r1) * kc.inv_det          # (chunk,2,Bh,nc)
        return r0, r1, b

    def local_scan(self, kind: int, b: torch.Tensor, kc=None):
        """Two-level scan over the cells (zero inflow). Returns (pb, pow_t,
        EXa, EXb, a_powN, tot_b): in-chunk prefixes, a-powers a^(t+1),
        exclusive cross-chunk composites, and the total composite map
        (out = a_powN * in + tot_b) of the whole axis."""
        if kc is None:
            kc = self.kcs[kind]
        chunk = b.shape[0]
        # a^(t+1): a small cumulative product, (chunk, 2, Bh, 1).
        pow_t = torch.cumprod(
            kc.a.expand((chunk,) + tuple(kc.a.shape[1:])), dim=0)
        # Level 1: the in-chunk prefix from zero, log-step: pass d adds
        # a^d times the prefix d positions upstream.
        pb, d = b, 1
        while d < chunk:
            pb = torch.cat([pb[:d], pb[d:] + pow_t[d - 1] * pb[:-d]], dim=0)
            d *= 2
        last = pb[-1]                                      # (2, Bh, nc)
        a_chunk = pow_t[-1]                                # (2, Bh, 1)

        # Level 2: log-step cross-chunk composition (exclusive).
        inc_a, inc_b = _log_prefix(a_chunk.expand(last.shape), last)
        tot_b = inc_b[..., -1:]                            # (2, Bh, 1)
        a_powN = inc_a[..., -1:]                           # (2, Bh, 1)
        EXa = torch.cat([torch.ones_like(inc_a[..., :1]), inc_a[..., :-1]],
                        dim=-1)
        EXb = torch.cat([torch.zeros_like(inc_b[..., :1]), inc_b[..., :-1]],
                        dim=-1)
        return pb, pow_t, EXa, EXb, a_powN, tot_b

    def inflow(self, kind: int, a_powN, tot_b, kc=None, bc=None, scan=None):
        """Effective inflow per half, (2, Bh, 1), given the total
        composite. The mu>0 reflective inflow is the mu<0 half's outflow,
        its composite applied to its own inflow (solver.cpp:679-683).
        `bc` overrides the (bc_neg, bc_pos_fixed) value planes (the
        differentiable path passes traced ones); reflective or fixed stays
        the engine's. With padding (N_pad > N) the reflective outflow is
        read at cell N-1 from the scan prefix: `scan` is then local_scan's
        (pb, pow_t, EXa, EXb)."""
        if kc is None:
            kc = self.kcs[kind]
        bc_neg, bc_pos_fixed = ((self.bc_neg, self.bc_pos_fixed)
                                if bc is None else bc)
        init_neg = kc.s * bc_neg                           # (Bh,)
        if self.bc_pos_fixed is None:
            if self.pad:
                if scan is None:
                    raise ValueError("a padded reflective inflow needs "
                                     "scan=")
                pb, pow_t, EXa, EXb = scan
                t, i = self._t_last, self._i_last
                ex_neg = EXa[0, :, i] * init_neg + EXb[0, :, i]
                out_neg = pow_t[t, 0, :, 0] * ex_neg + pb[t, 0, :, i]
            else:
                out_neg = a_powN[0, :, 0] * init_neg + tot_b[0, :, 0]
            bc_pos = out_neg[self.refl_flip]
        else:
            bc_pos = bc_pos_fixed
        return torch.stack([init_neg, kc.s * bc_pos], dim=0)[..., None]

    def finish(self, kind: int, r0, r1, pb, pow_t, EXa, EXb, incoming,
               kc=None):
        """Both cell edges from the incoming carry (the value entering the
        first cell, (2, Bh, 1))."""
        if kc is None:
            kc = self.kcs[kind]
        EX = EXa * incoming + EXb                          # (2, Bh, nc)
        # Incoming carry for (t, i): a^t * EX_i + pb[t-1, i].
        pow_t_ex = torch.cat([torch.ones_like(pow_t[:1]), pow_t[:-1]], dim=0)
        pb_ex = torch.cat([torch.zeros_like(pb[:1]), pb[:-1]], dim=0)
        carry_in = pow_t_ex * EX[None] + pb_ex             # (chunk,2,Bh,nc)
        # Per-cell 2x2 solve given the incoming carry.
        u = r0 + kc.w * carry_in
        ne0 = (kc.T0 * u - kc.q * r1) * kc.inv_det
        ne1 = (kc.q * u + kc.T0 * r1) * kc.inv_det
        return ne0, ne1

    def substep(self, kind: int, st: FlatState, kc=None,
                bc=None) -> Tuple[torch.Tensor, torch.Tensor]:
        r0, r1, b = self.rhs(kind, st, kc=kc)
        pb, pow_t, EXa, EXb, a_powN, tot_b = self.local_scan(kind, b, kc=kc)
        incoming = self.inflow(kind, a_powN, tot_b, kc=kc, bc=bc,
                               scan=(pb, pow_t, EXa, EXb))
        return self.finish(kind, r0, r1, pb, pow_t, EXa, EXb, incoming,
                           kc=kc)

    # -- full steps -----------------------------------------------------------

    def step(self, st: FlatState, kcs=None, bc=None) -> FlatState:
        """One full timestep. `kcs`/`bc` override the coefficient dict and
        boundary planes (None: the engine's own); the differentiable path
        (adjoint.make_diff_solve_fast) passes traced ones, so parameter
        gradients flow through the same algebra."""
        cfg = self.cfg

        def sub(kind, s):
            return self.substep(kind, s,
                                kc=None if kcs is None else kcs[kind], bc=bc)

        if cfg.ts_method == 1:
            ne0, ne1 = sub(BE, st)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        if cfg.ts_method == 2:
            st1 = FlatState(st.e0, st.e1, st.e0, st.e1, st.h0, st.h1)
            ne0, ne1 = sub(CN, st1)
            return FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        # BDF2 4-phase cycle (solver.cpp:594-598, 620-625, 700-811).
        p0, p1 = st.e0, st.e1                      # commit prev
        s1 = FlatState(st.e0, st.e1, p0, p1, st.h0, st.h1)
        b0, b1 = sub(BE, s1)                       # phase-0 predictor
        s2 = FlatState(b0, b1, p0, p1, st.h0, st.h1)
        e0, e1 = sub(CN, s2)
        # Snapshot half: plane axis 1 is [mu<0, mu>0]; the mu>0 half keeps
        # the phase-0 BE output (reference quirk: the half_ends copy sits
        # only in the mu<0 branch, solver.cpp:733 vs 784-787) unless the
        # corrected symmetric scheme is asked for.
        if cfg.bdf2_symmetric_half:
            h0, h1 = e0, e1
        else:
            h0 = torch.cat([e0[:, :1], b0[:, 1:]], dim=1)
            h1 = torch.cat([e1[:, :1], b1[:, 1:]], dim=1)
        s3 = FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = sub(BE, s3)
        s4 = FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = sub(BDF, s4)
        return FlatState(e0, e1, p0, p1, h0, h1)

    def solve(self, state: Optional[FlatState] = None,
              num_steps: Optional[int] = None) -> FlatState:
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        for _ in range(n):
            state = self.step(state)
        return state


def solve_fast(cfg: Config, tables, state: Optional[FlatState] = None,
               num_steps: Optional[int] = None, dtype=torch.float32,
               chunk: int = 256, device="cuda"
               ) -> Tuple[FastEngine, FlatState]:
    eng = FastEngine(cfg, tables, dtype=dtype, chunk=chunk, device=device)
    return eng, eng.solve(state, num_steps)
