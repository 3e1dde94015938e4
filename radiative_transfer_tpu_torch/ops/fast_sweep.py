"""Sweep coefficients, boundary planes and the flat plane layout.

Port of the parts of radiative_transfer_tpu/ops/fast_sweep.py that the
kernel engine borrows (ops/pallas_sweep.py:808-845 there): the
spatially constant per-kind coefficient algebra, the reflective flip,
the boundary inflow planes, and the converters between the global
(M, G, N, 2) edge arrays and the flat sweep-order planes (2, Bh, N).

Flat layout: plane axis 0 is the direction half [mu<0, mu>0], axis 1 the
flattened (Mh, G) batch Bh = Mh*G, axis 2 the N cells in SWEEP order —
the mu<0 half is stored N-reversed with its two edges swapped, so both
halves sweep left to right along the last axis.

Boundary-fill folding (module doc of the JAX original): the first
cell's upwind prev/half history fills enter the recurrence linearly, so
they fold into an inflow multiplier s = 1 (BE), 2 (CN), 6 (BDF2
corrector) on the boundary intensity.

The XLA tiled FastEngine itself (its two-level scan) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants
from ..config.config import Config

_C = constants.SPEED_OF_LIGHT

BE, CN, BDF = 1, 2, 3


class FlatState(NamedTuple):
    """Sweep state; each plane is (2, Bh, N) in sweep order."""

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
