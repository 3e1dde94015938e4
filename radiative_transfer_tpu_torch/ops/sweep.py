"""Vectorised discrete-ordinates sweep sub-steps (BE / CN / BDF), the
general engine's per-half sweep.

Port of radiative_transfer_tpu/ops/sweep.py (reference: src/solver.cpp:
319-404 backwardEuler, 407-490 crankNicolson, 493-587 bdf). Each cell
solves the 2x2 system

    A @ res = r0 + s * carry_in,   A = [[T0,  q], [-q, T0]],  q = w/2

where `carry_in` is the upwind edge carried from the previous cell in
sweep order, giving the affine recurrence

    carry_j = a_j * carry_{j-1} + b_j,
    a = q*w / det,  b = (q*r0[0] + T0*r0[1]) / det,  det = T0^2 + q^2

which ops/scan.py evaluates in log depth over the whole slab.

A mu<0 sweep equals a mu>0 sweep on arrays flipped along N with the two
cell edges swapped and mu -> |mu| (orient_ends / orient_cells), so both
direction halves share this code. `a` lies in (0, 1): the recurrence is
contractive even on the optically thick groups of the LLNL deck.

Shapes: direction-half batches (Mh, G, N[, 2]); bc is (Mh, G). Every
argument is a tensor on one device at one dtype (python floats for dx, ts
and dt_full).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import constants
from .scan import affine_scan, apply_prefix

_C = constants.SPEED_OF_LIGHT

BE, CN, BDF = 1, 2, 3  # sub-step kinds (reference ts_method numbering)


class SweepCoeffs(NamedTuple):
    """Per-(direction, group[, cell]) sweep coefficients."""

    w: torch.Tensor    # (Mh, G, 1) positive transport coupling
    T0: torch.Tensor   # (Mh, G, 1) diagonal of the 2x2 system
    r0: torch.Tensor   # (Mh, G, N, 2) carry-independent RHS


def _shift_in(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """x shifted one cell downwind along N; the first cell takes `fill`
    (Mh, G)."""
    return torch.cat([fill[..., None], x[..., :-1]], dim=-1)


def build_coeffs(
    kind: int,
    e: torch.Tensor,          # (Mh, G, N, 2) current ends (oriented)
    p: torch.Tensor,          # (Mh, G, N, 2) prev_ends (oriented)
    h: torch.Tensor,          # (Mh, G, N, 2) half_ends (oriented)
    S: torch.Tensor,          # (Mh, G, N) Planck + correction source term
    absmu: torch.Tensor,      # (Mh,)
    rhokap: torch.Tensor,     # (G,)
    bc: torch.Tensor,         # (Mh, G) boundary intensity (fills the shifts)
    dx,
    ts,                       # sub-step size (dt for BE/CN; dt/2 in BDF2)
    dt_full,                  # FULL dt: the reference bdf() couples with
                              # c*mu*dt/6 using the full dt (solver.cpp:501)
    prev_fill: Optional[torch.Tensor] = None,
    half_fill: Optional[torch.Tensor] = None,
) -> SweepCoeffs:
    """The sub-step's coefficients. `prev_fill`/`half_fill` (Mh, G) are the
    upwind fills of the shifted prev/half edges: on one device both equal
    bc (the reference initialises its carries to the boundary value,
    solver.cpp:695-697); on an interior shard of a spatial decomposition
    they are the upstream shard's last edges."""
    if prev_fill is None:
        prev_fill = bc
    if half_fill is None:
        half_fill = bc
    am = absmu[:, None, None]           # (Mh, 1, 1)
    rk = rhokap[None, :, None]          # (1, G, 1)

    if kind == BE:
        # solver.cpp:319-404
        w = _C * ts * am
        cA = 1.0 + _C * ts * rk
        T0 = 0.5 * (cA * dx + w)
        r0_0 = S + (0.5 * dx) * e[..., 0]
        r0_1 = S + (0.5 * dx) * e[..., 1]
    elif kind == CN:
        # solver.cpp:407-490
        tv = 0.5 * _C * ts * rk
        w = 0.5 * _C * ts * am
        cB = 1.0 + tv
        cC = 1.0 - tv
        T0 = 0.5 * (cB * dx + w)
        prev_shift = _shift_in(p[..., 1], prev_fill)
        r0_0 = (S + 0.5 * (cC * dx - w) * e[..., 0] - 0.5 * w * e[..., 1]
                + w * prev_shift)
        r0_1 = S + 0.5 * w * e[..., 0] + 0.5 * (cC * dx - w) * e[..., 1]
    elif kind == BDF:
        # solver.cpp:493-587
        tv = _C * rk * ts / 6.0
        w = _C * am * dt_full / 6.0
        cA = 1.0 + tv
        cC = 1.0 - 4.0 * tv
        cD = tv
        T0 = 0.5 * (cA * dx + w)
        half_shift = _shift_in(h[..., 1], half_fill)
        prev_shift = _shift_in(p[..., 1], prev_fill)
        r0_0 = (
            S
            + 0.5 * (cC * dx - 4.0 * w) * h[..., 0]
            - 2.0 * w * h[..., 1]
            - 0.5 * (w + cD * dx) * p[..., 0]
            - 0.5 * w * p[..., 1]
            + w * (4.0 * half_shift + prev_shift)
        )
        r0_1 = (
            S
            + 2.0 * w * h[..., 0]
            + 0.5 * (cC * dx - 4.0 * w) * h[..., 1]
            + 0.5 * w * p[..., 0]
            - 0.5 * (w + cD * dx) * p[..., 1]
        )
    else:
        raise ValueError(f"unknown sub-step kind {kind}")

    return SweepCoeffs(w=w.expand(T0.shape), T0=T0,
                       r0=torch.stack([r0_0, r0_1], dim=-1))


def carry_terms(coeffs: SweepCoeffs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (a, b) arrays of the carry recurrence (both (Mh, G, N))."""
    q = 0.5 * coeffs.w
    det = coeffs.T0 * coeffs.T0 + q * q
    a = (q * coeffs.w / det).expand(coeffs.r0.shape[:-1])
    b = (q * coeffs.r0[..., 0] + coeffs.T0 * coeffs.r0[..., 1]) / det
    return a, b


def reconstruct_ends(coeffs: SweepCoeffs, carry_in: torch.Tensor
                     ) -> torch.Tensor:
    """Solve every cell's 2x2 system given its incoming carry (oriented)."""
    q = 0.5 * coeffs.w
    det = coeffs.T0 * coeffs.T0 + q * q
    u = coeffs.r0[..., 0] + coeffs.w * carry_in
    res0 = (coeffs.T0 * u - q * coeffs.r0[..., 1]) / det
    res1 = (q * u + coeffs.T0 * coeffs.r0[..., 1]) / det
    return torch.stack([res0, res1], dim=-1)


def sweep_oriented(kind: int, e, p, h, S, absmu, rhokap, bc, dx, ts,
                   dt_full) -> torch.Tensor:
    """One sub-step on one direction half in the oriented (sweep-order)
    frame: new oriented ends (Mh, G, N, 2), the reference's sequential
    per-cell loop for this half evaluated in log depth."""
    coeffs = build_coeffs(kind, e, p, h, S, absmu, rhokap, bc, dx, ts,
                          dt_full)
    a, b = carry_terms(coeffs)
    pref_a, pref_b = affine_scan(a, b, axis=-1)
    carry = apply_prefix(pref_a, pref_b, bc)   # inclusive: each out-edge
    carry_in = _shift_in(carry, bc)            # each cell's in-edge
    return reconstruct_ends(coeffs, carry_in)


# ---------------------------------------------------------------------------
# Orientation helpers: map mu<0 sweeps onto the mu>0 code path.
# ---------------------------------------------------------------------------

def orient_ends(x: torch.Tensor) -> torch.Tensor:
    """Flip N and swap the L/R edge axis. Involution."""
    return torch.flip(x, dims=(-2, -1))


def orient_cells(x: torch.Tensor) -> torch.Tensor:
    """Flip N only (for (Mh, G, N) cell-centred arrays). Involution."""
    return torch.flip(x, dims=(-1,))
