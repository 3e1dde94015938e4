"""The benchmark's plain reference: a 1-D slab S_N thermal radiative-transfer
solve in plain PyTorch, float64 by default, with no kernel and nothing taken
from the program under test.

It is a frozen copy of the port's general engine (its `models/transport`,
`ops/sweep`, `ops/scan`, `ops/correction`, `ops/planck`, `ops/groups`,
`ops/quadrature` and `constants`), cut to what a benchmark deck uses and
kept here so that a later change to the program cannot move the yardstick.
It works every table out again from the deck (quadrature, group grid,
Planck group integrals, correction terms) and steps the global (M, G, N, 2)
edge array, the upstream miniapp's `src/solver.cpp` loop evaluated in log
depth.

A deck is a plain dict of the port's Config fields, as in
`rtbench/configs/*.json` under "deck".

Every entry point takes a `dtype`: float64 is the reference; a lower one is
the control that the output check has to refuse.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# -- constants (upstream include/Constants.h) ---------------------------------

PLANCK_CONSTANT = 4.141895e-10          # keV-sh
BOLTZMANN_CONSTANT_JPK = 1.601558e-25   # jk/keV
SPEED_OF_LIGHT = 299.79245800           # cm/sh
PI = 3.1415926546
FOUR_PI = 4.0 * PI
RADIATION_CONSTANT_A = 1.3653104e-2
RADIATION_CONSTANT_A_LONG = (8.0 * PI**5) / (
    15.0 * PLANCK_CONSTANT**3 * SPEED_OF_LIGHT**3)
AC = RADIATION_CONSTANT_A * SPEED_OF_LIGHT
_EPS = np.finfo(np.float64).eps

BE, CN, BDF = 1, 2, 3

# -- tables (host float64) ----------------------------------------------------


class Tables(NamedTuple):
    mu: np.ndarray          # (M,) ascending, negative first
    wt: np.ndarray          # (M,) sum 4 pi
    rhokap: np.ndarray      # (G,)
    B: np.ndarray           # (G,) Planck group integrals
    cor1: np.ndarray        # (G,)
    cor2: np.ndarray        # (G,)
    cor3: np.ndarray        # (G,)
    psi_source: np.ndarray  # (M, G)


def gauss_legendre(n: int, norm: float = FOUR_PI):
    mu, w = np.polynomial.legendre.leggauss(n)
    return mu.astype(np.float64), (w * (norm / 2.0)).astype(np.float64)


_QPTS, _QWTS = gauss_legendre(12, norm=2.0)


def _planck_B(T, E):
    E = np.asarray(E, dtype=np.float64)
    return 2.0 * E**3 / (PLANCK_CONSTANT**3 * SPEED_OF_LIGHT**2) / (
        np.exp(E / T) - 1.0)


def _series_B(z1, z2, accuracy):
    N = 32
    norm = max(np.exp(-z1) * (z1**3 + 3.0 * z1**2 + 6.0 * z1 + 6.0), _EPS)
    while True:
        n1 = N + 1.0
        val = (np.exp(-n1 * z1) / (1.0 - np.exp(-z1)) * n1**-4.0
               * ((n1 * z1) ** 3 + 3.0 * (n1 * z1) ** 2 + 6.0 * n1 * z1
                  + 6.0) / norm)
        if val <= accuracy:
            break
        N += 1
    ns = np.arange(N, 0, -1, dtype=np.float64)

    def part(z):
        nz = ns * z
        return np.sum(np.exp(-nz) / ns**4 * (nz**3 + 3 * nz**2 + 6 * nz + 6))

    return float(part(z1) - part(z2))


def _integrate_B(T, e_min, e_max):
    """One group's Planck integral, keV units, times 4 pi (upstream
    src/Planck.cpp's three regimes)."""
    z1, z2 = e_min / T, e_max / T
    hc = PLANCK_CONSTANT**3 * SPEED_OF_LIGHT**2

    def gauss(lo, hi):
        mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
        return float(np.sum(half * _QWTS * _planck_B(T, mid + half * _QPTS)))

    if z2 <= 0.7:
        b = gauss(e_min, e_max)
    elif z1 >= 0.5:
        b = 2.0 * T**4 * _series_B(z1, z2, _EPS) / hc
    else:
        b = gauss(e_min, 0.6 * T) + 2.0 * T**4 * _series_B(0.6, z2, _EPS) / hc
    return b * 4.0 * PI


def _pf(E, T):
    E = np.asarray(E, dtype=np.float64)
    return BOLTZMANN_CONSTANT_JPK * E**3 / (
        PLANCK_CONSTANT**3 * SPEED_OF_LIGHT**2 * (np.exp(E / T) - 1.0))


def build_tables(deck: dict, kappa=None) -> Tables:
    """Every table of `deck`, float64 numpy; `kappa` (G,) replaces the
    deck's opacities (the gradient check's perturbed tables)."""
    M, G, T = deck["M"], deck["G"], deck["T"]
    mu, wt = gauss_legendre(M)
    if deck.get("have_group_bounds"):
        e_edge = np.asarray(deck["group_bounds"], dtype=np.float64)
    else:
        e_edge = np.zeros(G + 1)
        e_edge[1] = deck.get("efirst", 0.1)
        if G > 1:
            fac = np.exp((np.log(deck.get("elast", 10.0))
                          - np.log(e_edge[1])) / (G - 1.0))
            for g in range(1, G):
                e_edge[g + 1] = e_edge[g] * fac
    e_ave = 0.5 * (e_edge[:-1] + e_edge[1:])
    de_ave = e_edge[1:] - e_edge[:-1]
    if kappa is None:
        kappa = (np.asarray(deck["group_kappa"], dtype=np.float64)
                 if deck.get("have_group_absorption_opacities")
                 else np.full(G, deck["kappa_grey"], dtype=np.float64))
    kappa = np.asarray(kappa, dtype=np.float64)
    rho = np.full(G, deck["rho"], dtype=np.float64)

    # Planck group integrals, the grey remainder in the last group.
    B_keV = np.zeros(G)
    rest = RADIATION_CONSTANT_A_LONG * SPEED_OF_LIGHT * T**4
    for g in range(G - 1):
        B_keV[g] = _integrate_B(T, e_edge[g], e_edge[g + 1])
        rest -= B_keV[g]
    if rest > 0.0:
        B_keV[G - 1] = rest
    B = BOLTZMANN_CONSTANT_JPK * B_keV

    # Correction terms (upstream src/correction.cpp), with its quirks: the
    # unguarded last-group dsigEdE form overwrites entry 0 when G == 1.
    k_edge = np.zeros(G + 1)
    k_edge[0] = kappa[0]
    for g in range(1, G):
        wl = (e_ave[g] - e_edge[g]) / (e_ave[g] - e_ave[g - 1])
        wr = (e_edge[g] - e_ave[g - 1]) / (e_ave[g] - e_ave[g - 1])
        k_edge[g] = kappa[g - 1] * wl + kappa[g] * wr
    k_edge[G] = kappa[G - 1]
    dEB = np.zeros(G)
    dEB[0] = e_edge[1] * _pf(e_edge[1], T)
    dsig = np.zeros(G)
    dsig[0] = k_edge[1] * e_edge[1] / de_ave[0]
    dkEB = np.zeros(G)
    dkEB[0] = k_edge[1] * e_edge[1] * _pf(e_edge[1], T)
    for g in range(1, G - 1):
        dEB[g] = (e_edge[g + 1] * _pf(e_edge[g + 1], T)
                  - e_edge[g] * _pf(e_edge[g], T))
        dsig[g] = (k_edge[g + 1] * e_edge[g + 1]
                   - k_edge[g] * e_edge[g]) / de_ave[g]
        dkEB[g] = (k_edge[g + 1] * e_edge[g + 1] * _pf(e_edge[g + 1], T)
                   - k_edge[g] * e_edge[g] * _pf(e_edge[g], T))
    if G > 1:
        dEB[G - 1] = -e_edge[G - 1] * _pf(e_edge[G - 1], T)
        dkEB[G - 1] = (-k_edge[G - 1] * e_edge[G - 1]
                       * _pf(e_edge[G - 1], T))
    dsig[G - 1] = -k_edge[G] * e_edge[G] / de_ave[G - 1]
    cor3 = dsig * (4.0 * B - dEB)

    if deck.get("use_mg_equilib"):
        psi_source = B[None, :] + (4.0 * B - dEB)[None, :] * (
            mu[:, None] * deck.get("V", 0.0) / SPEED_OF_LIGHT)
    elif deck.get("psi_source"):
        psi_source = np.asarray(deck["psi_source"], dtype=np.float64)
    else:
        psi_source = np.zeros((M, G))
    return Tables(mu=mu, wt=wt, rhokap=rho * kappa, B=B, cor1=dsig.copy(),
                  cor2=3.0 * rho * kappa * B - dkEB, cor3=cor3,
                  psi_source=psi_source.reshape(M, G))


def dx_of(deck: dict) -> float:
    return deck["X"] / deck["N"]


# -- the sweep ----------------------------------------------------------------


def _shift_in(x, fill):
    return torch.cat([fill[..., None], x[..., :-1]], dim=-1)


def _log_prefix(a, b):
    """Inclusive prefix composition of x -> a x + b along the last axis,
    exact (Hillis-Steele, every pair composed)."""
    n, d = a.shape[-1], 1
    while d < n:
        na = a[..., d:] * a[..., :-d]
        nb = a[..., d:] * b[..., :-d] + b[..., d:]
        a = torch.cat([a[..., :d], na], dim=-1)
        b = torch.cat([b[..., :d], nb], dim=-1)
        d *= 2
    return a, b


def affine_scan(a, b, chunk: int = 256):
    """The prefix, blocked in chunks along a long axis (a prefix inside
    each chunk, a prefix of the chunk totals, one fix-up)."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    if n % chunk or n // chunk < 4:
        return _log_prefix(a, b)
    lead, nc = a.shape[:-1], n // chunk
    pa, pb = _log_prefix(a.reshape(*lead, nc, chunk),
                         b.reshape(*lead, nc, chunk))
    ca, cb = _log_prefix(pa[..., -1], pb[..., -1])
    ex_a = torch.cat([torch.ones_like(ca[..., :1]), ca[..., :-1]], dim=-1)
    ex_b = torch.cat([torch.zeros_like(cb[..., :1]), cb[..., :-1]], dim=-1)
    return ((pa * ex_a[..., None]).reshape(*lead, n),
            (pa * ex_b[..., None] + pb).reshape(*lead, n))


def _sweep_half(kind, e, p, h, S, absmu, rhokap, bc, dx, ts, dt_full):
    """One sub-step of one direction half in sweep order: each cell's 2x2
    system A res = r0 + s carry, A = [[T0, q], [-q, T0]], q = w / 2, the
    carry recurrence carry_j = a_j carry_{j-1} + b_j."""
    am = absmu[:, None, None]
    rk = rhokap[None, :, None]
    C = SPEED_OF_LIGHT
    if kind == BE:
        w = C * ts * am
        T0 = 0.5 * ((1.0 + C * ts * rk) * dx + w)
        r00 = S + (0.5 * dx) * e[..., 0]
        r01 = S + (0.5 * dx) * e[..., 1]
    elif kind == CN:
        tv = 0.5 * C * ts * rk
        w = 0.5 * C * ts * am
        cC = 1.0 - tv
        T0 = 0.5 * ((1.0 + tv) * dx + w)
        r00 = (S + 0.5 * (cC * dx - w) * e[..., 0] - 0.5 * w * e[..., 1]
               + w * _shift_in(p[..., 1], bc))
        r01 = S + 0.5 * w * e[..., 0] + 0.5 * (cC * dx - w) * e[..., 1]
    else:
        tv = C * rk * ts / 6.0
        w = C * am * dt_full / 6.0
        cC, cD = 1.0 - 4.0 * tv, tv
        T0 = 0.5 * ((1.0 + tv) * dx + w)
        r00 = (S + 0.5 * (cC * dx - 4.0 * w) * h[..., 0] - 2.0 * w * h[..., 1]
               - 0.5 * (w + cD * dx) * p[..., 0] - 0.5 * w * p[..., 1]
               + w * (4.0 * _shift_in(h[..., 1], bc)
                      + _shift_in(p[..., 1], bc)))
        r01 = (S + 2.0 * w * h[..., 0] + 0.5 * (cC * dx - 4.0 * w) * h[..., 1]
               + 0.5 * w * p[..., 0] - 0.5 * (w + cD * dx) * p[..., 1])
    w = w.expand(T0.shape)
    q = 0.5 * w
    det = T0 * T0 + q * q
    a = (q * w / det).expand(r00.shape)
    b = (q * r00 + T0 * r01) / det
    pa, pb = affine_scan(a, b)
    carry_in = _shift_in(pa * bc[..., None] + pb, bc)
    u = r00 + w * carry_in
    return torch.stack([(T0 * u - q * r01) / det, (q * u + T0 * r01) / det],
                       dim=-1)


def _orient(x):
    return torch.flip(x, dims=(-2, -1))


class Stepper:
    """The whole-timestep map ends -> (ends, prev, half) of `deck` on
    `device` at `dtype`; BDF2 reads only the incoming ends."""

    def __init__(self, deck: dict, tables: Tables, dtype=torch.float64,
                 device="cpu"):
        if deck["ts_method"] != 3:
            raise ValueError("the reference steps BDF2 decks only")
        self.deck, self.dtype, self.device = deck, dtype, torch.device(device)
        self.M, self.Mh = deck["M"], deck["M"] // 2
        self.dx, self.dt = dx_of(deck), deck["dt"]
        self.symmetric_half = bool(deck.get("bdf2_symmetric_half", False))
        self.use_correction = bool(deck.get("use_correction", False))
        self.beta = deck.get("V", 0.0) / SPEED_OF_LIGHT
        self.t = self.put(tables)

    def put(self, tables: Tables) -> Tables:
        """The tables as tensors on the device at the dtype; a tensor leaf
        (an opacity that autograd follows) keeps its graph."""
        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x, dtype=np.float64))
            return x.to(device=self.device, dtype=self.dtype)

        return Tables(*(put(x) for x in tables))

    def source(self, t: Tables, ends, ts):
        M, G, N = ends.shape[:3]
        S = (0.5 * SPEED_OF_LIGHT * ts * self.dx * t.rhokap * t.B)[
            None, :, None].expand(M, G, N)
        if self.use_correction:
            psi = 0.5 * (ends[..., 0] + ends[..., 1])
            mb = (t.mu * self.beta)[:, None, None]
            tc = ((t.cor1[None, :, None] * psi + t.cor2[None, :, None]) * mb
                  - t.cor3[None, :, None] * mb * mb)
            S = S + 0.5 * SPEED_OF_LIGHT * ts * self.dx * tc
        return S

    def substep(self, t: Tables, kind, ends, prev, half, ts):
        """Negative directions first, so a reflective left boundary reads
        their new incoming edges (upstream solver.cpp:628, 679-683)."""
        Mh, deck = self.Mh, self.deck
        absmu = torch.abs(t.mu)
        S = self.source(t, ends, ts)
        bc_neg = (t.psi_source[:Mh] if deck["bc_right_indicator"] == 1
                  else torch.zeros_like(t.psi_source[:Mh]))
        neg = _orient(_sweep_half(
            kind, _orient(ends[:Mh]), _orient(prev[:Mh]), _orient(half[:Mh]),
            torch.flip(S[:Mh], dims=(-1,)), absmu[:Mh], t.rhokap, bc_neg,
            self.dx, ts, self.dt))
        # Reflective left: the mu<0 half's new left edges, directions
        # reversed; vacuum falls through to the source (upstream quirk).
        bc_pos = (torch.flip(neg[:, :, 0, 0], dims=(0,))
                  if deck["bc_left_indicator"] == 2 else t.psi_source[Mh:])
        pos = _sweep_half(kind, ends[Mh:], prev[Mh:], half[Mh:], S[Mh:],
                          absmu[Mh:], t.rhokap, bc_pos, self.dx, ts, self.dt)
        return torch.cat([neg, pos], dim=0)

    def step(self, ends, t: Tables = None):
        """One BDF2 step (BE, CN, BE, BDF at dt/2); the mu>0 half of the
        half-step snapshot keeps the BE predictor's output unless the deck
        asks for the symmetric one (upstream solver.cpp:733)."""
        t = self.t if t is None else t
        hdt, Mh = 0.5 * self.dt, self.Mh
        prev = ends
        e1 = self.substep(t, BE, ends, prev, ends, hdt)
        e2 = self.substep(t, CN, e1, prev, ends, hdt)
        half = e2 if self.symmetric_half else torch.cat([e2[:Mh], e1[Mh:]])
        e3 = self.substep(t, BE, e2, prev, half, hdt)
        e4 = self.substep(t, BDF, e3, prev, half, hdt)
        return e4, prev, half

    def solve(self, ends, steps: int, t: Tables = None):
        """`steps` BDF2 steps from `ends` (any device and dtype)."""
        ends = ends.to(device=self.device, dtype=self.dtype)
        for _ in range(steps):
            ends = self.step(ends, t)[0]
        return ends


# -- what a solve reports (upstream main.cc's output set) ---------------------


def phi_and_balance(deck: dict, tables: Tables, ends: torch.Tensor):
    """(phi (G, N), balance (G,)) of a final (M, G, N, 2) edge array, in
    float64: phi = sum_m w_m psi, balance = |sinks - sources| / sources
    from the edge currents, absorption and emission (upstream
    solver.cpp:191-284, the mu<0 current at the right boundary taken at
    the left edge of cell N-1, as there)."""
    ends = ends.to(torch.float64)
    Mh, N = deck["M"] // 2, deck["N"]

    def host(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=ends.device)

    wt, mu = host(tables.wt), host(tables.mu)
    psi = 0.5 * (ends[..., 0] + ends[..., 1])
    phi = torch.einsum("m,mgn->gn", wt, psi)
    muw = mu * wt
    j_minus = -torch.einsum("m,mg->g", muw[:Mh], ends[:Mh, :, 0, 0])
    jN_minus = -torch.einsum("m,mg->g", muw[:Mh], ends[:Mh, :, -1, 0])
    j_plus = torch.einsum("m,mg->g", muw[Mh:], ends[Mh:, :, 0, 1])
    jN_plus = torch.einsum("m,mg->g", muw[Mh:], ends[Mh:, :, -1, 1])
    rhokap = host(tables.rhokap)
    dx = dx_of(deck)
    absorption = rhokap * torch.sum(phi, dim=1) * dx
    emission = rhokap * AC * deck["T"] ** 4 * N * dx
    sources = j_plus + jN_minus + emission
    sinks = jN_plus + j_minus + absorption
    return phi, torch.abs(sinks - sources) / sources


def courant_dt(deck: dict, courant: float) -> float:
    """dt at a cell Courant number c dt / dx."""
    return courant * dx_of(deck) / SPEED_OF_LIGHT


def nerr(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got = torch.as_tensor(got, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64).to(got.device)
    return float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))
