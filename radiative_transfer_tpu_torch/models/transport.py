"""The thermal radiative-transfer model: tables, layout and diagnostics.

Port of radiative_transfer_tpu/models/transport.py, the parts that the
kernel engine's path runs (reference: src/solver.cpp, include/solver.h):

    Config -> Tables (host numpy, float64) -> engine -> ends (M, G, N, 2)
           -> result_from_ends (torch float64 on the engine's device)

Setup stays host numpy so that the port's tables are bit-equal to the
JAX package's. ``State`` and ``initial_state`` carry the global edge
arrays of the differentiable solves (adjoint.py). The general f64 time
stepper (substep, make_step_fn, solve, run_problem) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants
from ..config.config import Config
from ..ops import correction as corr_mod
from ..ops.groups import GroupGrid, build_group_grid
from ..ops.quadrature import gauss_legendre

_C = constants.SPEED_OF_LIGHT


class Tables(NamedTuple):
    """Frozen per-problem constants, host numpy arrays: every leaf is
    tiny ((M,) / (G,) shaped). Only sweep-state planes live on the
    device."""

    mu: np.ndarray            # (M,) ascending, negative first
    wt: np.ndarray            # (M,) sum = 4*pi
    rhokap: np.ndarray        # (G,) rho * kappa
    rho: np.ndarray           # (G,)
    kappa: np.ndarray         # (G,)
    B: np.ndarray             # (G,) Planck integrals (jk/cm^2-sh)
    dEB: np.ndarray           # (G,)
    cor1: np.ndarray          # (G,)
    cor2: np.ndarray          # (G,)
    cor3: np.ndarray          # (G,)
    psi_source: np.ndarray    # (M, G)
    e_edge: np.ndarray        # (G+1,)
    e_ave: np.ndarray         # (G,)
    de_ave: np.ndarray        # (G,)


class State(NamedTuple):
    """Sweep state in the global layout, float64 tensors (or numpy arrays
    handed in by a caller). psi is derived: psi = 0.5*(ends[...,0] +
    ends[...,1])."""

    ends: torch.Tensor       # (M, G, N, 2)
    prev_ends: torch.Tensor  # (M, G, N, 2) level-n edges (BDF2 history)
    half_ends: torch.Tensor  # (M, G, N, 2) level-(n+1/2) edges


def tables_from_numpy(d: dict) -> Tables:
    """Tables from a dict of arrays (e.g. the JAX package's Tables as
    ``{k: np.asarray(v) for k, v in tables._asdict().items()}``), so both
    packages can be fed bit-identical inputs."""
    return Tables(**{f: np.asarray(d[f]) for f in Tables._fields})


def psi_from_ends(ends: torch.Tensor) -> torch.Tensor:
    return 0.5 * (ends[..., 0] + ends[..., 1])


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

def build_tables(cfg: Config
                 ) -> Tuple[Tables, GroupGrid, corr_mod.CorrectionTables]:
    """Host-side precomputation of every T-frozen quantity."""
    mu, wt = gauss_legendre(cfg.M, constants.FOUR_PI)
    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())

    kappa = cfg.group_kappa_array()
    if kappa is None:
        kappa = np.full(cfg.G, cfg.kappa_grey, dtype=np.float64)
    rho = np.full(cfg.G, cfg.rho, dtype=np.float64)

    ct = corr_mod.build_correction_tables(
        cfg.T, rho, kappa, grid.e_edge, grid.e_ave, grid.de_ave, grid.edisc
    )

    if cfg.use_mg_equilib:
        # Equilibrium (comoving Planckian + O(beta) Doppler) boundary
        # sources override the deck's psi_source (solver.cpp:600-604).
        psi_source = corr_mod.equilibrium_psi_source(ct.B, ct.dEB, mu, cfg.V)
    else:
        psi_source = cfg.psi_source_array()

    as_dt = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    tables = Tables(
        mu=as_dt(mu),
        wt=as_dt(wt),
        rhokap=as_dt(rho * kappa),
        rho=as_dt(rho),
        kappa=as_dt(kappa),
        B=as_dt(ct.B),
        dEB=as_dt(ct.dEB),
        cor1=as_dt(ct.cor1),
        cor2=as_dt(ct.cor2),
        cor3=as_dt(ct.cor3),
        psi_source=as_dt(psi_source),
        e_edge=as_dt(grid.e_edge),
        e_ave=as_dt(grid.e_ave),
        de_ave=as_dt(grid.de_ave),
    )
    return tables, grid, ct


def initial_state(cfg: Config, tables: Tables) -> State:
    """psi = ends = B_g everywhere (reference: src/solver.cpp:165-181), as
    float64 CPU tensors; a solve places the state on its own device.
    prev/half start equal to ends (first committed before first read)."""
    B = torch.as_tensor(np.asarray(tables.B), dtype=torch.float64)
    ends = B[None, :, None, None].expand(cfg.M, cfg.G, cfg.N, 2)
    return State(ends=ends, prev_ends=ends, half_ends=ends)


def validate_tables(cfg: Config, tables_host: corr_mod.CorrectionTables) -> bool:
    """Per-step validation of the reference (solver.cpp:609-612) — here the
    tables are step-invariant so one setup-time check is equivalent."""
    kappa = cfg.group_kappa_array()
    if kappa is None:
        kappa = np.full(cfg.G, cfg.kappa_grey)
    ok_p = corr_mod.validate_planck_integrals(tables_host.B, tables_host.dBdT, cfg.T)
    ok_e = corr_mod.validate_emission(kappa, tables_host.B, cfg.T, cfg.kappa_grey)
    return ok_p and ok_e


# ---------------------------------------------------------------------------
# Diagnostics (reference: src/solver.cpp:191-284, 826-850)
# ---------------------------------------------------------------------------

def compute_phi(psi: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """phi(g, n) = sum_m w_m psi(m, g, n) (solver.cpp:191-204)."""
    return torch.einsum("m,mgn->gn", wt, psi)


def compute_phi_plus(psi: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Positive-direction partial integral (solver.cpp:207-221)."""
    Mh = psi.shape[0] // 2
    return torch.einsum("m,mgn->gn", wt[Mh:], psi[Mh:])


def compute_F(psi: torch.Tensor, mu: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """F(g, n) = sum_m mu_m w_m psi(m, g, n) (solver.cpp:224-237)."""
    return torch.einsum("m,mgn->gn", mu * wt, psi)


def _host(x, like: torch.Tensor) -> torch.Tensor:
    """A host table as a float64 tensor on `like`'s device."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=like.device)


def compute_balance_parts(
    cfg: Config, tables: Tables, ends: torch.Tensor, phi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group (sources, sinks, balance) using edge currents, absorption
    and emission (solver.cpp:240-284). Mirrors the reference edge choice:
    the mu<0 current at the right boundary uses the LEFT edge of cell N-1."""
    Mh = cfg.M // 2
    muw = _host(tables.mu, ends) * _host(tables.wt, ends)
    muw_neg, muw_pos = muw[:Mh], muw[Mh:]

    j_half_minus = -torch.einsum("m,mg->g", muw_neg, ends[:Mh, :, 0, 0])
    jN_half_minus = -torch.einsum("m,mg->g", muw_neg, ends[:Mh, :, -1, 0])
    j_half_plus = torch.einsum("m,mg->g", muw_pos, ends[Mh:, :, 0, 1])
    jN_half_plus = torch.einsum("m,mg->g", muw_pos, ends[Mh:, :, -1, 1])

    rhokap = _host(tables.rhokap, ends)
    acT4 = constants.AC * cfg.T**4
    absorption = rhokap * torch.sum(phi, dim=1) * cfg.dx
    emission = rhokap * acT4 * cfg.N * cfg.dx

    sources = j_half_plus + jN_half_minus + emission
    sinks = jN_half_plus + j_half_minus + absorption
    return sources, sinks, torch.abs(sinks - sources) / sources


def compute_group_ends(
    cfg: Config, tables: Tables, ends: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary spectra: summed incoming-edge intensities normalised by
    (group width * c) (solver.cpp:826-850)."""
    Mh = cfg.M // 2
    scale = _host(tables.de_ave, ends) * _C
    left = torch.sum(ends[:Mh, :, 0, 0], dim=0) / scale
    right = torch.sum(ends[Mh:, :, -1, 1], dim=0) / scale
    return left, right


class SolveResult(NamedTuple):
    psi: torch.Tensor        # (M, G, N)
    phi: torch.Tensor        # (G, N)
    phi_plus: torch.Tensor   # (G, N)
    F: torch.Tensor          # (G, N)
    balance: torch.Tensor    # (G,)
    left_ends: torch.Tensor  # (G,)
    right_ends: torch.Tensor # (G,)
    sources: torch.Tensor    # (G,)
    sinks: torch.Tensor      # (G,)


def result_from_ends(cfg: Config, tables: Tables,
                     ends: torch.Tensor) -> SolveResult:
    """Post-processing diagnostics from a final `ends` array (the
    main.cc:105-133 output set). Runs in float64 on `ends`' device."""
    ends = ends.to(torch.float64)
    wt = _host(tables.wt, ends)
    mu = _host(tables.mu, ends)
    psi = psi_from_ends(ends)
    phi = compute_phi(psi, wt)
    left_ends, right_ends = compute_group_ends(cfg, tables, ends)
    sources, sinks, balance = compute_balance_parts(cfg, tables, ends, phi)
    return SolveResult(
        psi=psi, phi=phi,
        phi_plus=compute_phi_plus(psi, wt),
        F=compute_F(psi, mu, wt),
        balance=balance,
        left_ends=left_ends, right_ends=right_ends,
        sources=sources, sinks=sinks,
    )
