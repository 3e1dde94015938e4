"""The thermal radiative-transfer model: tables, layout and diagnostics.

Port of radiative_transfer_tpu/models/transport.py (reference:
src/solver.cpp, include/solver.h):

    Config -> Tables (host numpy, float64) -> engine -> ends (M, G, N, 2)
           -> result_from_ends (torch float64 on the engine's device)

Setup stays host numpy so that the port's tables are bit-equal to the
JAX package's. The general engine (substep, make_step_fn, solve,
run_problem's default) is the readable path at float64 or float32: every
sub-step a batched scan-parallel sweep (ops/sweep.py, ops/scan.py) in
plain PyTorch on the solve's device, the time loop a Python loop over
State -> State. ``State`` carries the global edge arrays.

Time stepping (reference solve(): src/solver.cpp:590-823):
  * ts_method=1: one Backward-Euler sub-step of dt per step;
  * ts_method=2: prev_ends <- ends, then one Crank-Nicolson dt sub-step;
  * ts_method=3 (BDF2): a 4-phase cycle per full step: commit prev_ends,
    BE(dt/2) predictor, CN(dt/2) corrector (snapshot half_ends), second
    BE(dt/2) predictor, BDF2(dt/2) corrector (solver.cpp:594-598,620-625,
    700-811). max_timesteps counts full steps.

Boundary conditions (solver.cpp:639-692):
  * mu<0 (right boundary): 0 vacuum -> 0; 2 reflective -> 0 (the
    reference leaves it unimplemented); 1 source -> psi_source.
  * mu>0 (left boundary): 0 vacuum falls through to the source value in
    the reference (missing break, solver.cpp:667-671), replicated; 1
    source -> psi_source; 2 reflective -> the just-updated incoming edge
    of the mirrored negative direction, ends(m_neg, g, 0, 0) with
    m_neg = M/2-1-(i-M/2). Negative directions therefore sweep first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants
from ..config.config import Config
from ..ops import correction as corr_mod
from ..ops import sweep as sweep_mod
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
# The general engine: sub-steps, steps, solve
# ---------------------------------------------------------------------------

def solve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device where none exists raises
    (nothing falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the general engine: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return device


def device_tables(tables: Tables, dtype=torch.float64,
                  device="cuda") -> Tables:
    """Every leaf as a tensor on `device` at `dtype`, as JAX's
    build_tables(cfg, dtype) casts them. Leaves that are tensors (e.g.
    adjoint.traced_tables') keep their autograd graph."""
    device = solve_device(device)

    def put(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, dtype=np.float64))
        return x.to(device=device, dtype=dtype)

    return Tables(*(put(x) for x in tables))


def _source_term(cfg: Config, tables: Tables, ends: torch.Tensor,
                 ts) -> torch.Tensor:
    """S = 0.5*c*ts*dx*rho*kappa*B_g (+ 0.5*c*ts*dx*total_correction), the
    common Planckian + correction RHS block of every integrator
    (e.g. solver.cpp:337-341)."""
    M, G, N = ends.shape[0], ends.shape[1], ends.shape[2]
    base = 0.5 * _C * ts * cfg.dx * tables.rhokap * tables.B  # (G,)
    S = base[None, :, None].expand(M, G, N)
    if cfg.use_correction:
        psi = psi_from_ends(ends)
        tc = corr_mod.total_correction(psi, tables.mu, tables.cor1,
                                       tables.cor2, tables.cor3, cfg.beta)
        S = S + 0.5 * _C * ts * cfg.dx * tc
    return S


def _boundary_neg(cfg: Config, tables: Tables, Mh: int) -> torch.Tensor:
    """Right-boundary intensities for the mu<0 half (solver.cpp:641-664)."""
    if cfg.bc_right_indicator == 1:
        return tables.psi_source[:Mh]
    # vacuum (0) and "reflective" (2, unimplemented in the reference) -> 0
    return torch.zeros_like(tables.psi_source[:Mh])


def _boundary_pos(cfg: Config, tables: Tables, Mh: int,
                  new_neg_ends: torch.Tensor) -> torch.Tensor:
    """Left-boundary intensities for the mu>0 half (solver.cpp:667-691)."""
    if cfg.bc_left_indicator == 2:
        # reflective: ends(m_neg, g, 0, 0) of the just-swept negative half,
        # with m_neg = M/2-1-(i-M/2), i.e. the direction order reversed.
        return torch.flip(new_neg_ends[:, :, 0, 0], dims=(0,))
    # vacuum (0) FALLS THROUGH to source in the reference (missing break,
    # solver.cpp:667-671); source (1) reads psi_source. Both replicated.
    return tables.psi_source[Mh:]


def substep(kind: int, cfg: Config, tables: Tables, ends: torch.Tensor,
            prev_ends: torch.Tensor, half_ends: torch.Tensor,
            ts: float) -> torch.Tensor:
    """One sub-step over ALL directions; returns new ends (M, G, N, 2).
    `tables` are device tensors (device_tables).

    Negative directions sweep first so a reflective left boundary sees
    their freshly updated incoming edges, matching the reference's
    direction-ordered loop (solver.cpp:628, 679-683).
    """
    Mh = cfg.M // 2
    absmu = torch.abs(tables.mu)
    S = _source_term(cfg, tables, ends, ts)
    o_ends, o_cells = sweep_mod.orient_ends, sweep_mod.orient_cells

    def run_half(sl, oriented: bool, bc):
        e, p, h, s = ends[sl], prev_ends[sl], half_ends[sl], S[sl]
        if oriented:
            e, p, h, s = o_ends(e), o_ends(p), o_ends(h), o_cells(s)
        new = sweep_mod.sweep_oriented(kind, e, p, h, s, absmu[sl],
                                       tables.rhokap, bc, cfg.dx, ts, cfg.dt)
        return o_ends(new) if oriented else new

    neg, pos = slice(0, Mh), slice(Mh, cfg.M)
    new_neg = run_half(neg, True, _boundary_neg(cfg, tables, Mh))
    new_pos = run_half(pos, False, _boundary_pos(cfg, tables, Mh, new_neg))
    return torch.cat([new_neg, new_pos], dim=0)


def _step_from(cfg: Config, sub):
    """The per-full-timestep transition State -> State built on `sub(kind,
    ends, prev_ends, half_ends, ts) -> ends`, one sub-step over all
    directions (substep here, the mesh's in parallel/sharded.py)."""
    if cfg.ts_method in (1, 2):
        kind = sweep_mod.BE if cfg.ts_method == 1 else sweep_mod.CN

        def step(state: State) -> State:
            prev = state.ends  # committed every step (solver.cpp:620-625)
            ends = sub(kind, state.ends, prev, state.half_ends, cfg.dt)
            return State(ends=ends, prev_ends=prev,
                         half_ends=state.half_ends)

    elif cfg.ts_method == 3:
        half_dt = cfg.dt / 2.0
        Mh = cfg.M // 2

        def step(state: State) -> State:
            # Phase 0: commit prev, BE(dt/2) predictor.
            prev = state.ends
            e1 = sub(sweep_mod.BE, state.ends, prev, state.half_ends,
                     half_dt)
            # Phase 1: CN(dt/2) corrector; snapshot half_ends. The
            # reference's snapshot copy executes only in the mu<0 branch
            # of the cell loop (solver.cpp:733; absent at 784-787), so the
            # mu>0 half of the snapshot holds the phase-0 BE output
            # (docs/QUIRKS.md), unless the corrected symmetric snapshot is
            # asked for.
            e2 = sub(sweep_mod.CN, e1, prev, state.half_ends, half_dt)
            if cfg.bdf2_symmetric_half:
                half = e2
            else:
                half = torch.cat([e2[:Mh], e1[Mh:]], dim=0)
            # Phase 2: second BE(dt/2) predictor.
            e3 = sub(sweep_mod.BE, e2, prev, half, half_dt)
            # Phase 3: BDF2 corrector (dt/2 relaxation, full-dt transport).
            e4 = sub(sweep_mod.BDF, e3, prev, half, half_dt)
            return State(ends=e4, prev_ends=prev, half_ends=half)

    else:
        raise ValueError(f"unknown ts_method {cfg.ts_method}")

    return step


def make_step_fn(cfg: Config, tables: Tables, dtype=torch.float64,
                 device="cuda"):
    """The per-full-timestep transition State -> State on `device` at
    `dtype` (the state's planes must be there already); the tables are
    placed there once, here."""
    t = device_tables(tables, dtype, device)

    def sub(kind, ends, prev_ends, half_ends, ts):
        return substep(kind, cfg, t, ends, prev_ends, half_ends, ts)

    return _step_from(cfg, sub)


def solve(cfg: Config, tables: Tables, state: State,
          num_steps: Optional[int] = None, dtype=torch.float64,
          device="cuda") -> State:
    """Run `num_steps` full timesteps (default cfg.max_timesteps) of the
    general engine on `device` at `dtype`, from `state` (any device and
    float dtype; placed there first)."""
    n = cfg.max_timesteps if num_steps is None else num_steps
    device = solve_device(device)
    step = make_step_fn(cfg, tables, dtype, device)
    state = State(*(torch.as_tensor(x).to(device=device, dtype=dtype)
                    for x in state))
    for _ in range(n):
        state = step(state)
    return state


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


def compute_balance(cfg: Config, tables: Tables, ends: torch.Tensor,
                    phi: torch.Tensor) -> torch.Tensor:
    """Per-group |sinks - sources| / sources (solver.cpp:240-284)."""
    return compute_balance_parts(cfg, tables, ends, phi)[2]


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


def run_problem(cfg: Config, dtype=torch.float64,
                num_steps: Optional[int] = None, engine: str = "general",
                device="cuda") -> SolveResult:
    """End to end: setup -> solve -> diagnostics (the main() flow,
    reference: src/main.cc:60-136), on `device`.

    engine='general' (default) runs this module's readable path at `dtype`
    (torch.float64 or torch.float32); engine='fast' the tiled fast engine
    (ops/fast_sweep.FastEngine, plain PyTorch) at `dtype`; engine='df' pins
    the double-float kernels (ops/cuda_df.DFCudaEngine, f64-grade at
    kernel rate);
    engine='auto' routes through the shape-aware float32 engine selection
    (parallel.make_multichip_engine). Diagnostics run in float64."""
    tables, _, ct = build_tables(cfg)
    if cfg.include_validation and not validate_tables(cfg, ct):
        raise ValueError("Invalid Correction Terms")
    device = solve_device(device)
    if engine != "general":
        if engine == "df":
            from ..ops.cuda_df import DFCudaEngine

            eng = DFCudaEngine(cfg, tables, device=device)
        elif engine == "auto":
            from ..parallel import make_multichip_engine

            eng = make_multichip_engine(cfg, tables, None, device=device)
        elif engine == "fast":
            from ..ops.fast_sweep import FastEngine

            eng = FastEngine(cfg, tables, dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown engine {engine!r} "
                             "(general/fast/df/auto)")
        return result_from_ends(cfg, tables,
                                eng.ends(eng.solve(num_steps=num_steps)))
    state = solve(cfg, tables, initial_state(cfg, tables), num_steps,
                  dtype, device)
    return result_from_ends(cfg, tables, state.ends)
