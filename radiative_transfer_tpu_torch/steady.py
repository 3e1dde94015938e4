"""Direct steady-state solves: the t -> infinity limit in ONE sweep.

Port of radiative_transfer_tpu/steady.py on the port's FastEngine
(ops/fast_sweep.py, plain PyTorch on its device).

The reference reaches steady state only by time-marching (its LLNL slab
needs ~2e4 BDF2 steps through six decades of non-normal growth before
settling, docs/QUIRKS.md #15). But the problem is LINEAR with frozen
material state (T, rho, kappa are per-group constants, reference
solver.cpp:154-157), so the steady state is directly computable.

Why ONE modified BE sub-step is exact: the BE cell update solves
M x = r(x_old, carry) with M = [[T0, q], [-q, T0]], T0 = 0.5*((1 + c dt
rho kappa) dx + w), q = 0.5 w, w = c dt |mu|, r = S + k_ee*x_old +
w*carry (fast_sweep._kind_coeff_fields, reference solver.cpp:319-404).
At a fixed point x_new = x_old the k_ee*x term moves to the left, and
every term of the system is proportional to c*dt; dividing it out leaves
the dt-free system

    T0s = 0.5*(rho kappa dx + |mu|),  qs = 0.5|mu|,  ws = |mu|,
    Ss  = 0.5 dx rho kappa B_g (+ the v/c correction source at the same
                                0.5 dx scale),
    k_ee = k_p = 0,  s = 1,

the steady discrete transport equation mu dpsi/dx + rho kappa psi =
rho kappa B in diamond-difference form. The same elimination applied to
the CN and BDF2 fixed points gives the same system, so it is the common
t -> infinity limit of all three integrators' spatial scheme.

The dt-free coefficients go through the UNCHANGED FastEngine BE sub-step
(its tiled layout, two-level scan and folded boundary inflow, the
reflective coupling of solver.cpp:679-683 included). Without the v/c
correction the system does not depend on the state: one sub-step returns
the steady state. With use_correction the source keeps its pointwise
linear psi term (S += c1*psi, reference correction.cpp:382-399), an
O(beta) contraction that a short fixed-point iteration resolves to
roundoff.

``solve_steady_cycle`` finds instead the exact fixed point of the
configured integrator's full step map (where a BDF2 march settles, which
is not the diamond steady state: docs/QUIRKS.md #16) by matrix-free
restarted GMRES through scipy, one matvec one FastEngine step; each
matvec moves its vector between the host and the engine's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config.config import Config
from .models import transport
from .ops import fast_sweep as fs


def _steady_fields(cfg: Config, mu: np.ndarray, rk, B, cor1, cor2, cor3):
    """The dt-free steady coefficient algebra (module doc), on host float64
    numpy, beside fast_sweep._kind_coeff_fields."""
    G = cfg.G
    absmu = np.abs(mu)[:, None] * np.ones((1, G))          # (M, G)
    dx = cfg.dx

    w = absmu
    T0 = 0.5 * (rk * dx + w)
    q = 0.5 * w
    det = T0 * T0 + q * q
    a = q * w / det

    Sbase = 0.5 * dx * rk * B[None, :]
    sc = 0.5 * dx
    if cfg.use_correction:
        mb = mu[:, None] * cfg.beta
        c1 = sc * (cor1[None, :] * mb)
        c0 = sc * (cor2[None, :] * mb - cor3[None, :] * mb * mb)
    else:
        c1 = np.zeros((cfg.M, G))
        c0 = np.zeros((cfg.M, G))

    return dict(w=w, T0=T0, q=q, inv_det=1.0 / det, a=a, s=1.0,
                Sbase=Sbase, c1=c1, c0=c0,
                k_ee=np.zeros_like(w), k_p=np.zeros_like(w))


def build_steady_coeffs(cfg: Config, tables, dtype=torch.float64
                        ) -> fs.KindCoeffs:
    """The steady coefficient planes, (1, 2, Bh, 1) host numpy at `dtype`
    (a torch dtype), as fast_sweep.build_kind_coeffs builds a kind's."""
    Mh, G = cfg.M // 2, cfg.G
    mu = np.asarray(tables.mu, dtype=np.float64)
    rk = np.asarray(tables.rhokap, dtype=np.float64)[None, :] \
        * np.ones((cfg.M, 1))
    fields = _steady_fields(
        cfg, mu, rk,
        np.asarray(tables.B, dtype=np.float64),
        np.asarray(tables.cor1, dtype=np.float64),
        np.asarray(tables.cor2, dtype=np.float64),
        np.asarray(tables.cor3, dtype=np.float64),
    )
    np_dtype = fs._NP_DTYPE[dtype]

    def plane(x):
        return np.asarray(
            fs._to_plane(np.broadcast_to(np.asarray(x, np.float64),
                                         (cfg.M, G)), Mh, G)[None, :, :, None],
            dtype=np_dtype,
        )

    return fs._fields_to_coeffs(fields, 0.0, plane)


def _on_device(kc: fs.KindCoeffs, eng: fs.FastEngine) -> fs.KindCoeffs:
    """`kc`'s planes as tensors on the engine's device."""
    return fs.KindCoeffs(*(torch.as_tensor(np.array(x), device=eng.device)
                           if isinstance(x, np.ndarray) else x for x in kc))


class SteadyResult(NamedTuple):
    ends: torch.Tensor      # (M, G, N, 2), float64, on the engine's device
    iterations: int         # sweeps (direct) or matvecs (cycle)
    residual: float         # relative update max|delta| / max|e|


def solve_steady(cfg: Config, tables=None, dtype=torch.float64,
                 tol: Optional[float] = None, max_iters: int = 60,
                 chunk: int = 256, device="cuda") -> SteadyResult:
    """The steady-state `ends` array, directly.

    Without use_correction: exactly one sweep (the system does not depend
    on the state). With it: fixed-point iteration on the O(beta) psi-linear
    source, stopping at a relative update below `tol` (default: 50
    machine epsilons of `dtype`)."""
    if tol is None:
        tol = 50.0 * float(torch.finfo(dtype).eps)
    if tables is None:
        tables, _, _ = transport.build_tables(cfg)
    eng = fs.FastEngine(cfg, tables, dtype=dtype, chunk=chunk, device=device)
    kc = _on_device(build_steady_coeffs(cfg, tables, dtype=dtype), eng)
    tiny = torch.finfo(dtype).tiny

    def one(e0, e1):
        st = fs.FlatState(e0, e1, e0, e1, e0, e1)
        n0, n1 = eng.substep(fs.BE, st, kc=kc)
        d = torch.maximum((n0 - e0).abs().max(), (n1 - e1).abs().max())
        m = torch.maximum(n0.abs().max(), n1.abs().max())
        return n0, n1, d / torch.clamp(m, min=tiny)

    st0 = eng.init_state()
    e0, e1, res = one(st0.e0, st0.e1)
    iters = 1
    if cfg.use_correction:
        for _ in range(max_iters - 1):
            if float(res) < tol:
                break
            e0, e1, res = one(e0, e1)
            iters += 1
    ends = eng.ends_pair(e0, e1).to(torch.float64)
    return SteadyResult(ends=ends, iterations=iters, residual=float(res))


def solve_steady_cycle(cfg: Config, tables=None, dtype=torch.float64,
                       tol: Optional[float] = None, restart: int = 40,
                       maxiter: int = 200, chunk: int = 256,
                       device="cuda") -> SteadyResult:
    """The exact fixed point of the MARCHED time-step map, directly.

    solve_steady returns the steady solution of the spatial
    discretization, the exact t -> infinity limit of the BE and CN
    marches. The reference's BDF2 4-phase predictor-corrector is not
    steady-state-consistent with its own spatial scheme: its fixed point
    is biased by terms proportional to the within-cell edge jumps
    (docs/QUIRKS.md #16; replicated here, not corrected).

    One timestep is affine in the (e0, e1) planes, step(x) = L x + c, so
    the fixed point solves (I - L) x = c: matrix-free restarted GMRES
    (scipy), one matvec one FastEngine step, warm-started from the
    one-sweep steady solution. The BDF2 cycle's (e0, e1) determine the
    next state (prev is committed from e at phase 0, the half snapshot is
    rebuilt inside the cycle), so the reduced state is complete for every
    ts_method. `iterations` counts matvecs."""
    import scipy.sparse.linalg as spla

    if tol is None:
        tol = 1e-12 if dtype == torch.float64 else 1e-5
    if tables is None:
        tables, _, _ = transport.build_tables(cfg)
    eng = fs.FastEngine(cfg, tables, dtype=dtype, chunk=chunk, device=device)
    shape = eng.init_state().e0.shape
    sz = int(np.prod(shape))

    def cycle_flat(v: np.ndarray) -> np.ndarray:
        v = torch.as_tensor(v).to(device=eng.device, dtype=dtype)
        e0, e1 = v[:sz].reshape(shape), v[sz:].reshape(shape)
        out = eng.step(fs.FlatState(e0, e1, e0, e1, e0, e1))
        return torch.cat([out.e0.reshape(-1), out.e1.reshape(-1)]).to(
            torch.float64).cpu().numpy()

    c = cycle_flat(np.zeros(2 * sz))
    nmv = [0]

    def matvec(v):
        nmv[0] += 1
        return v - (cycle_flat(v) - c)

    A = spla.LinearOperator((2 * sz, 2 * sz), matvec=matvec,
                            dtype=np.float64)
    # Warm start from the one-sweep steady solution: GMRES then only has
    # to resolve the (usually small) cycle-vs-diamond bias.
    warm = solve_steady(cfg, tables, dtype=dtype, tol=max(tol, 1e-13),
                        chunk=chunk, device=device)
    st0 = eng.from_ends(warm.ends, warm.ends, warm.ends)
    x0 = torch.cat([st0.e0.reshape(-1), st0.e1.reshape(-1)]).to(
        torch.float64).cpu().numpy()
    sol, info = spla.gmres(A, c, x0=x0, rtol=tol, atol=0.0,
                           restart=restart, maxiter=maxiter)
    if info != 0:
        raise RuntimeError(
            f"steady-cycle GMRES did not converge (info={info}, "
            f"{nmv[0]} matvecs); loosen tol or raise maxiter/restart")
    # Residual in the fixed-point metric (not the GMRES one).
    g = cycle_flat(sol)
    res = float(np.max(np.abs(g - sol)) / max(np.max(np.abs(sol)),
                                              np.finfo(np.float64).tiny))
    x = torch.as_tensor(sol).to(device=eng.device, dtype=dtype)
    ends = eng.ends_pair(x[:sz].reshape(shape),
                         x[sz:].reshape(shape)).to(torch.float64)
    return SteadyResult(ends=ends, iterations=nmv[0], residual=res)


def run_steady_problem(cfg: Config, dtype=torch.float64,
                       tol: Optional[float] = None, max_iters: int = 60,
                       method: str = "direct", device="cuda"
                       ) -> Tuple[transport.SolveResult, SteadyResult]:
    """Setup -> steady solve -> the main.cc:105-133 diagnostics (the same
    SolveResult the time-marching paths give, so the CLI's CSV writers
    apply unchanged).

    method='direct' (default): the spatial discretization's steady
    solution (the exact BE/CN march limit); method='cycle': the exact
    fixed point of the configured integrator's step map (where the
    reference's own BDF2 march settles, solve_steady_cycle)."""
    if method not in ("direct", "cycle"):
        raise ValueError(f"unknown steady method {method!r} "
                         "(direct/cycle)")
    tables, _, ct = transport.build_tables(cfg)
    if cfg.include_validation and not transport.validate_tables(cfg, ct):
        raise AssertionError("Invalid Correction Terms")
    if method == "cycle":
        sr = solve_steady_cycle(cfg, tables, dtype=dtype, tol=tol,
                                device=device)
    else:
        sr = solve_steady(cfg, tables, dtype=dtype, tol=tol,
                          max_iters=max_iters, device=device)
    return transport.result_from_ends(cfg, tables, sr.ends), sr
