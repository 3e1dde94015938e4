"""Differentiable (adjoint) solves: gradients of the transport solution
with respect to physics parameters.

Port of radiative_transfer_tpu/adjoint.py. The kappa/rho-dependent half
of the reference's T-frozen table chain (src/correction.cpp) is rebuilt
here in float64 torch operations, so that autograd follows every derived
table into the sweep coefficients:

* ``kappa`` (G,) — group opacities: rhokap, the group-edge
  interpolation (src/correction.cpp:125-159), dsigEdE / dkapEB (:206-211,
  :241-249, including the G == 1 last-group overwrite quirk,
  docs/QUIRKS.md #7) and cor1/2/3 (:328-340);
* ``rho`` (G,) — material density (rhokap and cor2);
* ``psi_source`` (M, G) — boundary source intensities;
* ``T`` (scalar) — material temperature, to first order around the deck
  value: the Planckian tables (B_g, dEB_g, the edge Planck function) are
  linearised with the reference's own analytic temperature derivatives,
  so gradients at the deck temperature are exact;
* the initial ``State`` — as the solve's input.

The differentiable solve itself is ops/cuda_adjoint.make_diff_solve_cuda,
whose forward and backward run the hand-written CUDA kernels (B9-B10) at
K = 1; ``fit_params`` drives it with ``torch.optim.Adam``. The general
and fast solvers of the JAX package (make_diff_solve,
make_diff_solve_fast) wait for the general engine (ROADMAP A2) and the
XLA fast engine (A7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import constants
from .config.config import Config
from .models.transport import State, Tables
from .ops import correction as corr_mod

_PARAM_KEYS = ("kappa", "rho", "psi_source", "T")

_F64 = torch.float64


def _edge_planck(cfg: Config, e_edge: np.ndarray) -> np.ndarray:
    """pf(e_edge, T) with the unused E=0 edge zeroed (the reference only
    ever evaluates pf at edges 1..G, src/correction.cpp:162-249)."""
    pfe = np.zeros(e_edge.shape[0], dtype=np.float64)
    pfe[1:] = corr_mod.pf(e_edge[1:], cfg.T)
    return pfe


def _edge_planck_dT(cfg: Config, e_edge: np.ndarray) -> np.ndarray:
    """d pf(e_edge, T)/dT in closed form:
    pf = k E^3 / (h^3 c^2 (e^{E/T} - 1))  =>
    dpf/dT = pf * (E/T^2) * e^{E/T} / (e^{E/T} - 1)."""
    d = np.zeros(e_edge.shape[0], dtype=np.float64)
    E = np.asarray(e_edge[1:], np.float64)
    T = cfg.T
    x = np.exp(E / T)
    d[1:] = corr_mod.pf(E, T) * (E / T**2) * x / (x - 1.0)
    return d


def _planck_dT_tables(cfg: Config):
    """Host analytic T-derivatives of every T-dependent table at the deck
    temperature: (dBdT, d(dEB)/dT, d pfe/dT), all in jk units. dBdT comes
    from the reference's 3-regime integrator (src/Planck.cpp); the other
    two follow from the closed-form pf derivative with the edge-difference
    structure of dEB/dkapEB (src/correction.cpp:162-174, 241-249)."""
    from .ops import planck as planck_mod
    from .ops.groups import build_group_grid

    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    _, dBdT_keV = planck_mod.planck_group_integrals(cfg.T, grid.edisc)
    dBdT = corr_mod._KCON * dBdT_keV

    e_edge = grid.e_edge
    G = cfg.G
    dpfe = _edge_planck_dT(cfg, e_edge)
    ddEB = np.zeros(G, dtype=np.float64)
    ddEB[0] = e_edge[1] * dpfe[1]
    if G > 1:
        for g in range(1, G - 1):
            ddEB[g] = e_edge[g + 1] * dpfe[g + 1] - e_edge[g] * dpfe[g]
        ddEB[G - 1] = -e_edge[G - 1] * dpfe[G - 1]
    return dBdT, ddEB, dpfe


def _f64(x) -> torch.Tensor:
    """A parameter or table as a float64 CPU tensor, keeping autograd."""
    if isinstance(x, torch.Tensor):
        return x.to(device="cpu", dtype=_F64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _set(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """x with entry i replaced by v, out of place (JAX's .at[i].set)."""
    return torch.cat([x[:i], v.reshape(1), x[i + 1:]])


def traced_tables(cfg: Config, base: Tables, kappa=None, rho=None,
                  psi_source=None, T=None) -> Tables:
    """Rebuild the kappa/rho-dependent Tables leaves as float64 CPU
    tensors that autograd follows.

    Mirrors the host build (ops/correction.build_correction_tables <-
    src/correction.cpp:125-340), including the unguarded G == 1 dsigEdE
    last-group overwrite: entry 0 is written with the first-group form
    and then overwritten with the last-group form. T-only leaves
    (quadrature, grid) pass through from ``base`` untouched. Parameters
    may be numpy arrays or tensors (on any device; the table algebra is
    tiny and runs on the host)."""
    G = cfg.G
    e_edge = np.asarray(base.e_edge, np.float64)
    e_ave = np.asarray(base.e_ave, np.float64)
    de_ave = np.asarray(base.de_ave, np.float64)
    B = _f64(base.B)
    dEB = _f64(base.dEB)
    pfe = _f64(_edge_planck(cfg, e_edge))

    if T is not None:
        # Exact linearisation around the deck temperature: every
        # T-dependence of the solve goes through (B, dEB, pfe).
        dBdT, ddEB, dpfe = _planck_dT_tables(cfg)
        dT = _f64(T) - cfg.T
        B = B + _f64(dBdT) * dT
        dEB = dEB + _f64(ddEB) * dT
        pfe = pfe + _f64(dpfe) * dT

    kappa = _f64(base.kappa if kappa is None else kappa)
    rho = _f64(base.rho if rho is None else rho)
    if psi_source is None:
        if T is not None and cfg.use_mg_equilib:
            # The equilibrium boundary source is itself Planckian
            # (solver.cpp:287-315): rebuild it from the traced B/dEB.
            mu = np.asarray(base.mu, np.float64)
            doppler = _f64(mu[:, None] * cfg.V / constants.SPEED_OF_LIGHT)
            psi_source = B[None, :] + (4.0 * B - dEB)[None, :] * doppler
        else:
            psi_source = _f64(base.psi_source)
    else:
        psi_source = _f64(psi_source)

    # Group-edge opacities (src/correction.cpp:125-159): linear-in-e_ave
    # interpolation; both outer edges clamp to the adjacent group value.
    if G > 1:
        wgt_l = _f64((e_ave[1:] - e_edge[1:G]) / (e_ave[1:] - e_ave[:-1]))
        wgt_r = _f64((e_edge[1:G] - e_ave[:-1]) / (e_ave[1:] - e_ave[:-1]))
        interior = kappa[:-1] * wgt_l + kappa[1:] * wgt_r
        kappa_edge = torch.cat([kappa[:1], interior, kappa[-1:]])
    else:
        kappa_edge = torch.cat([kappa[:1], kappa[:1]])

    ke_e = kappa_edge * _f64(e_edge)                # (G+1,) kappa*E at edges
    de = _f64(de_ave)

    # dsigEdE (src/correction.cpp:206-211): central difference, then the
    # one-sided ends, the last write winning (the G == 1 overwrite).
    dsig = torch.diff(ke_e) / de
    dsig = _set(dsig, 0, ke_e[1] / de[0])
    dsig = _set(dsig, G - 1, -ke_e[G] / de[G - 1])

    # dkapEB (src/correction.cpp:241-249); the last-group form uses edge
    # index G-1 (as written in the reference); for G == 1 only the
    # first-group form applies (the rest is guarded by num_groups > 1).
    kep = ke_e * pfe                                # (G+1,) kappa*E*B
    if G > 1:
        dkap = torch.diff(kep)
        dkap = _set(dkap, 0, kep[1])
        dkap = _set(dkap, G - 1, -ke_e[G - 1] * pfe[G - 1])
    else:
        dkap = kep[1:2]

    cor1 = dsig
    cor2 = 3.0 * rho * kappa * B - dkap
    cor3 = cor1 * (4.0 * B - dEB)

    return base._replace(kappa=kappa, rho=rho, rhokap=rho * kappa, B=B,
                         dEB=dEB, cor1=cor1, cor2=cor2, cor3=cor3,
                         psi_source=psi_source)


def traced_initial_state(cfg: Config, tables: Tables) -> State:
    """The reference initial condition psi = ends = B_g
    (src/solver.cpp:165-181) built from possibly-traced tables, so a
    temperature gradient includes the initial condition's T-dependence
    (the start of make_diff_solve_cuda's solve when no state is given).
    float64 on B's device (the CPU for numpy tables), broadcast, not
    copied, to (M, G, N, 2)."""
    ends = torch.as_tensor(tables.B, dtype=_F64)[None, :, None, None]
    ends = ends.expand(cfg.M, cfg.G, cfg.N, 2)
    return State(ends=ends, prev_ends=ends, half_ends=ends)


def state_from_numpy(ends, prev_ends, half_ends,
                     requires_grad: bool = False) -> State:
    """A State of float64 CPU tensors from three (M, G, N, 2) arrays, e.g.
    the JAX package's State as numpy; a solve places it on its device."""
    def leaf(x):
        t = torch.tensor(np.asarray(x, dtype=np.float64))
        return t.requires_grad_(requires_grad)

    return State(leaf(ends), leaf(prev_ends), leaf(half_ends))


def fit_params(cfg: Config, tables: Tables, state0: Optional[State],
               loss_of_state, params0: dict,
               num_steps: Optional[int] = None,
               learning_rate: float = 1e-2, iterations: int = 100,
               optimizer=None, solver: str = "general", device="cuda"):
    """Gradient-descent parameter estimation (the inverse problem).

    Minimises ``loss_of_state(final_state, params)`` (a scalar tensor)
    over ``params0``'s leaves (numpy arrays or tensors under
    ``_PARAM_KEYS``), by default with ``torch.optim.Adam(lr)``, whose
    defaults are optax's (beta 0.9/0.999, eps 1e-8 added to sqrt(v_hat)).
    ``optimizer``, if given, is a callable taking the list of parameter
    tensors and returning a ``torch.optim.Optimizer``. Returns (params,
    loss_history): float64 CPU tensors and one float per iteration, the
    loss at the parameters before that iteration's update.

    ``solver='pallas'`` differentiates through the CUDA kernels with the
    transposed-step kernels (ops/cuda_adjoint.make_diff_solve_cuda at its
    default, as JAX's: BDF2 fused K = min(max_steps_per_launch(), 4,
    num_steps) steps a launch on B11-B12, the tail and BE/CN one step a
    launch on B9-B10) on `device` (the plain versions for
    ``device='cpu'``): f32-grade gradients. ``'general'`` and ``'fast'``
    are not ported yet.
    """
    if solver == "general":
        raise NotImplementedError(
            "solver='general' needs the general f64 engine, not ported yet "
            "(ROADMAP A2); use solver='pallas'")
    if solver == "fast":
        raise NotImplementedError(
            "solver='fast' needs the XLA fast engine, not ported yet "
            "(ROADMAP A7); use solver='pallas'")
    if solver != "pallas":
        raise ValueError(f"unknown solver {solver!r} (general/fast/pallas)")
    from .ops.cuda_adjoint import make_diff_solve_cuda

    solve_fn = make_diff_solve_cuda(cfg, tables, num_steps=num_steps,
                                    device=device)
    params = {k: _f64(v).detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = (torch.optim.Adam(list(params.values()), lr=learning_rate)
           if optimizer is None else optimizer(list(params.values())))
    history = []
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        val = loss_of_state(solve_fn(params, state0), params)
        val.backward()
        opt.step()
        history.append(float(val.detach()))
    return {k: v.detach() for k, v in params.items()}, history
