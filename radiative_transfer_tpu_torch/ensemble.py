"""Ensemble solves: batched parameter sweeps.

Port of radiative_transfer_tpu/ensemble.py. The serial C++ reference
runs one deck a process; because the solve is a pure function of its
parameters, an ensemble of parameter sets (opacity samples, source
candidates, temperature perturbations) runs as one batched solve. Use
cases: uncertainty propagation, design sweeps and batched inverse
problems (``torch.func.vmap(torch.func.grad(...))`` over adjoint's solves
gives per-member gradients).

Parameters follow adjoint.traced_tables: any subset of {'kappa', 'rho',
'psi_source', 'T'}, each stacked along a leading ensemble axis.

Two execution paths:

* :func:`solve_ensemble` — ``torch.func.vmap`` over the float64 general
  solver (adjoint.make_diff_solve) or the fast engine's differentiable
  solve (adjoint.make_diff_solve_fast): the member axis runs through the
  engine's Python step loop as a batch dimension of every operation;
  differentiable and exact. On a one-axis parallel/mesh.Mesh each rank
  solves its share of the members, with no collective but the final
  gather.
* :func:`solve_ensemble_stacked` — folds the ensemble into the engines'
  row batch as one problem of G' = K*G groups (:func:`stack_ensemble`)
  and runs it on the CUDA engines through parallel.make_multichip_engine
  (``engine='fast'``: ops/fast_sweep.FastEngine), so small decks that
  underfill the card at Bh < 8 fill it once K members stack.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import adjoint
from .config.config import Config
from .models import transport
from .models.transport import State, Tables
from .ops import correction as corr_mod
from .ops.groups import build_group_grid


def _batch_size(params: dict) -> int:
    sizes = {int(np.shape(v)[0]) for v in params.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"ensemble leaves disagree on the leading axis: {sorted(sizes)}"
        )
    return sizes.pop()


def make_ensemble_solve(cfg: Config, tables: Tables,
                        num_steps: Optional[int] = None, remat: bool = True,
                        shared_state: bool = True, solver: str = "general",
                        device="cuda"):
    """Build ``ens_fn(params, state=None) -> State`` where every leaf of
    ``params`` carries a leading ensemble axis and the returned State's
    leaves carry it too, on `device` in float64.

    ``shared_state``: True (default) gives every member one initial State
    (None rebuilds psi = B_g per member from the traced tables, as a 'T'
    ensemble needs: its initial condition varies); False expects the
    State's leaves stacked along the ensemble axis. ``solver='fast'``
    vmaps adjoint.make_diff_solve_fast instead of the general solver: the
    same members to roundoff."""
    make = {"general": adjoint.make_diff_solve,
            "fast": adjoint.make_diff_solve_fast}
    if solver not in make:
        raise ValueError(f"unknown solver {solver!r} (general/fast)")
    solve_fn = make[solver](cfg, tables, num_steps, remat=remat,
                            device=device)
    state_axis = None if shared_state else 0

    def ens_fn(params: dict, state: Optional[State] = None) -> State:
        axes = ({k: 0 for k in params}, state_axis)
        return torch.func.vmap(solve_fn, in_dims=axes)(params, state)

    return ens_fn


def solve_ensemble(cfg: Config, tables: Tables, params: dict,
                   num_steps: Optional[int] = None,
                   state: Optional[State] = None, mesh=None,
                   remat: bool = True, solver: str = "general",
                   device="cuda") -> State:
    """Run an ensemble of solves as one batched program on `device`,
    optionally split over a mesh along the ensemble axis.

    ``params``: dict of stacked parameter leaves, e.g. ``{'kappa': (K, G)
    array}`` for K opacity samples. ``mesh``: a one-axis
    parallel/mesh.Mesh (K must divide evenly over its ranks); each rank
    solves its K / ranks members whole, and the final States are gathered
    on every rank. Returns the final State with a leading ensemble axis
    on every leaf."""
    if not params:
        raise ValueError("empty params: nothing to batch over")
    k = _batch_size(params)
    ens_fn = make_ensemble_solve(cfg, tables, num_steps, remat=remat,
                                 shared_state=True, solver=solver,
                                 device=device)
    params = {key: v if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v, np.float64))
              for key, v in params.items()}
    if mesh is None:
        return ens_fn(params, state)

    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"ensemble sharding wants a 1-axis mesh, got {mesh.axis_names}")
    axis = mesh.axis_names[0]
    nd = mesh.size
    if k % nd != 0:
        raise ValueError(
            f"ensemble size {k} must divide evenly over {nd} devices")
    per = k // nd
    mine = slice(mesh.axis_index(axis) * per, (mesh.axis_index(axis) + 1)
                 * per)
    out = ens_fn({key: v[mine] for key, v in params.items()}, state)
    return State(*(mesh.all_gather(x.contiguous(), axis)
                   .reshape((k,) + tuple(x.shape[1:])) for x in out))


def observe_phi(cfg: Config, tables: Tables, final: State) -> torch.Tensor:
    """Scalar-flux observable for an ensemble State: (K, G, N)."""
    wt = torch.as_tensor(np.asarray(tables.wt), dtype=final.ends.dtype,
                         device=final.ends.device)
    return torch.func.vmap(
        lambda e: transport.compute_phi(transport.psi_from_ends(e), wt)
    )(final.ends)


# ---------------------------------------------------------------------------
# Stacked ensembles: K members through the CUDA engines
# ---------------------------------------------------------------------------

_STACK_KEYS = frozenset({"kappa", "rho", "psi_source", "T"})


def _host_member_tables(cfg: Config, base: Tables, member: dict) -> Tables:
    """One member's Tables by the host numpy chain.

    Reuses ops/correction.build_correction_tables, the table chain
    transport.build_tables runs, in float64 numpy. Unlike
    adjoint.traced_tables, which linearises the T-dependence around the
    deck temperature to stay differentiable, a 'T' member here gets the
    full nonlinear Planck-table rebuild: exact at every member
    temperature."""
    unknown = set(member) - _STACK_KEYS
    if unknown:
        raise ValueError(
            f"unknown ensemble parameter(s) {sorted(unknown)}; "
            f"supported: {sorted(_STACK_KEYS)}")
    G = cfg.G

    def arr(x, shape):
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(x, np.float64), shape))

    kappa = arr(member.get("kappa", base.kappa), (G,))
    rho = arr(member.get("rho", base.rho), (G,))
    T = float(member["T"]) if "T" in member else cfg.T
    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    ct = corr_mod.build_correction_tables(
        T, rho, kappa, grid.e_edge, grid.e_ave, grid.de_ave, grid.edisc)
    if "psi_source" in member:
        psi_source = arr(member["psi_source"], (cfg.M, G))
    elif cfg.use_mg_equilib and "T" in member:
        # The equilibrium boundary source is itself Planckian
        # (solver.cpp:287-315): rebuild it from the member's B/dEB.
        psi_source = corr_mod.equilibrium_psi_source(
            ct.B, ct.dEB, np.asarray(base.mu, np.float64), cfg.V)
    else:
        psi_source = np.asarray(base.psi_source, np.float64)
    return base._replace(
        kappa=kappa, rho=rho, rhokap=rho * kappa, B=ct.B, dEB=ct.dEB,
        cor1=ct.cor1, cor2=ct.cor2, cor3=ct.cor3, psi_source=psi_source)


def _member_arrays(params: dict, i: int) -> dict:
    """Member i of every stacked leaf, as host numpy."""
    return {k: (v[i].detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)[i]) for k, v in params.items()}


def stack_ensemble(cfg: Config, tables: Tables, params: dict):
    """K parameter members -> ONE problem of G' = K*G groups.

    Valid because the engines have no run-time coupling between groups:
    every group interaction (Planck emission, the v/c correction's
    frequency-derivative stencil over group edges) is folded into
    per-(m, g) coefficient planes at setup (ops/fast_sweep
    .build_kind_coeffs), so K members stacked along the group axis solve
    EXACTLY their K separate problems. Each member's correction chain is
    built at its own G before stacking, so no stencil reaches across
    members.

    Returns ``(cfg_s, tables_s, K)``; stacked group index g' = k*G + g."""
    if not params:
        raise ValueError("empty params: nothing to batch over")
    K = _batch_size(params)
    G, M = cfg.G, cfg.M
    members = [_host_member_tables(cfg, tables, _member_arrays(params, i))
               for i in range(K)]

    def cat(name, shape, axis):
        parts = [
            np.broadcast_to(np.asarray(getattr(m, name), np.float64), shape)
            for m in members
        ]
        return np.ascontiguousarray(np.concatenate(parts, axis=axis))

    e_edge = np.asarray(tables.e_edge, np.float64)
    tables_s = tables._replace(
        rhokap=cat("rhokap", (G,), 0), rho=cat("rho", (G,), 0),
        kappa=cat("kappa", (G,), 0), B=cat("B", (G,), 0),
        dEB=cat("dEB", (G,), 0),
        cor1=cat("cor1", (G,), 0), cor2=cat("cor2", (G,), 0),
        cor3=cat("cor3", (G,), 0),
        psi_source=cat("psi_source", (M, G), 1),
        # Shape-consistent placeholders: the engines never read the
        # energy grid (its effect is baked into the leaves above).
        e_edge=np.concatenate([np.tile(e_edge[:-1], K), e_edge[-1:]]),
        e_ave=np.tile(np.asarray(tables.e_ave, np.float64), K),
        de_ave=np.tile(np.asarray(tables.de_ave, np.float64), K),
    )
    cfg_s = cfg.replace(
        G=K * G, have_group_bounds=False, group_bounds=(),
        have_group_absorption_opacities=False, group_kappa=(),
        psi_source=(),
    )
    return cfg_s, tables_s, K


def _unstack(arr: torch.Tensor, K: int, cfg: Config) -> torch.Tensor:
    """(M, K*G, N, 2) stacked ends -> (K, M, G, N, 2) member-major."""
    return arr.reshape(cfg.M, K, cfg.G, cfg.N, 2).movedim(1, 0)


def solve_ensemble_stacked(cfg: Config, tables: Tables, params: dict,
                           num_steps: Optional[int] = None,
                           state: Optional[State] = None, mesh=None,
                           engine: str = "auto", **engine_kw) -> State:
    """Run the ensemble as ONE stacked problem on the engines: the
    high-throughput sibling of :func:`solve_ensemble`.

    The members fold into the engines' row batch (Bh' = K * M/2 * G, via
    :func:`stack_ensemble`), and the engine and mesh semantics are
    parallel.make_multichip_engine's (`engine`: auto, single, df, fast
    without a mesh; the mesh engines with one, whose 'g' axis splits the
    members over ranks with no exchange between members). `engine_kw`
    goes to the engine (``device=``, ``scan_tol=``; ``dtype=`` for fast).

    ``state``: one shared initial State, tiled over the members on the
    engine's device (None: each member's own equilibrium psi = B_k, the
    right condition for 'T' ensembles). 'T' members get the full
    nonlinear table rebuild, exact at every temperature, where the vmap
    path's traced tables are linearised around the deck T. Returns a
    State whose leaves carry a leading (K,) member axis, at the engine's
    precision (float32 kernels; float64 from the double-float kernels'
    hi + lo and from engine='fast' with dtype=torch.float64)."""
    from .parallel import make_multichip_engine

    cfg_s, tables_s, K = stack_ensemble(cfg, tables, params)
    eng = make_multichip_engine(cfg_s, tables_s, mesh, engine=engine,
                                **engine_kw)
    if state is None:
        st = eng.init_state()
    else:
        def tile(x):
            return torch.tile(torch.as_tensor(x).to(eng.device),
                              (1, K, 1, 1))

        st = eng.from_ends(*(tile(x) for x in state))
    st = eng.solve(st, num_steps=num_steps)
    prev, half = eng.prev_half_ends(st)
    return State(ends=_unstack(eng.ends(st), K, cfg),
                 prev_ends=_unstack(prev, K, cfg),
                 half_ends=_unstack(half, K, cfg))
