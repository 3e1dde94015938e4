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

Three differentiable solves: ``make_diff_solve``, autograd through the
general engine's float64 steps (models/transport.make_step_fn), the exact
discrete adjoint; ``make_diff_solve_fast``, autograd through the tiled
fast engine's float64 steps (ops/fast_sweep.FastEngine), the same adjoint
to roundoff; and ops/cuda_adjoint.make_diff_solve_cuda, whose forward and
backward run the hand-written CUDA kernels (B9-B12), f32-grade.
``fit_params`` drives any of them with ``torch.optim.Adam``.

Under remat each step runs under ``torch.utils.checkpoint``; inside a
``torch.func`` transform (the ensembles' ``vmap``, ``vmap(grad)``), whose
grad transforms refuse checkpoint's saved-tensor hooks, each step runs as
``_RematStep`` instead: an autograd.Function that saves only its inputs
(the State and the traced tensors the step reads) and recomputes the step
in its backward. Either way the backward keeps one State a step, as JAX's
``jax.checkpoint`` does under ``vmap``. ``_RematStep``'s backward is
first-order (its recompute runs under ``no_grad``) and it has no jvp, so
under a second derivative (``grad`` of ``grad``, ``hessian``) or forward
mode (``jvp``, ``jacfwd``) the steps run bare instead, exact, keeping
every step's intermediates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch._C._functorch import TransformType
from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from . import constants
from .config.config import Config
from .models import transport
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
    (the start of a differentiable solve when no state is given).
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


class _RematStep(torch.autograd.Function):
    """One rematerialised step that the torch.func transforms accept:
    ``_RematStep.apply(run, *tensors) -> tuple`` with ``run`` a pure
    function of ``tensors`` (the State's planes, then every traced tensor
    the step reads). It saves only its inputs and, in ``backward``,
    recomputes the step under ``torch.func.vjp`` to pull the cotangents
    back; ``generate_vmap_rule`` batches both under ``vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        # An input handed back as-is (BDF2's prev = ends) leaves as a view:
        # autograd.Function refuses to save an input it also returns.
        ins = {id(t) for t in tensors}
        return tuple(o.view_as(o) if id(o) in ins else o
                     for o in run(*tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cots):
        # The grad transforms run the backward with create_graph: without
        # no_grad every step's recompute would be recorded and kept alive
        # by the gradients it returns (first-order gradients only).
        with torch.no_grad():
            _, pull = torch.func.vjp(lambda *t: tuple(ctx.run(*t)),
                                     *ctx.saved_tensors)
            return (None, *pull(cots))


def _transforms() -> list:
    """The active torch.func transforms, outermost first (empty outside
    them)."""
    if torch._C._functorch.peek_interpreter_stack() is None:
        return []
    return [i.key() for i in retrieve_all_functorch_interpreters()]


def _step_loop(step, st, n: int, remat: bool, closed=()):
    """`n` applications of ``step(st, closed)`` (a NamedTuple of tensors
    in and out; ``closed`` a pytree of the traced tensors the step reads).
    With `remat` each step runs under torch.utils.checkpoint, or inside a
    torch.func transform as a ``_RematStep``, or bare under a second
    derivative or forward mode (module doc)."""
    cls = type(st)
    keys = _transforms()
    if (not remat or keys.count(TransformType.Grad) > 1
            or TransformType.Jvp in keys):
        for _ in range(n):
            st = step(st, closed)
        return st
    if not keys:
        for _ in range(n):
            st = cls(*checkpoint(lambda *s: tuple(step(cls(*s), closed)),
                                 *st, use_reentrant=False))
        return st
    leaves, spec = pytree.tree_flatten(closed)
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    k = len(st)

    def run(*tensors):
        c = list(leaves)
        for i, x in zip(at, tensors[k:]):
            c[i] = x
        return tuple(step(cls(*tensors[:k]), pytree.tree_unflatten(c, spec)))

    for _ in range(n):
        st = cls(*_RematStep.apply(run, *st, *(leaves[i] for i in at)))
    return st


def make_diff_solve(cfg: Config, tables: Tables,
                    num_steps: Optional[int] = None, remat: bool = True,
                    device="cuda"):
    """Build ``solve_fn(params, state=None) -> State``, differentiable in
    both arguments, on `device` in float64.

    ``params`` holds any of _PARAM_KEYS (numpy arrays or tensors); omitted
    ones stay at their ``tables`` values (for 'T' gradients are exact at
    the deck temperature, see the module docstring). ``state=None`` starts
    from psi = B_g built from the traced tables, so a T gradient includes
    the initial condition. The function runs ``num_steps`` full timesteps
    (default cfg.max_timesteps) of cfg.ts_method, the program of
    models/transport.solve; with ``remat`` each step runs under
    ``torch.utils.checkpoint``, so the backward pass keeps one State a
    step and recomputes each step's sweeps (JAX's jax.checkpoint); under
    ``torch.func.grad`` and ``vmap(grad)`` likewise, and under a second
    derivative or ``jvp`` without remat (module doc).

    Compose with the diagnostics for observables::

        solve_fn = make_diff_solve(cfg, tables, device="cpu")
        final = solve_fn({"kappa": kappa0})
        phi = transport.compute_phi(transport.psi_from_ends(final.ends), wt)
        torch.mean((phi - phi_target) ** 2).backward()
    """
    device = transport.solve_device(device)
    n = cfg.max_timesteps if num_steps is None else num_steps

    def step(s: State, leaves) -> State:
        return transport.make_step_fn(cfg, Tables(*leaves), _F64, device)(s)

    def solve_fn(params: dict, state: Optional[State] = None) -> State:
        unknown = set(params) - set(_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown differentiable parameters {sorted(unknown)}; "
                f"supported: {_PARAM_KEYS}")
        t = traced_tables(cfg, tables, **params)
        if state is None:   # B on the device: the broadcast fills there
            state = traced_initial_state(cfg, t._replace(B=t.B.to(device)))
        t = transport.device_tables(t, _F64, device)
        st = State(*(torch.as_tensor(x).to(device=device, dtype=_F64)
                     for x in state))
        return _step_loop(step, st, n, remat, tuple(t))

    return solve_fn


def make_diff_solve_fast(cfg: Config, tables: Tables,
                         num_steps: Optional[int] = None, remat: bool = True,
                         chunk: int = 256, device="cuda"):
    """Differentiable solve through the tiled fast engine, in float64 on
    `device`.

    The contract of :func:`make_diff_solve` (``solve_fn(params,
    state=None) -> State`` in the global (M, G, N, 2) layout, autograd
    through every step), but the forward program is
    ops/fast_sweep.FastEngine's fused constant-coefficient scan: the
    per-group parameter dependence reaches the engine's coefficient planes
    through build_kind_coeffs_traced and its boundary planes through the
    traced psi_source, so gradients flow through the algebra the engine
    runs. Values and gradients match make_diff_solve to roundoff, and
    ``remat`` acts as there."""
    from .ops import fast_sweep as fs

    device = transport.solve_device(device)
    n = cfg.max_timesteps if num_steps is None else num_steps
    eng = fs.FastEngine(cfg, tables, dtype=_F64, chunk=chunk, device=device)
    Mh, G = cfg.M // 2, cfg.G
    if cfg.ts_method == 1:
        kinds = {fs.BE: cfg.dt}
    elif cfg.ts_method == 2:
        kinds = {fs.CN: cfg.dt}
    else:
        half = cfg.dt / 2.0
        kinds = {fs.BE: half, fs.CN: half, fs.BDF: half}

    def on_device(kc):
        return fs.KindCoeffs(*(x.to(device) if isinstance(x, torch.Tensor)
                               else x for x in kc))

    def solve_fn(params: dict, state: Optional[State] = None) -> State:
        unknown = set(params) - set(_PARAM_KEYS)
        if unknown:
            raise ValueError(
                f"unknown differentiable parameters {sorted(unknown)}; "
                f"supported: {_PARAM_KEYS}")
        t = traced_tables(cfg, tables, **params)
        kcs = {k: on_device(fs.build_kind_coeffs_traced(cfg, t, k, ts))
               for k, ts in kinds.items()}
        # Traced boundary value planes, as FastEngine builds its own
        # (the left-vacuum fall-through to source included,
        # solver.cpp:667-671); reflective or fixed stays the engine's.
        psi_plane = fs._to_plane(t.psi_source.to(device), Mh, G)
        bc_neg = (psi_plane[0] if cfg.bc_right_indicator == 1
                  else torch.zeros(Mh * G, dtype=_F64, device=device))
        bc_pos = None if cfg.bc_left_indicator == 2 else psi_plane[1]

        if state is None:
            # psi = ends = B_g (solver.cpp:165-181) from the traced B, so
            # a T gradient includes the initial condition.
            Bg = t.B.to(device)[None, :].expand(Mh, G).reshape(Mh * G)
            plane = Bg[None, None, :, None].expand(eng.chunk, 2, Mh * G,
                                                   eng.nc)
            st = fs.FlatState(plane, plane, plane, plane, plane, plane)
        else:
            st = eng.from_ends(*state)

        def step(s, closed):
            return eng.step(s, kcs=closed[0], bc=closed[1])

        st = _step_loop(step, st, n, remat, (kcs, (bc_neg, bc_pos)))
        prev, half = eng.prev_half_ends(st)
        return State(ends=eng.ends(st), prev_ends=prev, half_ends=half)

    return solve_fn


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

    ``solver='general'`` (the default) differentiates through the
    general engine in float64 (make_diff_solve) on `device`: the exact
    discrete adjoint. ``solver='pallas'`` differentiates through the CUDA
    kernels with the transposed-step kernels (ops/cuda_adjoint
    .make_diff_solve_cuda at its default, as JAX's: BDF2 fused K =
    min(max_steps_per_launch(), 4, num_steps) steps a launch on B11-B12,
    the tail and BE/CN one step a launch on B9-B10) on `device` (the
    plain versions for ``device='cpu'``): f32-grade gradients.
    ``solver='fast'`` differentiates through the tiled fast engine in
    float64 (make_diff_solve_fast): the general solver's gradients to
    roundoff.
    """
    if solver in ("general", "fast"):
        make = make_diff_solve if solver == "general" else make_diff_solve_fast
        solve_fn = make(cfg, tables, num_steps=num_steps, device=device)
    elif solver == "pallas":
        from .ops.cuda_adjoint import make_diff_solve_cuda

        solve_fn = make_diff_solve_cuda(cfg, tables, num_steps=num_steps,
                                        device=device)
    else:
        raise ValueError(f"unknown solver {solver!r} (general/fast/pallas)")
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
