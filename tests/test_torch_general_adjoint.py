"""The port's general-engine adjoint against the JAX package's, on the CPU.

* ``adjoint.make_diff_solve(device="cpu")`` (autograd through the general
  engine's float64 steps) against JAX ``jax.grad`` through
  ``make_diff_solve``, from the same tables (``tables_from_numpy``) and
  states (``state_from_numpy``): the loss value and the gradients in
  kappa, rho, psi_source, T and the initial state within 1e-10 of each
  gradient's largest magnitude, at BE, CN and BDF2, reflective and source
  boundaries, with the correction on and off;
* remat (``torch.utils.checkpoint`` a step) against none: bit-equal;
* ``fit_params(solver="general", device="cpu")`` against JAX's (optax
  Adam, whose defaults torch.optim.Adam shares) for 3 iterations: loss
  history within 1e-10 relative;
* the card path without a card raises.

Every JAX program here runs once at a tiny size, compiled with XLA's
backend optimisation off.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import adjoint as jax_adj
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import adjoint as port_adj
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
SRC = ((2.0,),) * 4      # off-equilibrium: an O(1) kappa sensitivity
TOL = 1e-10

_JIT = jax.jit
# Every JAX program here is float64: XLA's older CPU emitters compile them
# ~2x faster than its fusion emitters (test_torch_general._OPT_OFF_F64).
_OPTS = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True,
         "xla_cpu_use_fusion_emitters": False}


def _jit_opt_off(fn=None, **kw):
    """jax.jit whose programs compile with XLA's backend optimisation off
    (the same operations, compiled faster); any other form goes to
    jax.jit itself."""
    if fn is None or kw:
        return _JIT(fn, **kw) if fn is not None else functools.partial(
            _JIT, **kw)
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = _JIT(fn).lower(*args).compile(
                compiler_options=_OPTS)
        return compiled[key](*args)

    return call


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _both(path, **over):
    """(JAX cfg, JAX tables, port cfg, port tables), the port's tables the
    JAX ones as numpy."""
    jcfg = jax_load_config(path, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    return jcfg, jt, port.load_config(path, **over), pt


# name: (deck, overrides, parameters, whether a random initial state is
# given (else state=None: psi = B_g from the traced tables))
# (A BDF2 gradient program takes ~10 s to compile here, so there is one:
# the multigroup deck with the correction and a reflective left boundary,
# from psi = B_g, where T also reaches the equilibrium boundary source.)
CASES = {
    "mg-bdf2-refl": (MG, dict(N=16, bc_left_indicator=2),
                     ("kappa", "rho", "T"), False),
    "gray-be-src": (GRAY, dict(M=4, N=32, X=0.32, psi_source=SRC,
                               ts_method=1, bc_left_indicator=1),
                    ("kappa", "psi_source", "T"), True),
    "gray-cn-refl": (GRAY, dict(M=4, N=32, X=0.32, psi_source=SRC,
                                ts_method=2), ("kappa", "psi_source"), True),
}
STEPS = 3


def _param_values(jt, key):
    return {"kappa": np.asarray(jt.kappa) * 1.1,
            "rho": np.asarray(jt.rho) * 0.9,
            "psi_source": np.asarray(jt.psi_source) * 1.05,
            "T": np.asarray(1.0)}[key]


@functools.lru_cache(maxsize=None)
def _grads(name):
    """(value, grads) of 1e-2 * sum(ends^2) after STEPS steps, from JAX
    and from the port; grads hold the parameters and, where a state is
    given, the state's three planes."""
    path, over, keys, given = CASES[name]
    jcfg, jt, pcfg, pt = _both(path, **over)
    params = {k: _param_values(jt, k) for k in keys}
    arrays = None
    if given:
        rng = np.random.default_rng(len(name))
        base = np.asarray(jt.B)[None, :, None, None]
        shape = (pcfg.M, pcfg.G, pcfg.N, 2)
        arrays = [base * rng.uniform(0.5, 1.5, shape) for _ in range(3)]

    sf = jax_adj.make_diff_solve(jcfg, jt, num_steps=STEPS)

    def jloss(p, s):
        st = None if s is None else jax_transport.State(*s)
        return jnp.sum(sf(p, st).ends ** 2) * 1e-2

    jp = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    js = None if arrays is None else tuple(map(jnp.asarray, arrays))
    argnums = (0,) if js is None else (0, 1)
    jv, jg = _jit_opt_off(jax.value_and_grad(jloss, argnums=argnums))(jp, js)
    want = dict(jg[0])
    if js is not None:
        want.update(zip(("ends", "prev_ends", "half_ends"), jg[1]))

    ps = port_adj.make_diff_solve(pcfg, pt, num_steps=STEPS, device="cpu")
    tp = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
          for k, v in params.items()}
    st = (None if arrays is None
          else port_adj.state_from_numpy(*arrays, requires_grad=True))
    pv = torch.sum(ps(tp, st).ends ** 2) * 1e-2
    pv.backward()
    got = {k: v.grad for k, v in tp.items()}
    if st is not None:
        for k in ("ends", "prev_ends", "half_ends"):
            g = getattr(st, k).grad
            got[k] = torch.zeros_like(getattr(st, k)) if g is None else g
    return (float(jv), want), (float(pv.detach()), got)


def _grad_cases():
    out = []
    for name, (_, _, keys, given) in CASES.items():
        out += [(name, k) for k in ("value",) + keys]
        if given:
            out.append((name, "state"))
    return out


@pytest.mark.parametrize("name,key", _grad_cases())
def test_grads_match_jax(name, key):
    (jv, jg), (pv, pg) = _grads(name)
    if key == "value":
        assert abs(pv - jv) <= TOL * abs(jv)
        return
    names = ("ends", "prev_ends", "half_ends") if key == "state" else (key,)
    for k in names:
        want = np.asarray(jg[k])
        if not np.any(want):
            # A plane the solve never reads (prev and half at BDF2 and
            # BE): no gradient reaches it in either package.
            assert not torch.any(pg[k]), k
            continue
        assert _relerr(pg[k].numpy(), want) < TOL, k


def test_remat_is_bit_equal():
    """torch.utils.checkpoint changes memory, not the arithmetic."""
    _, _, pcfg, pt = _both(GRAY, M=4, N=16, X=0.16, psi_source=SRC)

    def gradof(remat):
        sf = port_adj.make_diff_solve(pcfg, pt, num_steps=4, remat=remat,
                                      device="cpu")
        k = torch.ones(1, dtype=torch.float64, requires_grad=True)
        torch.sum(sf({"kappa": k}).ends ** 2).backward()
        return k.grad

    assert torch.equal(gradof(True), gradof(False))


def _study(cfg_cls, G=4, N=16, steps=2):
    """benchmarks/grad_convergence.run_study's problem, cut to size, at
    Crank-Nicolson (JAX compiles a BDF2 update step for ~13 s here)."""
    return cfg_cls(
        M=4, G=G, N=N, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(0.02 + 0.005 * g for g in range(G))
                         for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001, use_correction=True,
        ts_method=2, dt=5e-5, max_timesteps=steps, include_validation=False)


def test_fit_params_history_matches_jax(monkeypatch):
    steps, iters, lr = 2, 3, 0.08
    jcfg = _study(JaxConfig)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = _study(PortConfig)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    rng = np.random.default_rng(7)
    k_true = np.asarray(jt.kappa) * rng.uniform(0.6, 1.6, size=jcfg.G)
    wt = np.asarray(jt.wt)

    # The target from the port's own solve at k_true.
    truth = port_adj.make_diff_solve(pcfg, pt, num_steps=steps,
                                     device="cpu")
    with torch.no_grad():
        phi_target = port_transport.compute_phi(port_transport.psi_from_ends(
            truth({"kappa": k_true}).ends), torch.tensor(wt)).numpy()

    def jloss(final, params):
        phi = jax_transport.compute_phi(
            jax_transport.psi_from_ends(final.ends), wt)
        return jnp.mean((phi / phi_target - 1.0) ** 2)

    # JAX's fit jits its whole update step; compile it with XLA's backend
    # optimisation off (the same program).
    import optax  # noqa: F401  (its import-time jax.jit calls stay as they are)
    monkeypatch.setattr(jax, "jit", _jit_opt_off)
    _, jhist = jax_adj.fit_params(
        jcfg, jt, jax_transport.initial_state(jcfg, jt), jloss,
        {"kappa": jnp.asarray(jt.kappa)}, num_steps=steps,
        learning_rate=lr, iterations=iters, solver="general")
    monkeypatch.undo()

    twt, tphi = torch.tensor(wt), torch.tensor(phi_target)

    def ploss(final, params):
        phi = port_transport.compute_phi(
            port_transport.psi_from_ends(final.ends), twt)
        return torch.mean((phi / tphi - 1.0) ** 2)

    params, phist = port_adj.fit_params(
        pcfg, pt, port_transport.initial_state(pcfg, pt), ploss,
        {"kappa": np.asarray(jt.kappa)},
        num_steps=steps, learning_rate=lr, iterations=iters,
        solver="general", device="cpu")
    assert len(phist) == iters and phist[-1] < phist[0]
    assert params["kappa"].dtype == torch.float64
    np.testing.assert_allclose(phist, jhist, rtol=TOL)


def test_card_path_needs_a_card():
    """Without a CUDA device the general adjoint's defaults raise; nothing
    falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs this path")
    _, _, pcfg, pt = _both(GRAY, M=4, N=16, X=0.16, max_timesteps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_adj.make_diff_solve(pcfg, pt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_adj.fit_params(pcfg, pt, None, lambda s, p: s.ends.sum(),
                            {"kappa": np.ones(1)})
