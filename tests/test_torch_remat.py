"""Remat inside the torch.func transforms (adjoint._RematStep), on the CPU.

Under ``torch.func.grad`` and ``torch.func.vmap(torch.func.grad(...))``
the differentiable solves rematerialise each step as JAX's
``jax.checkpoint`` does under ``jax.vmap``: the step is an
autograd.Function that saves only its inputs and recomputes itself in its
backward. Held here, for ``make_diff_solve`` and ``make_diff_solve_fast``:

* with ``remat=True`` the step's forward runs 2n times for n steps (once
  forward, once recomputed), n times without remat, under both
  transforms and outside them (torch.utils.checkpoint);
* the gradients equal the ``remat=False`` ones within 1e-12, and
  ``jax.vmap(jax.grad(...))`` through JAX's ``make_diff_solve`` within
  1e-12 (at CN: the JAX general engine's BDF2 adjoint compiles ~3x
  slower, and the step counts above cover BDF2);
* a plain ``torch.func.vmap`` (the ensembles' forward) runs each step
  once, with the same values as remat off;
* under a second derivative (``hessian``, ``grad`` of ``grad``) and
  forward mode (``jvp``, ``jacfwd``), which the rematerialised step does
  not carry, the steps run bare (n step forwards) and the derivatives
  equal the ``remat=False`` ones within 1e-12.

The JAX program is compiled as test_torch_general's float64 programs.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import adjoint as jax_adj
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport

from radiative_transfer_tpu_torch import adjoint as port_adj
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs

from test_torch_general import _jit_opt_off_f64

torch.set_num_threads(1)

TOL = 1e-12
STEPS = 3
SOLVERS = {"general": port_adj.make_diff_solve,
           "fast": port_adj.make_diff_solve_fast}


def _small(cls, ts_method):
    """tests/test_adjoint.py's small_cfg: M = 4, G = 3, N = 16, reflective
    left, a source right, the correction on."""
    return cls(M=4, G=3, N=16, X=1.0, efirst=0.1, elast=10.0,
               bc_left_indicator=2, bc_right_indicator=1,
               psi_source=tuple(tuple(0.01 * (m + 1) + 0.002 * g
                                      for g in range(3)) for m in range(4)),
               rho=2.0, kappa_grey=1.0, T=1.0, V=0.001,
               use_correction=True, ts_method=ts_method, dt=1e-4,
               max_timesteps=STEPS, include_validation=False)


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _port(ts_method):
    cfg = _small(PortConfig, ts_method)
    tables, _, _ = port_transport.build_tables(cfg)
    return cfg, tables


KAPPAS = np.asarray([[1.0, 1.1, 0.9], [1.2, 0.8, 1.05], [0.95, 1.0, 1.3]])


@pytest.fixture
def counted(monkeypatch):
    """Counts the step forwards of both solvers: the general solver's
    steps (transport.make_step_fn's) and FastEngine.step."""
    runs = {"n": 0}
    make = port_transport.make_step_fn

    def make_step_fn(*a, **kw):
        step = make(*a, **kw)

        def counted_step(s):
            runs["n"] += 1
            return step(s)

        return counted_step

    fast_step = port_fs.FastEngine.step

    def step(self, *a, **kw):
        runs["n"] += 1
        return fast_step(self, *a, **kw)

    monkeypatch.setattr(port_transport, "make_step_fn", make_step_fn)
    monkeypatch.setattr(port_fs.FastEngine, "step", step)
    return runs


def _loss_fn(solver, ts_method, remat, steps=STEPS):
    cfg, tables = _port(ts_method)
    sf = SOLVERS[solver](cfg, tables, num_steps=steps, remat=remat,
                         device="cpu")
    wt = torch.tensor(np.asarray(tables.wt))

    def loss(kappa):
        f = sf({"kappa": kappa})
        phi = port_transport.compute_phi(port_transport.psi_from_ends(f.ends),
                                         wt)
        return torch.sum(phi ** 2)

    return loss


TRANSFORMS = {
    "vmap_grad": lambda loss, k: torch.func.vmap(torch.func.grad(loss))(k),
    "grad": lambda loss, k: torch.stack([torch.func.grad(loss)(x)
                                         for x in k]),
}


@pytest.mark.parametrize("ts_method", [3, 2])
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_remat_recomputes_each_step(counted, solver, transform, ts_method):
    """2n step forwards with remat (the backward recomputes each step), n
    without; the gradients agree to 1e-12."""
    k = torch.tensor(KAPPAS)
    calls = 1 if transform == "vmap_grad" else len(KAPPAS)
    grads = {}
    for remat in (True, False):
        loss = _loss_fn(solver, ts_method, remat)
        counted["n"] = 0
        grads[remat] = TRANSFORMS[transform](loss, k)
        assert counted["n"] == (2 if remat else 1) * STEPS * calls, remat
    assert _relerr(grads[True].numpy(), grads[False].numpy()) < TOL


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_remat_outside_a_transform_recomputes_each_step(counted, solver):
    """torch.utils.checkpoint outside the transforms, as before: 2n step
    forwards, the same gradient as remat off."""
    grads = []
    for remat in (True, False):
        loss = _loss_fn(solver, 3, remat)
        kap = torch.tensor(KAPPAS[0], requires_grad=True)
        counted["n"] = 0
        loss(kap).backward()
        assert counted["n"] == (2 if remat else 1) * STEPS, remat
        grads.append(kap.grad.numpy())
    assert _relerr(grads[0], grads[1]) < TOL


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_vmap_forward_runs_each_step_once(counted, solver):
    """The ensembles' forward (vmap, no grad): one step run a step, the
    values of remat off."""
    k = torch.tensor(KAPPAS)
    out = []
    for remat in (True, False):
        loss = _loss_fn(solver, 3, remat)
        counted["n"] = 0
        out.append(torch.func.vmap(loss)(k))
        assert counted["n"] == STEPS
    assert torch.equal(out[0], out[1])


@pytest.fixture(scope="module")
def jax_vmap_grad():
    """jax.vmap(jax.grad(...)) of the same loss through JAX's
    make_diff_solve (remat on, its default) at CN."""
    cfg = _small(JaxConfig, 2)
    jt, _, _ = jax_transport.build_tables(cfg)
    sf = jax_adj.make_diff_solve(cfg, jt, num_steps=STEPS)

    def loss(k):
        f = sf({"kappa": k}, None)
        phi = jax_transport.compute_phi(jax_transport.psi_from_ends(f.ends),
                                        jt.wt)
        return jnp.sum(phi ** 2)

    ks = jnp.asarray(KAPPAS)
    return np.asarray(_jit_opt_off_f64(jax.vmap(jax.grad(loss)))(ks))


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_remat_vmap_grad_matches_jax(jax_vmap_grad, solver):
    got = TRANSFORMS["vmap_grad"](_loss_fn(solver, 2, True),
                                  torch.tensor(KAPPAS))
    assert _relerr(got.numpy(), jax_vmap_grad) < TOL


HIGHER = {
    "hessian": lambda loss, k: torch.func.hessian(loss)(k),
    "grad_grad": lambda loss, k: torch.func.grad(
        lambda x: torch.sum(torch.func.grad(loss)(x) ** 2))(k),
    "jvp": lambda loss, k: torch.stack(torch.func.jvp(
        loss, (k,), (torch.linspace(0.5, 1.5, k.numel(),
                                    dtype=k.dtype),))),
    "jacfwd": lambda loss, k: torch.func.jacfwd(loss)(k),
}


@pytest.mark.parametrize("transform", sorted(HIGHER))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_second_order_and_forward_mode_run_bare(counted, solver, transform):
    """hessian, grad of grad, jvp and jacfwd over a 2-step solve: with
    remat on the steps run bare (n step forwards, no recompute) and the
    derivatives equal remat off's to 1e-12."""
    steps = 2
    k = torch.tensor(KAPPAS[1])
    got = {}
    for remat in (True, False):
        loss = _loss_fn(solver, 3, remat, steps)
        counted["n"] = 0
        got[remat] = HIGHER[transform](loss, k)
        assert counted["n"] == steps, remat
    assert torch.all(torch.isfinite(got[False]))
    assert float(got[False].abs().max()) > 0.0
    assert _relerr(got[True].numpy(), got[False].numpy()) < TOL
