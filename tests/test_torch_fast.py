"""The port's fast engine and its adjoint against the JAX package's, on
the CPU.

The same inputs (seeded numpy arrays; tables through
``transport.tables_from_numpy``) go through each JAX function and its
port:

* ``ops/fast_sweep._pick_chunk`` equal to JAX's for N in 1..300, a prime
  and powers of two, padded and not;
* ``FastEngine`` in float64 within 1e-12 (max error over max magnitude)
  of JAX's ``FastEngine`` on the gray deck at BE, CN and BDF2, the
  multigroup deck with the correction, the LLNL deck, a padded reflective
  N and the four boundary combinations (ends and prev); in float32 within
  1e-5 of JAX's float32 engine; its tile/untile and from_ends/ends round
  trips exact (padded too); the GrayTest equilibrium kept at float32
  (tests/test_fast_sweep.py's bar); against the port's general engine
  (1e-12); ``run_problem(engine="fast")`` and
  ``make_multichip_engine(engine="fast")``;
* ``adjoint.make_diff_solve_fast``: value and gradients within 1e-10 of
  JAX's and within 1e-12 of the port's ``make_diff_solve``;
  ``fit_params(solver="fast")``'s 5-iteration loss history within 1e-10
  of JAX's.

Every JAX program here is compiled with XLA's backend optimisation off,
the float64 ones also with its older CPU emitters
(test_torch_general._jit_opt_off_f64).
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

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
from radiative_transfer_tpu.ops import fast_sweep as jax_fs

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import adjoint as port_adj
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel import mesh as port_mesh

from test_torch_general import _jit_opt_off, _jit_opt_off_f64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
TOL = 1e-12
GRAD_TOL = 1e-10
F64 = torch.float64


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


# -- _pick_chunk ---------------------------------------------------------------

@pytest.mark.parametrize("chunk,pad", [(256, True), (256, False),
                                       (16, True), (10, True), (25, False)])
def test_pick_chunk_matches_jax(chunk, pad):
    ns = list(range(1, 301)) + [997, 7919] + [1 << k for k in range(21)]
    for n in ns:
        assert port_fs._pick_chunk(n, chunk, pad) == jax_fs._pick_chunk(
            n, chunk, pad), n


# -- FastEngine against JAX's -----------------------------------------------------

SRC8 = tuple((float(i + 1),) for i in range(8))
# name: (deck, overrides, steps, chunk)
CASES = {
    "gray-be": (GRAY, dict(ts_method=1), 5, 10),
    "gray-cn": (GRAY, dict(ts_method=2), 5, 10),
    "gray-bdf2": (GRAY, dict(ts_method=3), 5, 10),
    "mg-correction": (MG, {}, 4, 25),
    "llnl": (LLNL, {}, 2, 10),
    "padded-refl": (GRAY, dict(N=101, bc_left_indicator=2), 3, 256),
}
for _l, _r in ((0, 0), (1, 1), (2, 0), (2, 1)):
    CASES[f"bc-{_l}{_r}"] = (GRAY, dict(M=8, N=64, ts_method=3,
                                        bc_left_indicator=_l,
                                        bc_right_indicator=_r,
                                        psi_source=SRC8), 3, 16)


def _jax_fast(jcfg, jt, steps, chunk, dtype):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64 if dtype == jnp.float64
                   else _jit_opt_off)
        eng, st = jax_fs.solve_fast(jcfg, jt, num_steps=steps, dtype=dtype,
                                    chunk=chunk)
        return eng, (np.asarray(eng.ends(st)),
                     np.asarray(eng.ends_pair(st.p0, st.p1)),
                     np.asarray(eng.ends_pair(st.h0, st.h1)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_engine_f64_matches_jax(name):
    path, over, steps, chunk = CASES[name]
    jcfg, jt, pcfg, pt = _both(path, **over)
    jeng, want = _jax_fast(jcfg, jt, steps, chunk, jnp.float64)
    eng, st = port_fs.solve_fast(pcfg, pt, num_steps=steps, dtype=F64,
                                 chunk=chunk, device="cpu")
    assert (eng.chunk, eng.N_pad) == (jeng.chunk, jeng.N_pad)
    got = (eng.ends(st), *eng.prev_half_ends(st))
    for g, w in zip(got, want):
        assert g.dtype == F64 and g.shape == w.shape
        assert _relerr(g.numpy(), w) < TOL


@pytest.mark.parametrize("name", ["gray-bdf2", "mg-correction"])
def test_fast_engine_f32_matches_jax(name):
    path, over, steps, chunk = CASES[name]
    jcfg, jt, pcfg, pt = _both(path, **over)
    _, want = _jax_fast(jcfg, jt, steps, chunk, jnp.float32)
    eng, st = port_fs.solve_fast(pcfg, pt, num_steps=steps,
                                 dtype=torch.float32, chunk=chunk,
                                 device="cpu")
    got = eng.ends(st)
    assert got.dtype == torch.float32
    assert _relerr(got.numpy(), want[0]) < 1e-5


@pytest.mark.parametrize("path,over,chunk", [
    (MG, dict(N=40), 8), (GRAY, dict(N=101), 16), (LLNL, {}, 10)])
def test_layout_round_trips_exact(path, over, chunk):
    """from_ends -> ends (and prev/half) and tile -> untile are exact,
    padded (N = 101 at chunk 16) or not."""
    cfg = port.load_config(path, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, chunk=chunk,
                             device="cpu")
    rng = np.random.default_rng(0)
    ends = torch.tensor(rng.random((cfg.M, cfg.G, cfg.N, 2)))
    st = eng.from_ends(ends, ends * 2.0, ends * 3.0)
    assert st.e0.shape == (eng.chunk, 2, eng.Bh, eng.nc)
    assert torch.equal(eng.ends(st), ends)
    prev, half = eng.prev_half_ends(st)
    assert torch.equal(prev, ends * 2.0) and torch.equal(half, ends * 3.0)
    flat = torch.tensor(rng.random((2, eng.Bh, eng.N_pad)))
    assert torch.equal(eng.untile(eng.tile(flat)), flat)


def test_equilibrium_preserved_fast_f32():
    """The GrayTest invariant holds at float32 on the fast engine
    (tests/test_fast_sweep.py's bar; the reference's is 1e-6 at f64,
    tests/test_gray.cpp:89-98)."""
    cfg = port.load_config(GRAY)
    tables, _, _ = port_transport.build_tables(cfg)
    eng, st = port_fs.solve_fast(cfg, tables, num_steps=50,
                                 dtype=torch.float32, chunk=25, device="cpu")
    psi = port_transport.psi_from_ends(eng.ends(st))
    F = port_transport.compute_F(
        psi, torch.tensor(tables.mu, dtype=torch.float32),
        torch.tensor(tables.wt, dtype=torch.float32))
    assert float(F.abs().max()) < 1e-3


@pytest.mark.parametrize("deck,over,steps", [
    (MG, dict(N=64), 4), (GRAY, dict(N=101, ts_method=2), 6),
    (LLNL, {}, 2)])
def test_fast_engine_matches_general_engine(deck, over, steps):
    """From a seeded state off equilibrium, against the port's general
    engine (its oracle of its own): 1e-12."""
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    g = torch.Generator().manual_seed(cfg.N)
    st0 = port_transport.State(*(
        x * (0.5 + torch.rand(x.shape, generator=g, dtype=F64))
        for x in port_transport.initial_state(cfg, tables)))
    want = port_transport.solve(cfg, tables, st0, steps, device="cpu")
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, device="cpu")
    st = eng.solve(eng.from_ends(*st0), num_steps=steps)
    got = (eng.ends(st), *eng.prev_half_ends(st))
    for gt, w in zip(got, want):
        assert _relerr(gt.numpy(), w.numpy()) < TOL


def test_run_problem_fast_and_selection():
    cfg = port.load_config(GRAY, N=64, max_timesteps=3)
    tables, _, _ = port_transport.build_tables(cfg)
    gen = port_transport.run_problem(cfg, device="cpu")
    fast = port_transport.run_problem(cfg, engine="fast", device="cpu")
    for k in ("psi", "phi", "phi_plus", "left_ends", "right_ends"):
        assert _relerr(getattr(fast, k).numpy(),
                       getattr(gen, k).numpy()) < TOL, k
    make = port_parallel.make_multichip_engine
    eng = make(cfg, tables, engine="fast", dtype=F64, device="cpu")
    assert isinstance(eng, port_fs.FastEngine) and eng.dtype == F64
    from radiative_transfer_tpu_torch.parallel.sharded_fast import (
        ShardedFastEngine)

    seng = make(cfg, tables, port_mesh.make_mesh_1d(1), engine="fast",
                dtype=F64, device="cpu")
    assert isinstance(seng, ShardedFastEngine) and seng.dtype == F64
    with pytest.raises(ValueError, match="float32 or"):
        port_fs.FastEngine(cfg, tables, dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_fs.FastEngine(cfg, tables)


# -- make_diff_solve_fast and fit_params(solver="fast") -----------------------------

SRC = ((2.0,),) * 4      # off-equilibrium: an O(1) kappa sensitivity


@pytest.mark.parametrize("ts,given", [(2, True), (1, False)])
def test_diff_solve_fast_matches_jax_and_general(ts, given):
    """Value and gradients in kappa, psi_source and T (and the initial
    ends where a state is given): within 1e-10 of JAX's
    make_diff_solve_fast, within 1e-12 of the port's make_diff_solve.
    N = 40 at chunk 256 pads the engine to 48 cells."""
    jcfg, jt, pcfg, pt = _both(GRAY, M=4, N=40, X=0.4, psi_source=SRC,
                               ts_method=ts)
    rng = np.random.default_rng(ts)
    params = {"kappa": np.asarray(jt.kappa) * 1.1,
              "psi_source": np.asarray(jt.psi_source) * 1.05,
              "T": np.asarray(1.0)}
    arrays = None
    if given:
        shape = (pcfg.M, pcfg.G, pcfg.N, 2)
        arrays = [np.asarray(jt.B)[None, :, None, None]
                  * rng.uniform(0.5, 1.5, shape) for _ in range(3)]
    steps = 3

    sf = jax_adj.make_diff_solve_fast(jcfg, jt, num_steps=steps)

    def jloss(p, s):
        st = None if s is None else jax_transport.State(*s)
        return jnp.sum(sf(p, st).ends ** 2) * 1e-2

    jp = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    js = None if arrays is None else tuple(map(jnp.asarray, arrays))
    argnums = (0,) if js is None else (0, 1)
    jv, jg = _jit_opt_off_f64(jax.value_and_grad(jloss, argnums=argnums))(
        jp, js)
    want = dict(jg[0])
    if js is not None:
        want["ends"] = jg[1][0]

    def port_grads(make):
        ps = make(pcfg, pt, num_steps=steps, device="cpu")
        tp = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
              for k, v in params.items()}
        st = (None if arrays is None
              else port_adj.state_from_numpy(*arrays, requires_grad=True))
        val = torch.sum(ps(tp, st).ends ** 2) * 1e-2
        val.backward()
        got = {k: v.grad.numpy() for k, v in tp.items()}
        if st is not None:
            got["ends"] = st.ends.grad.numpy()
        return float(val.detach()), got

    fv, fg = port_grads(port_adj.make_diff_solve_fast)
    gv, gg = port_grads(port_adj.make_diff_solve)
    assert abs(fv - float(jv)) <= GRAD_TOL * abs(float(jv))
    assert abs(fv - gv) <= TOL * abs(gv)
    assert set(fg) == set(want)
    for k in want:
        assert _relerr(fg[k], want[k]) < GRAD_TOL, k
        assert _relerr(fg[k], gg[k]) < TOL, k


def _study(cfg_cls, G=4, N=16, steps=2):
    """benchmarks/grad_convergence.run_study's problem, cut to size, at
    Crank-Nicolson (tests/test_torch_general_adjoint.py's)."""
    return cfg_cls(
        M=4, G=G, N=N, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(0.02 + 0.005 * g for g in range(G))
                         for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001, use_correction=True,
        ts_method=2, dt=5e-5, max_timesteps=steps, include_validation=False)


def test_fit_params_fast_history_matches_jax(monkeypatch):
    steps, iters, lr = 2, 5, 0.08
    jcfg = _study(JaxConfig)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = _study(PortConfig)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    rng = np.random.default_rng(7)
    k_true = np.asarray(jt.kappa) * rng.uniform(0.6, 1.6, size=jcfg.G)
    wt = np.asarray(jt.wt)
    truth = port_adj.make_diff_solve_fast(pcfg, pt, num_steps=steps,
                                          device="cpu")
    with torch.no_grad():
        phi_target = port_transport.compute_phi(port_transport.psi_from_ends(
            truth({"kappa": k_true}).ends), torch.tensor(wt)).numpy()

    def jloss(final, params):
        phi = jax_transport.compute_phi(
            jax_transport.psi_from_ends(final.ends), wt)
        return jnp.mean((phi / phi_target - 1.0) ** 2)

    import optax  # noqa: F401  (its import-time jax.jit calls stay as they are)
    monkeypatch.setattr(jax, "jit", _jit_opt_off_f64)
    _, jhist = jax_adj.fit_params(
        jcfg, jt, jax_transport.initial_state(jcfg, jt), jloss,
        {"kappa": jnp.asarray(jt.kappa)}, num_steps=steps,
        learning_rate=lr, iterations=iters, solver="fast")
    monkeypatch.undo()

    twt, tphi = torch.tensor(wt), torch.tensor(phi_target)

    def ploss(final, params):
        phi = port_transport.compute_phi(
            port_transport.psi_from_ends(final.ends), twt)
        return torch.mean((phi / tphi - 1.0) ** 2)

    params, phist = port_adj.fit_params(
        pcfg, pt, port_transport.initial_state(pcfg, pt), ploss,
        {"kappa": np.asarray(jt.kappa)}, num_steps=steps, learning_rate=lr,
        iterations=iters, solver="fast", device="cpu")
    assert len(phist) == iters and phist[-1] < phist[0]
    assert params["kappa"].dtype == F64
    np.testing.assert_allclose(phist, jhist, rtol=GRAD_TOL)
