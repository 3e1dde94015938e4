"""The port's ensembles against the JAX package's, on the CPU.

The same inputs (seeded numpy arrays; tables through
``transport.tables_from_numpy``) go through each JAX function and its
port (tests/test_ensemble.py's cases):

* ``stack_ensemble``'s tables and Config bit-equal to JAX's for kappa,
  rho, psi_source and T members;
* ``solve_ensemble`` (``torch.func.vmap`` over the general solver) within
  1e-12 of JAX's and 1e-14 of the port's own member loop, the T ensemble
  likewise, ``solver="fast"`` within 1e-12 of the general one;
  ``torch.func.vmap(torch.func.grad(...))`` within 1e-12 of per-member
  gradients; the validation errors (JAX's words);
* ``solve_ensemble_stacked``: ``fast`` at float64 within 1e-12 of JAX's
  stacked ``fast`` and of the vmapped general solver; ``single`` and
  ``auto`` (the kernels' plain versions) within 5e-5 of max|ends| of the
  general members (JAX's f32 bar); ``df`` within 1e-11 of each member's
  FastEngine at float64; each stacked member bit-equal to its own solve
  on the same engine (rows are independent); the 'T' members' full
  nonlinear table rebuild within 1e-12 of a from-scratch build;
* on two spawned gloo ranks (one launch): ``solve_ensemble(mesh=)`` on a
  one-axis mesh against no mesh (1e-12), K not dividing the ranks
  refused, and the stacked members on a 2x1 (group, spatial) mesh
  through the sharded engine against one rank.

Every JAX program here is compiled with XLA's backend optimisation off.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import ensemble as jax_ens
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import adjoint as port_adj
from radiative_transfer_tpu_torch import ensemble as port_ens
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel.distributed import launch_local

from test_torch_general import _jit_opt_off

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
TOL = 1e-12
F64 = torch.float64


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _small(**kw) -> dict:
    """tests/test_adjoint.py's small_cfg: M = 4, G = 3, N = 16, reflective
    left, a source right, the correction on, BDF2."""
    base = dict(
        M=4, G=3, N=16, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(0.01 * (m + 1) + 0.002 * g for g in range(3))
                         for m in range(4)),
        rho=2.0, kappa_grey=1.0, T=1.0, V=0.001,
        use_correction=True, ts_method=3, dt=1e-4, max_timesteps=3,
        include_validation=False)
    base.update(kw)
    return base


def _both(**kw):
    """(JAX cfg, JAX tables, JAX initial state, port cfg, port tables,
    port initial state) of _small(**kw), the port's from JAX's arrays."""
    jcfg = JaxConfig(**_small(**kw))
    jt, _, _ = jax_transport.build_tables(jcfg)
    js = jax_transport.initial_state(jcfg, jt)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    ps = port_adj.state_from_numpy(*(np.asarray(x) for x in js))
    return jcfg, jt, js, PortConfig(**_small(**kw)), pt, ps


def _kappas(tables, K, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(tables.kappa) * rng.uniform(0.5, 2.0, (K, 3))


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off)
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))


# -- stack_ensemble ------------------------------------------------------------

STACKS = {
    "kappa": lambda t, K: {"kappa": _kappas(t, K, 0)},
    "rho": lambda t, K: {"rho": np.asarray(t.rho) * np.arange(1, K + 1)[:,
                                                                       None]},
    "psi_source": lambda t, K: {"psi_source": np.asarray(t.psi_source)[None]
                                * np.linspace(0.5, 1.5, K)[:, None, None]},
    "kappa-T": lambda t, K: {"kappa": _kappas(t, K, 1),
                             "T": np.linspace(0.8, 1.25, K)},
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stack_ensemble_bit_equal_to_jax(name):
    over = (dict(use_mg_equilib=True, psi_source=()) if "T" in name
            else {})
    jcfg, jt, _, pcfg, pt, _ = _both(**over)
    params = STACKS[name](jt, 3)
    jc, jtab, jk = jax_ens.stack_ensemble(jcfg, jt, params)
    pc, ptab, pk = port_ens.stack_ensemble(pcfg, pt, params)
    assert pk == jk == 3
    assert pc == PortConfig(**{f: getattr(jc, f)
                               for f in jc.__dataclass_fields__})
    for f in ptab._fields:
        assert np.array_equal(np.asarray(getattr(ptab, f)),
                              np.asarray(getattr(jtab, f))), f


# -- solve_ensemble --------------------------------------------------------------

def test_ensemble_matches_jax_and_member_loop():
    jcfg, jt, js, pcfg, pt, ps = _both(ts_method=3)
    K = 5
    kappas = _kappas(jt, K, 1)
    want = _jax(jax_ens.solve_ensemble, jcfg, jt, {"kappa": kappas},
                num_steps=2, state=js)
    got = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas}, num_steps=2,
                                  state=ps, device="cpu")
    assert got.ends.shape == (K, pcfg.M, pcfg.G, pcfg.N, 2)
    for g, w in zip(got, want):
        assert _relerr(g.numpy(), w) < TOL
    solve_fn = port_adj.make_diff_solve(pcfg, pt, num_steps=2, device="cpu")
    for k in range(K):
        ref = solve_fn({"kappa": kappas[k]}, ps)
        assert _relerr(got.ends[k].numpy(), ref.ends.numpy()) < 1e-14


def test_ensemble_T_per_member_initial_condition():
    """A temperature ensemble rebuilds psi = B(T_k) per member."""
    jcfg, jt, _, pcfg, pt, _ = _both(ts_method=2, use_mg_equilib=True,
                                     psi_source=())
    Ts = np.array([0.9, 1.0, 1.1]) * pcfg.T
    want = _jax(jax_ens.solve_ensemble, jcfg, jt, {"T": Ts}, num_steps=2,
                state=None)
    got = port_ens.solve_ensemble(pcfg, pt, {"T": Ts}, num_steps=2,
                                  state=None, device="cpu")
    assert _relerr(got.ends.numpy(), want.ends) < TOL
    solve_fn = port_adj.make_diff_solve(pcfg, pt, num_steps=2, device="cpu")
    for k, T in enumerate(Ts):
        ref = solve_fn({"T": np.asarray(T)}, None)
        assert _relerr(got.ends[k].numpy(), ref.ends.numpy()) < 1e-14
    # Members genuinely differ (the IC and sources moved with T).
    assert not torch.allclose(got.ends[0], got.ends[1])


@pytest.mark.parametrize("ts", [2, 3])
def test_ensemble_batched_gradients(ts):
    """vmap(grad): per-member opacity gradients in one program, through
    the general solver's remat default (checkpoint is skipped inside the
    transform, adjoint.py's module doc)."""
    _, jt, _, pcfg, pt, ps = _both(ts_method=ts)
    solve_fn = port_adj.make_diff_solve(pcfg, pt, num_steps=2, device="cpu")
    wt = torch.tensor(np.asarray(jt.wt))

    def loss(kappa):
        f = solve_fn({"kappa": kappa}, ps)
        phi = port_transport.compute_phi(port_transport.psi_from_ends(f.ends),
                                         wt)
        return torch.sum(phi ** 2)

    kappas = torch.tensor(_kappas(jt, 4, 3))
    g_batch = torch.func.vmap(torch.func.grad(loss))(kappas)
    for k in range(4):
        kap = kappas[k].clone().requires_grad_(True)
        loss(kap).backward()
        assert _relerr(g_batch[k].numpy(), kap.grad.numpy()) < TOL


def test_vmap_ensemble_fast_solver_matches_general():
    _, jt, _, pcfg, pt, ps = _both(ts_method=3)
    kappas = _kappas(jt, 3, 8)
    ref = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas}, num_steps=2,
                                  state=ps, device="cpu")
    got = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas}, num_steps=2,
                                  state=ps, solver="fast", device="cpu")
    for g, r in zip(got, ref):
        assert _relerr(g.numpy(), r.numpy()) < TOL


def test_observe_phi():
    _, jt, _, pcfg, pt, ps = _both(ts_method=1)
    kappas = _kappas(jt, 2, 2)
    final = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas},
                                    num_steps=1, state=ps, device="cpu")
    phi = port_ens.observe_phi(pcfg, pt, final)
    assert phi.shape == (2, pcfg.G, pcfg.N)
    wt = torch.tensor(np.asarray(pt.wt))
    for k in range(2):
        assert torch.equal(phi[k], port_transport.compute_phi(
            port_transport.psi_from_ends(final.ends[k]), wt))


@pytest.mark.parametrize("params,match", [
    ({}, "nothing to batch"),
    ({"kappa": np.ones((3, 3)), "rho": np.ones((4, 3))},
     "disagree on the leading axis")])
def test_ensemble_validation_errors(params, match):
    _, _, _, pcfg, pt, ps = _both()
    with pytest.raises(ValueError, match=match):
        port_ens.solve_ensemble(pcfg, pt, params, num_steps=1, state=ps,
                                device="cpu")
    with pytest.raises(ValueError, match=match):
        port_ens.solve_ensemble_stacked(pcfg, pt, params, num_steps=1,
                                        device="cpu")


def test_ensemble_refusals():
    _, _, _, pcfg, pt, ps = _both()
    with pytest.raises(ValueError, match="unknown solver"):
        port_ens.make_ensemble_solve(pcfg, pt, 1, solver="pallas",
                                     device="cpu")
    with pytest.raises(ValueError, match="unknown ensemble parameter"):
        port_ens.stack_ensemble(pcfg, pt, {"sigma": np.ones((2, 3))})
    # engine="fast" on a mesh is ShardedFastEngine: the stacked solve runs.
    from radiative_transfer_tpu_torch.parallel import mesh as port_mesh

    got = port_ens.solve_ensemble_stacked(
        pcfg, pt, {"kappa": np.ones((2, 3))}, num_steps=1,
        mesh=port_mesh.make_mesh_2d(1, 1), engine="fast", device="cpu")
    assert got.ends.shape[0] == 2 and torch.all(torch.isfinite(got.ends))


# -- solve_ensemble_stacked ----------------------------------------------------------

def test_stacked_fast_f64_matches_jax_and_vmap_general():
    """The stacked G' = K*G problem on the f64 fast engine reproduces
    JAX's stacked fast engine and the vmapped general solver member for
    member (BDF2 + v/c correction, shared initial state)."""
    jcfg, jt, js, pcfg, pt, ps = _both(ts_method=3)
    kappas = _kappas(jt, 3, 5)
    want = _jax(jax_ens.solve_ensemble_stacked, jcfg, jt,
                {"kappa": kappas}, num_steps=3, state=js, engine="fast",
                dtype=jnp.float64)
    got = port_ens.solve_ensemble_stacked(
        pcfg, pt, {"kappa": kappas}, num_steps=3, state=ps, engine="fast",
        dtype=F64, device="cpu")
    ref = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas}, num_steps=3,
                                  state=ps, device="cpu")
    for g, w, r in zip(got, want, ref):      # ends, prev, half
        assert g.dtype == F64 and g.shape == w.shape
        assert _relerr(g.numpy(), w) < TOL
        assert _relerr(g.numpy(), r.numpy()) < TOL


@pytest.mark.parametrize("engine", ["single", "auto"])
def test_stacked_kernels_match_vmap_general(engine):
    """The stacked problem through the float32 kernels' plain versions at
    the f32 drift bar (tests/test_ensemble.py:141)."""
    _, jt, _, pcfg, pt, ps = _both(ts_method=3)
    kappas = _kappas(jt, 4, 6)
    ref = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas}, num_steps=3,
                                  state=ps, device="cpu")
    got = port_ens.solve_ensemble_stacked(pcfg, pt, {"kappa": kappas},
                                          num_steps=3, state=ps,
                                          engine=engine, device="cpu")
    assert got.ends.dtype == torch.float32
    scale = float(ref.ends.abs().max())
    assert float((got.ends.double() - ref.ends).abs().max()) < 5e-5 * scale


def test_stacked_T_ensemble_exact_nonlinear_rebuild():
    """state=None gives each member its own psi = B(T_k), and the stacked
    path rebuilds each member's tables in full: member k equals a
    from-scratch build_tables at T_k and the general solve (1e-12), and
    JAX's stacked fast engine (1e-12)."""
    jcfg, jt, _, pcfg, pt, _ = _both(ts_method=2, use_mg_equilib=True,
                                     psi_source=())
    Ts = np.array([0.8, 1.0, 1.25]) * pcfg.T
    got = port_ens.solve_ensemble_stacked(pcfg, pt, {"T": Ts}, num_steps=2,
                                          engine="fast", dtype=F64,
                                          device="cpu")
    want = _jax(jax_ens.solve_ensemble_stacked, jcfg, jt, {"T": Ts},
                num_steps=2, engine="fast", dtype=jnp.float64)
    assert _relerr(got.ends.numpy(), want.ends) < TOL
    for k, T in enumerate(Ts):
        cfg_k = pcfg.replace(T=float(T))
        tab_k, _, _ = port_transport.build_tables(cfg_k)
        ref = port_transport.solve(cfg_k, tab_k,
                                   port_transport.initial_state(cfg_k, tab_k),
                                   2, device="cpu")
        assert _relerr(got.ends[k].numpy(), ref.ends.numpy()) < TOL
    assert not torch.allclose(got.ends[0], got.ends[1])


def test_stacked_df_matches_member_fast_f64():
    """engine='df': each member within 1e-11 of its own FastEngine solve at
    float64 (tests/test_ensemble.py's df case)."""
    cfg = port.load_config(GRAY, M=4, N=64, X=0.64, max_timesteps=3)
    tables, _, _ = port_transport.build_tables(cfg)
    kappas = np.array([[0.6], [1.0], [1.7]])
    out = port_ens.solve_ensemble_stacked(cfg, tables, {"kappa": kappas},
                                          num_steps=3, engine="df",
                                          device="cpu")
    assert out.ends.dtype == F64
    for k, kap in enumerate(kappas):
        cfg_k = cfg.replace(kappa_grey=float(kap[0]))
        tab_k, _, _ = port_transport.build_tables(cfg_k)
        fe = port_fs.FastEngine(cfg_k, tab_k, dtype=F64, device="cpu")
        ref = fe.ends(fe.solve(num_steps=3)).numpy()
        assert _relerr(out.ends[k].numpy(), ref) < 1e-11, k


# (deck edit, engine, engine kwargs): single_group.prm moving (a boundary
# source of 2.0 against B = 4.0931), and its thick tiny-batch variant
# (N = 2048, X = 20.48), where the halo engines' creep bound admits the
# stacked Bh = 4 and auto and df pick them.
MEMBER_CASES = {
    "mv-single": (False, 3, "single", {}),
    "mv-df": (False, 3, "df", {}),
    "mv-fast": (False, 3, "fast", {"dtype": F64}),
    "thick-auto": (True, 3, "auto", {}),
    "thick-auto-cn": (True, 2, "auto", {}),
    "thick-df": (True, 3, "df", {}),
    "thick-df-cn": (True, 2, "df", {}),
}


@pytest.mark.parametrize("name", list(MEMBER_CASES))
def test_stacked_members_bit_equal_to_own_solves(name):
    """Rows are independent: each stacked member is bit for bit the same
    engine's solve of that member alone (ends, prev, half)."""
    thick, ts, engine, kw = MEMBER_CASES[name]
    over = dict(psi_source=((2.0,), (2.0,)), ts_method=ts)
    if thick:
        over.update(N=2048, X=20.48)
    cfg = port.load_config(GRAY, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    kappas = np.array([[0.5], [1.0], [1.7], [3.0]])
    got = port_ens.solve_ensemble_stacked(cfg, tables, {"kappa": kappas},
                                          num_steps=4, engine=engine,
                                          device="cpu", **kw)
    for k in range(len(kappas)):
        tab_k = port_ens._host_member_tables(cfg, tables,
                                             {"kappa": kappas[k]})
        eng = port_parallel.make_multichip_engine(
            cfg, tab_k, None, engine=engine, device="cpu", **kw)
        st = eng.solve(num_steps=4)
        want = (eng.ends(st), *eng.prev_half_ends(st))
        for g, w in zip((got.ends[k], got.prev_ends[k], got.half_ends[k]),
                        want):
            assert torch.equal(g, w), (k, type(eng).__name__)


# -- two ranks -------------------------------------------------------------------

RANK_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from radiative_transfer_tpu_torch import ensemble
    from radiative_transfer_tpu_torch.config.config import Config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod
    out_path, cfg_kw, kappas = sys.argv[1], eval(sys.argv[2]), sys.argv[3]
    kappas = np.load(kappas)
    distributed.initialize(device_type="cpu")
    cfg = Config(**cfg_kw)
    tables, _, _ = transport.build_tables(cfg)
    st = transport.initial_state(cfg, tables)
    ens = mesh_mod.Mesh({"ens": 2})
    out = {"vmap": np.stack([x.numpy() for x in ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=st, mesh=ens,
        device="cpu")])}
    try:
        ensemble.solve_ensemble(cfg, tables, {"kappa": kappas[:3]},
                                num_steps=1, state=st, mesh=ens,
                                device="cpu")
    except ValueError as e:
        out["odd"] = np.array(str(e))
    g = mesh_mod.make_mesh_2d(2, 1)
    out["stacked"] = np.stack([x.numpy() for x in
                               ensemble.solve_ensemble_stacked(
        cfg, tables, {"kappa": kappas}, num_steps=2, state=st, mesh=g,
        engine="pallas", device="cpu")])
    if distributed.process_index() == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Rank 0's results on two gloo ranks: one launch."""
    tmp = tmp_path_factory.mktemp("ensemble_ranks")
    _, jt, _, _, _, _ = _both(ts_method=1)
    np.save(tmp / "kappas.npy", _kappas(jt, 4, 2))
    runs = launch_local(["-c", RANK_WORKER, str(tmp / "ranks.npz"),
                         repr(_small(ts_method=1)), str(tmp / "kappas.npy")],
                        2, cwd=REPO, timeout=240)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "ranks.npz")), np.load(tmp / "kappas.npy")


def test_ensemble_sharded_over_mesh_matches_unsharded(rank_runs):
    """Each rank solves its members whole; the gathered ensemble equals
    the meshless one (1e-12)."""
    ranks, kappas = rank_runs
    _, _, _, pcfg, pt, ps = _both(ts_method=1)
    plain = port_ens.solve_ensemble(pcfg, pt, {"kappa": kappas},
                                    num_steps=2, state=ps, device="cpu")
    for g, w in zip(ranks["vmap"], plain):
        assert g.shape == tuple(w.shape)
        assert _relerr(g, w.numpy()) < TOL


def test_ensemble_mesh_must_divide_evenly(rank_runs):
    ranks, _ = rank_runs
    assert "ensemble size 3 must divide evenly over 2 devices" in str(
        ranks["odd"])


def test_stacked_members_shard_over_group_mesh(rank_runs):
    """A 'g'-axis mesh splits the stacked members' rows over the ranks
    (no exchange between members): the sharded engine on 2x1 against
    the same engine at one rank, 1e-6 (float32 planes)."""
    ranks, kappas = rank_runs
    _, _, _, pcfg, pt, ps = _both(ts_method=1)
    from radiative_transfer_tpu_torch.parallel import mesh as port_mesh

    one = port_ens.solve_ensemble_stacked(
        pcfg, pt, {"kappa": kappas}, num_steps=2, state=ps,
        mesh=port_mesh.make_mesh_2d(1, 1), engine="pallas", device="cpu")
    for g, w in zip(ranks["stacked"], one):
        assert _relerr(g, w.numpy()) < 1e-6
