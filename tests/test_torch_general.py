"""The port's general engine against the JAX package's, on the CPU.

The same inputs (seeded numpy arrays; tables through
``transport.tables_from_numpy``) go through each JAX function and its
port:

* ``ops/scan.affine_scan`` against JAX ``affine_scan`` (at N = 4096 its
  chunked path) and ``affine_scan_sequential``, within 1e-12 of
  max|pref_b|, including optically thick rows whose prefix products
  underflow;
* ``ops/sweep.build_coeffs`` (with upwind fills) and ``sweep_oriented``
  for BE, CN and BDF, 1e-12;
* ``transport.substep`` for every kind at reflective, source and vacuum
  boundaries with the correction on and off, 1e-12 against JAX and 1e-11
  (tests/test_sweep_vs_oracle.py's bar) against tests/oracle.py's straight
  loop, which also pins the reference's boundary quirks;
* ``make_step_fn`` at ts_method 1, 2, 3 and 3 with bdf2_symmetric_half,
  and the step's own quirks (prev committed every step at BE/CN, the BDF2
  half snapshot);
* ``solve`` on the three shipped decks (20 steps; the LLNL deck its own
  2) against the JAX CLI's ``--engine general`` run and the oracle, and the
  CLI's default engine's 8 CSVs against the JAX CLI's: 1e-12 of each
  file's max magnitude (F against max|phi|), 1e-5 at float32;
* ``run_problem(engine="df")`` against the general engine, 1e-10;
* ``parallel/sharded.solve_sharded`` on 1x2 and 2x1 meshes of two gloo
  ranks (one launch) against one device and against JAX's
  ``transport.solve``, and the CLI's ``--engine general --mesh 1x2``
  against one device, 1e-12.

Every JAX program here is compiled with XLA's backend optimisation off,
the float64 ones also with its older CPU emitters (_OPT_OFF_F64).
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import functools
import io
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiative_transfer_tpu as jax_rt
from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import scan as jax_scan
from radiative_transfer_tpu.ops import sweep as jax_sweep

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import scan as port_scan
from radiative_transfer_tpu_torch.ops import sweep as port_sweep
from radiative_transfer_tpu_torch.parallel.distributed import launch_local

from oracle import Oracle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
DECKS = {"gray": (GRAY, 20), "mg": (MG, 20), "llnl": (LLNL, 2)}
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")
TOL = 1e-12
ORACLE_TOL = 1e-11
F64 = torch.float64

_JIT = jax.jit


_OPT_OFF = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
# For programs whose floating work is all float64: XLA's older CPU emitters
# compile them ~2x faster (the JAX general engine's BDF2 adjoint: 6.3 s
# against 12.6 s). They round float32 work differently from the fusion
# emitters (tests/test_torch_steady.py's float32 steady cycle moved by a
# tenth of its bar), so float32 programs keep _OPT_OFF.
_OPT_OFF_F64 = dict(_OPT_OFF, xla_cpu_use_fusion_emitters=False)


def _opt_off(opts):
    def jit(fn=None, **kw):
        """jax.jit whose programs compile with XLA's backend optimisation
        off (the same operations, compiled faster); any other form goes to
        jax.jit itself."""
        if fn is None or kw:
            return _JIT(fn, **kw) if fn is not None else functools.partial(
                _JIT, **kw)
        compiled = {}

        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            key = (tree, tuple((np.shape(x), np.result_type(x))
                               for x in leaves))
            if key not in compiled:
                compiled[key] = _JIT(fn).lower(*args).compile(
                    compiler_options=opts)
            return compiled[key](*args)

        return call

    return jit


_jit_opt_off = _opt_off(_OPT_OFF)
_jit_opt_off_f64 = _opt_off(_OPT_OFF_F64)


def _relerr(got, ref, scale=None):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref)) if scale is None else scale
    return np.max(np.abs(got - ref)) / (scale + 1e-300)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


# -- ops/scan.py ---------------------------------------------------------------

@pytest.mark.parametrize("n,thick", [(100, False), (1000, False),
                                     (1024, False), (4096, False),
                                     (1000, True)])
def test_affine_scan_matches_jax(n, thick):
    """N = 100 and 1000 (ragged) take the whole-axis prefix, 1024 too (4
    chunks is the least chunked case, 1024 // 256 = 4: chunked), 4096 the
    chunked path; thick rows (a < 0.01) underflow their prefix products
    within a few hundred cells."""
    rng = np.random.default_rng(n)
    hi = 0.01 if thick else 1.0
    a = rng.uniform(0.0, hi, (3, 2, n))
    b = rng.normal(size=(3, 2, n))
    ja, jb = _jit_opt_off_f64(jax_scan.affine_scan)(jnp.asarray(a),
                                                 jnp.asarray(b))
    sa, sb = _jit_opt_off_f64(jax_scan.affine_scan_sequential)(
        jnp.asarray(a),
                                                           jnp.asarray(b))
    pa, pb = port_scan.affine_scan(_t(a), _t(b))
    qa, qb = port_scan.affine_scan_sequential(_t(a), _t(b))
    scale = np.max(np.abs(np.asarray(sb)))
    for got_a, got_b in ((pa, pb), (qa, qb)):
        assert torch.all(torch.isfinite(got_b))
        for ref_a, ref_b in ((ja, jb), (sa, sb)):
            assert _relerr(got_b.numpy(), ref_b, scale) < TOL
            assert _relerr(got_a.numpy(), ref_a) < TOL


def test_affine_scan_other_axis_and_apply_prefix():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, (7, 5))
    b = rng.normal(size=(7, 5))
    init = rng.normal(size=(5,))
    ja, jb = jax_scan.affine_scan(jnp.asarray(a), jnp.asarray(b), axis=0)
    pa, pb = port_scan.affine_scan(_t(a), _t(b), axis=0)
    assert _relerr(pa.numpy(), ja) < TOL and _relerr(pb.numpy(), jb) < TOL
    jc = jax_scan.apply_prefix(ja.T, jb.T, jnp.asarray(init))
    pc = port_scan.apply_prefix(pa.T, pb.T, _t(init))
    assert _relerr(pc.numpy(), jc) < TOL


# -- ops/sweep.py --------------------------------------------------------------

def _half_inputs(seed, Mh=2, G=3, N=11):
    rng = np.random.default_rng(seed)
    arrays = dict(
        e=rng.uniform(0.5, 2.0, (Mh, G, N, 2)),
        p=rng.uniform(0.5, 2.0, (Mh, G, N, 2)),
        h=rng.uniform(0.5, 2.0, (Mh, G, N, 2)),
        S=rng.uniform(0.0, 1e-2, (Mh, G, N)),
        absmu=rng.uniform(0.1, 1.0, (Mh,)),
        rhokap=rng.uniform(0.1, 10.0, (G,)),
        bc=rng.uniform(0.5, 2.0, (Mh, G)))
    fills = dict(prev_fill=rng.uniform(0.5, 2.0, (Mh, G)),
                 half_fill=rng.uniform(0.5, 2.0, (Mh, G)))
    return arrays, fills


@pytest.mark.parametrize("kind", [1, 2, 3])
def test_build_coeffs_and_sweep_match_jax(kind):
    arrays, fills = _half_inputs(kind)
    dx, ts, dt = 0.01, 5e-6, 1e-5
    j = {k: jnp.asarray(v) for k, v in {**arrays, **fills}.items()}
    p = {k: _t(v) for k, v in {**arrays, **fills}.items()}
    jc = jax_sweep.build_coeffs(kind, *(j[k] for k in arrays), dx, ts, dt,
                                prev_fill=j["prev_fill"],
                                half_fill=j["half_fill"])
    pc = port_sweep.build_coeffs(kind, *(p[k] for k in arrays), dx, ts, dt,
                                 prev_fill=p["prev_fill"],
                                 half_fill=p["half_fill"])
    for name in ("w", "T0", "r0"):
        assert _relerr(getattr(pc, name).numpy(), getattr(jc, name)) < TOL
    js = jax_sweep.sweep_oriented(kind, *(j[k] for k in arrays), dx, ts, dt)
    ps = port_sweep.sweep_oriented(kind, *(p[k] for k in arrays), dx, ts,
                                   dt)
    assert _relerr(ps.numpy(), js) < TOL
    e = jnp.asarray(arrays["e"])
    assert np.array_equal(port_sweep.orient_ends(_t(e)).numpy(),
                          np.asarray(jax_sweep.orient_ends(e)))


# -- models/transport.py: sub-steps and steps ------------------------------------

BCS = {"reflective": (2, 1), "source": (1, 1), "vacuum": (0, 0)}


def _small(cls, left, right, use_correction, **over):
    """A small off-equilibrium slab, asymmetric in direction and group
    (M = 4 makes the reflective direction reversal visible)."""
    kw = dict(M=4, G=2, N=12, X=0.6, efirst=0.1, elast=10.0, rho=1.3,
              kappa_grey=0.8, T=1.0, V=3.0, dt=2e-4, max_timesteps=3,
              bc_left_indicator=left, bc_right_indicator=right,
              psi_source=((1.5, 0.3), (0.7, 2.2), (1.1, 0.9), (0.4, 1.8)),
              use_correction=use_correction, include_validation=False)
    kw.update(over)
    return cls(**kw)


def _pair(left, right, use_correction, **over):
    """(JAX cfg, JAX tables, port cfg, port tables on the CPU as tensors,
    port host tables)."""
    jcfg = _small(JaxConfig, left, right, use_correction, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    host = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    pcfg = _small(PortConfig, left, right, use_correction, **over)
    return (jcfg, jt, pcfg, port_transport.device_tables(host, F64, "cpu"),
            host)


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.M, cfg.G, cfg.N, 2)
    return [rng.uniform(0.5, 2.5, shape) for _ in range(3)]


def _oracle(cfg, host, ends, prev, half):
    orc = Oracle(
        M=cfg.M, G=cfg.G, N=cfg.N, dx=cfg.dx, dt=cfg.dt, mu=host.mu,
        wt=host.wt, rho=host.rho, kappa=host.kappa, B=host.B,
        psi_source=host.psi_source, bc_left=cfg.bc_left_indicator,
        bc_right=cfg.bc_right_indicator, use_correction=cfg.use_correction,
        cor1=host.cor1, cor2=host.cor2, cor3=host.cor3, beta=cfg.beta)
    orc.ends, orc.prev_ends, orc.half_ends = (x.copy()
                                              for x in (ends, prev, half))
    orc.psi = 0.5 * (orc.ends[..., 0] + orc.ends[..., 1])
    return orc


@pytest.mark.parametrize("use_correction", [False, True])
@pytest.mark.parametrize("bcs", list(BCS))
@pytest.mark.parametrize("kind", [1, 2, 3])
def test_substep_matches_jax_and_oracle(kind, bcs, use_correction):
    """One sub-step from a random state. The oracle is the reference's
    loop: the reflective left boundary reads the freshly swept mu<0 half
    with the direction order reversed, and a vacuum left boundary falls
    through to the source (solver.cpp:667-671)."""
    jcfg, jt, pcfg, pt, host = _pair(*BCS[bcs], use_correction)
    arrays = _state(pcfg, 10 * kind + len(bcs))
    ts = pcfg.dt / 2.0
    want = jax_transport.substep(kind, jcfg, jt,
                                 *(jnp.asarray(x) for x in arrays), ts)
    got = port_transport.substep(kind, pcfg, pt, *(_t(x) for x in arrays),
                                 ts)
    assert _relerr(got.numpy(), want) < TOL
    orc = _oracle(pcfg, host, *arrays)
    orc.compute_correction()
    orc.sweep({1: orc.backward_euler, 2: orc.crank_nicolson,
               3: orc.bdf}[kind], ts)
    assert _relerr(got.numpy(), orc.ends) < ORACLE_TOL
    if bcs == "vacuum":
        # The mu>0 inflow is psi_source, not zero: the same sub-step with
        # the source boundary gives the same mu>0 half.
        _, _, scfg, spt, _ = _pair(1, 0, use_correction)
        src = port_transport.substep(kind, scfg, spt,
                                     *(_t(x) for x in arrays), ts)
        assert torch.equal(src[pcfg.M // 2:], got[pcfg.M // 2:])


@pytest.mark.parametrize("ts_method,symmetric", [(1, False), (2, False),
                                                 (3, False), (3, True)])
def test_step_matches_jax(ts_method, symmetric):
    jcfg, jt, pcfg, pt, host = _pair(2, 1, True, ts_method=ts_method,
                                     bdf2_symmetric_half=symmetric)
    arrays = _state(pcfg, ts_method + 5 * symmetric)
    want = jax_transport.make_step_fn(jcfg, jt)(
        jax_transport.State(*(jnp.asarray(x) for x in arrays)))
    got = port_transport.make_step_fn(pcfg, host, device="cpu")(
        port_transport.State(*(_t(x) for x in arrays)))
    for g, w in zip(got, want):
        assert _relerr(g.numpy(), w) < TOL


@pytest.mark.parametrize("ts_method", [1, 2])
def test_step_commits_prev_every_step(ts_method):
    """BE and CN commit prev_ends <- ends every step (solver.cpp:620-625)
    and pass half_ends through."""
    _, _, pcfg, pt, host = _pair(1, 1, False, ts_method=ts_method)
    st = port_transport.State(*(_t(x) for x in _state(pcfg, 3)))
    out = port_transport.make_step_fn(pcfg, host, device="cpu")(st)
    assert out.prev_ends is st.ends and out.half_ends is st.half_ends
    out2 = port_transport.make_step_fn(pcfg, host, device="cpu")(out)
    assert out2.prev_ends is out.ends


@pytest.mark.parametrize("symmetric", [False, True])
def test_bdf2_half_snapshot(symmetric):
    """The BDF2 half snapshot: mu<0 from the CN corrector; mu>0 from the
    phase-0 BE predictor (the reference's quirk, docs/QUIRKS.md) unless
    bdf2_symmetric_half."""
    _, _, pcfg, pt, host = _pair(2, 1, True, bdf2_symmetric_half=symmetric)
    st = port_transport.State(*(_t(x) for x in _state(pcfg, 4)))
    half_dt, Mh = pcfg.dt / 2.0, pcfg.M // 2
    e1 = port_transport.substep(1, pcfg, pt, st.ends, st.ends, st.half_ends,
                                half_dt)
    e2 = port_transport.substep(2, pcfg, pt, e1, st.ends, st.half_ends,
                                half_dt)
    out = port_transport.make_step_fn(pcfg, host, device="cpu")(st)
    assert torch.equal(out.half_ends[:Mh], e2[:Mh])
    assert torch.equal(out.half_ends[Mh:], (e2 if symmetric else e1)[Mh:])
    assert not torch.equal(e1[Mh:], e2[Mh:])


# -- whole solves, the CLI ----------------------------------------------------------

def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_cli_runs(tmp_path_factory):
    """The JAX CLI's --engine general run of a deck: (its CSV directory,
    the SolveResult its run_problem returned), once per (deck, dtype)."""
    tmp = tmp_path_factory.mktemp("jax_general")
    runs = {}

    def run(name, dtype="float64"):
        if (name, dtype) not in runs:
            deck, steps = DECKS[name]
            outdir = tmp / f"{name}-{dtype}"
            seen = []
            real = jax_transport.run_problem

            def capture(*args, **kw):
                seen.append(real(*args, **kw))
                return seen[-1]

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax, "jit", _jit_opt_off_f64 if dtype == "float64"
                           else _jit_opt_off)
                mp.setattr(jax_transport, "run_problem", capture)
                rc, _ = _run_cli(jax_cli.main, [
                    deck, "--engine", "general", "--steps", str(steps),
                    "--dtype", dtype, "--outdir", str(outdir)])
            assert rc == 0 and len(seen) == 1
            runs[name, dtype] = (outdir, seen[0])
        return runs[name, dtype]

    return run


def _csv_errs(got_dir, ref_dir):
    phi_scale = np.max(np.abs(np.loadtxt(ref_dir / "phi.csv")))
    errs = {}
    for name in CSVS:
        got = np.loadtxt(got_dir / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(ref_dir / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), name
        # F = sum_m mu_m w_m psi_m cancels near equilibrium: phi bounds it.
        errs[name] = _relerr(got, ref, phi_scale if name == "F" else None)
    return errs


@pytest.mark.parametrize("name", list(DECKS))
def test_solve_matches_jax_and_oracle(jax_cli_runs, name):
    deck, steps = DECKS[name]
    _, jres = jax_cli_runs(name)
    cfg = port.load_config(deck, max_timesteps=steps)
    tables, _, _ = port_transport.build_tables(cfg)
    st = port_transport.solve(cfg, tables,
                              port_transport.initial_state(cfg, tables),
                              device="cpu")
    scale = np.max(np.abs(np.asarray(jres.state.ends)))
    for g, w in zip(st, jres.state):
        assert _relerr(g.numpy(), w, scale) < TOL
    orc = _oracle(cfg, tables, *(np.asarray(x) for x in
                                 port_transport.initial_state(cfg, tables)))
    orc.run(cfg.ts_method, steps)
    assert _relerr(st.ends.numpy(), orc.ends) < ORACLE_TOL


@pytest.mark.parametrize("name,dtype", [("gray", "float64"),
                                        ("mg", "float64"),
                                        ("llnl", "float64"),
                                        ("gray", "float32")])
def test_cli_default_engine_matches_jax_cli(jax_cli_runs, tmp_path, name,
                                            dtype):
    """The CLI without --engine runs the general engine, as JAX's does."""
    deck, steps = DECKS[name]
    jdir, _ = jax_cli_runs(name, dtype)
    rc, out = _run_cli(port_cli.main, [
        deck, "--steps", str(steps), "--dtype", dtype, "--device", "cpu",
        "--outdir", str(tmp_path), "--profile"])
    assert rc == 0, out
    assert "wrote 8 CSVs" in out and "M updates/s) on cpu" in out
    bar = TOL if dtype == "float64" else 1e-5
    errs = _csv_errs(tmp_path, jdir)
    assert max(errs.values()) < bar, errs


@pytest.mark.parametrize("name,over", [
    ("gray", {}), ("mg", {}), ("llnl", {}),
    ("gray", dict(ts_method=1)), ("gray", dict(ts_method=2))])
def test_df_engine_matches_general(name, over):
    deck, steps = DECKS[name]
    cfg = port.load_config(deck, max_timesteps=steps, **over)
    gen = port_transport.run_problem(cfg, device="cpu")
    df = port_transport.run_problem(cfg, engine="df", device="cpu")
    assert _relerr(df.psi.numpy(), gen.psi.numpy()) < 1e-10
    assert _relerr(df.phi.numpy(), gen.phi.numpy()) < 1e-10


def test_entry_points_need_a_card_and_refuse_engines():
    """Every entry point defaults to the card and raises without one;
    run_problem has JAX's engines (fast: tests/test_torch_fast.py) and
    refuses others."""
    cfg = port.load_config(GRAY, N=8, max_timesteps=1)
    tables, _, _ = port_transport.build_tables(cfg)
    fast = port_transport.run_problem(cfg, engine="fast", device="cpu")
    gen = port_transport.run_problem(cfg, device="cpu")
    assert _relerr(fast.psi.numpy(), gen.psi.numpy()) < TOL
    with pytest.raises(ValueError, match="unknown engine"):
        port_transport.run_problem(cfg, engine="halo", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs there")
    st = port_transport.initial_state(cfg, tables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_transport.run_problem(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_transport.solve(cfg, tables, st)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_transport.make_step_fn(cfg, tables)


# -- the general engine on a mesh -------------------------------------------------

MESH_CASES = {
    # name: (deck, mesh "GxX", overrides)
    "gray-bdf2-refl-1x2": (GRAY, "1x2", dict(psi_source=((2.0,), (2.0,)))),
    "gray-be-vacuum-1x2": (GRAY, "1x2", dict(ts_method=1,
                                             bc_left_indicator=0,
                                             bc_right_indicator=0)),
    "mg-cn-1x2": (MG, "1x2", dict(ts_method=2)),
    "mg-bdf2-2x1": (MG, "2x1", {}),
    "mg-bdf2-sym-2x1": (MG, "2x1", dict(bdf2_symmetric_half=True)),
}
MESH_STEPS = 6

MESH_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import radiative_transfer_tpu_torch as port
    from radiative_transfer_tpu_torch import cli
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed, sharded
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod
    out_path, outdir, deck = sys.argv[1:4]
    cases, steps = eval(sys.argv[4]), int(sys.argv[5])
    distributed.initialize(device_type="cpu")
    out = {}
    for name, (path, shape, over) in cases.items():
        ng, nx = (int(v) for v in shape.split("x"))
        m = (mesh_mod.make_mesh_2d(ng, nx) if ng > 1
             else mesh_mod.make_mesh_1d(nx))
        cfg = port.load_config(path, **over)
        tables, _, _ = transport.build_tables(cfg)
        st = sharded.solve_sharded(cfg, tables,
                                   transport.initial_state(cfg, tables), m,
                                   num_steps=steps, device="cpu")
        out[name] = np.stack([x.numpy() for x in st])
    rc = cli.main([deck, "--outdir", outdir, "--engine", "general",
                   "--mesh", "1x2", "--device", "cpu", "--steps", "5"])
    assert rc == 0, rc
    if distributed.process_index() == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Rank 0's results of every case, and the CLI under the same two
    ranks: one launch."""
    tmp = tmp_path_factory.mktemp("general_mesh")
    runs = launch_local(["-c", MESH_WORKER, str(tmp / "ranks.npz"),
                         str(tmp / "mesh"), GRAY, repr(MESH_CASES),
                         str(MESH_STEPS)], 2, cwd=REPO, timeout=240)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    return tmp, dict(np.load(tmp / "ranks.npz")), runs[0].stdout


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_solve_sharded_matches_one_device(mesh_runs, name):
    """Each mesh case against the port's one-device solve and against the
    JAX package's transport.solve from the same initial state."""
    _, ranks, _ = mesh_runs
    path, _, over = MESH_CASES[name]
    cfg = port.load_config(path, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    want = port_transport.solve(cfg, tables,
                                port_transport.initial_state(cfg, tables),
                                MESH_STEPS, device="cpu")
    jcfg = jax_rt.load_config(path, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64)
        jwant = jax_transport.solve(jcfg, jt,
                                    jax_transport.initial_state(jcfg, jt),
                                    MESH_STEPS)
    for g, w, jw in zip(ranks[name], want, jwant):   # ends, prev, half
        assert _relerr(g, w.numpy()) < TOL
        assert _relerr(g, np.asarray(jw)) < TOL


def test_cli_general_mesh_1x2_matches_one_device(mesh_runs, tmp_path):
    tmp, _, out0 = mesh_runs
    assert "distributed: backend gloo (CPU tensors); rank 0 of 2" in out0
    assert "wrote 8 CSVs" in out0
    rc, _ = _run_cli(port_cli.main, [GRAY, "--outdir", str(tmp_path),
                                     "--device", "cpu", "--steps", "5"])
    assert rc == 0
    errs = _csv_errs(tmp / "mesh", tmp_path)
    assert max(errs.values()) < TOL, errs
