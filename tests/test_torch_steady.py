"""The port's direct steady-state solves (steady.py) against the JAX
package's (radiative_transfer_tpu/steady.py), on the cases of JAX's
tests/test_steady.py.

Both run on their FastEngine (the port's in plain PyTorch on the CPU). For
each case the port's ends (``solve_steady``, ``solve_steady_cycle``,
``run_steady_problem``) are held within 1e-12 (relative to the largest
magnitude) of JAX's at float64 and 1e-5 at float32; ``direct``'s sweep
count equals JAX's, ``cycle``'s matvec count (GMRES on the host in both,
over roundoff-different matvecs) is printed and within 2 of JAX's. The
port's own contracts are JAX's: the BE/CN fixed point (marching from it
moves nothing), the correction's short fixed-point iteration, one sweep
without it, the Planckian at an equilibrium source, cycle = direct at
BE/CN, cycle the exact BDF2 fixed point and its bias against direct
(docs/QUIRKS.md #16, replicated), the LLNL deck, a padded N (FastEngine
pads N = 100 to whole chunks; a reflective deck reads its outflow at the
last real cell) beside an unpadded one. The CLI's ``--steady`` and
``--steady --steady-method cycle`` write 8 CSVs within 1e-12 of the JAX
CLI's, and each of JAX's refusals exits 2 with JAX's message.

JAX's programs compile with XLA's backend optimisation off
(test_torch_general._jit_opt_off; the float64 ones also with its older
CPU emitters, _jit_opt_off_f64); each JAX solve runs once per module
(the JAX CLI's own steady solve of a shipped deck is that call's).
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import functools
import io
import os

import jax
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu import steady as jax_steady
from radiative_transfer_tpu.models import transport as jax_transport

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import steady as port_steady
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs

from test_torch_general import _jit_opt_off, _jit_opt_off_f64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")
F64, F32 = torch.float64, torch.float32
TOL = {F64: 1e-12, F32: 1e-5}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _key(over):
    return tuple(sorted(over.items()))


@functools.lru_cache(maxsize=None)
def _jax(method, deck, over, dtype="float64"):
    """JAX's solve_steady / solve_steady_cycle: (ends, iterations,
    residual), once per module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64 if dtype == "float64"
                   else _jit_opt_off)
        cfg = jax_load_config(deck, **dict(over))
        tables, _, _ = jax_transport.build_tables(cfg)
        fn = {"direct": jax_steady.solve_steady,
              "cycle": jax_steady.solve_steady_cycle}[method]
        sr = fn(cfg, tables, dtype=getattr(jax.numpy, dtype))
        return np.asarray(sr.ends), sr.iterations, sr.residual


@functools.lru_cache(maxsize=None)
def _port(method, deck, over, dtype=F64):
    cfg = port.load_config(deck, **dict(over))
    tables, _, _ = port_transport.build_tables(cfg)
    fn = {"direct": port_steady.solve_steady,
          "cycle": port_steady.solve_steady_cycle}[method]
    sr = fn(cfg, tables, dtype=dtype, device="cpu")
    assert sr.ends.dtype == F64 and sr.ends.device.type == "cpu"
    assert sr.ends.shape == (cfg.M, cfg.G, cfg.N, 2)
    return sr.ends.numpy(), sr.iterations, sr.residual


def _held(method, deck, over, dtype=F64):
    """The port's (ends, iterations, residual), held to JAX's."""
    got = _port(method, deck, over, dtype)
    want = _jax(method, deck, over, str(dtype).split(".")[-1])
    err = _rel(got[0], want[0])
    unit = "matvecs" if method == "cycle" else "sweeps"
    print(f"{method} {os.path.basename(deck)} {dict(over)} {dtype}: port "
          f"{got[1]} vs JAX {want[1]} {unit}, residual {got[2]:.3e} vs "
          f"{want[2]:.3e}, ends {err:.2e}")
    assert np.all(np.isfinite(got[0]))
    assert err < TOL[dtype], err
    if method == "direct":
        assert got[1] == want[1]
    else:
        assert abs(got[1] - want[1]) <= 2
    return got


def _march_from(deck, over, ends, steps):
    cfg = port.load_config(deck, **dict(over))
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, device="cpu")
    e = torch.as_tensor(ends)
    st = eng.from_ends(e, e, e)
    return eng.ends(eng.solve(st, num_steps=steps)).numpy()


# -- solve_steady -------------------------------------------------------------

@pytest.mark.parametrize("deck", [GRAY, MG])
@pytest.mark.parametrize("ts", [1, 2])
def test_steady_is_exact_be_cn_fixed_point(deck, ts):
    over = _key(dict(ts_method=ts))
    ends, _, _ = _held("direct", deck, over)
    assert _rel(_march_from(deck, over, ends, 50), ends) < 1e-13


def test_be_march_converges_to_steady():
    """BE is L-stable: a few huge-dt steps land on the fixed point."""
    over = _key(dict(ts_method=1, dt=1.0))
    ends, _, _ = _held("direct", GRAY, over)
    cfg = port.load_config(GRAY, **dict(over))
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, device="cpu")
    assert _rel(eng.ends(eng.solve(num_steps=60)).numpy(), ends) < 1e-13


def test_correction_fixed_point_iteration_converges():
    over = _key(dict(ts_method=1, dt=1.0))
    assert port.load_config(MG).use_correction
    ends, iters, res = _held("direct", MG, over)
    assert 1 < iters <= 20 and res < 1e-13      # an O(beta) contraction
    assert _rel(_march_from(MG, over, ends, 80), ends) < 1e-13


def test_no_correction_single_sweep():
    ends, iters, _ = _held("direct", MG, _key(dict(use_correction=False)))
    assert iters == 1


@pytest.mark.parametrize("dtype", [F64, F32])
def test_exact_equilibrium_source_gives_planckian(dtype):
    """psi_source = B_g exactly: the steady state is B_g everywhere and
    the flux vanishes (the GrayTest invariant without the march)."""
    cfg0 = port.load_config(GRAY)
    B = port_transport.build_tables(cfg0)[0].B
    src = tuple(tuple(float(B[g]) for g in range(cfg0.G))
                for _ in range(cfg0.M))
    cfg = port.load_config(GRAY, psi_source=src)
    res, sr = port_steady.run_steady_problem(cfg, dtype=dtype, device="cpu")
    ends = sr.ends.numpy()
    bar = TOL[dtype]
    assert _rel(ends, B[None, :, None, None] * np.ones_like(ends)) < bar
    assert np.max(np.abs(res.F.numpy())) < (1e-10 if dtype == F64 else 1e-4)
    jcfg = jax_load_config(GRAY, psi_source=src)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64 if dtype == F64
                   else _jit_opt_off)
        jres, jsr = jax_steady.run_steady_problem(
            jcfg, dtype=jax.numpy.float64 if dtype == F64
            else jax.numpy.float32)
    assert sr.iterations == jsr.iterations
    assert _rel(ends, np.asarray(jsr.ends)) < TOL[dtype]
    assert _rel(res.phi.numpy(), np.asarray(jres.phi)) < TOL[dtype]


def test_run_steady_problem_diagnostics():
    cfg = port.load_config(GRAY)
    res, sr = port_steady.run_steady_problem(cfg, device="cpu")
    assert res.psi.shape == (2, 1, 100)
    assert res.F.shape == (1, 100)
    assert np.all(np.isfinite(res.balance.numpy()))
    # The near-equilibrium gray deck's steady state stays near B.
    assert float(np.max(np.abs(res.F.numpy()))) < 1e-4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64)
        jres, jsr = jax_steady.run_steady_problem(jax_load_config(GRAY))
    assert sr.iterations == jsr.iterations
    for name in ("psi", "phi", "phi_plus", "left_ends", "right_ends",
                 "balance"):
        assert _rel(getattr(res, name).numpy(),
                    np.asarray(getattr(jres, name))) < 1e-12, name
    # F cancels to roundoff near equilibrium: phi bounds it.
    scale = np.max(np.abs(np.asarray(jres.phi)))
    assert np.max(np.abs(res.F.numpy() - np.asarray(jres.F))) / scale < 1e-12


def test_run_steady_problem_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown steady method"):
        port_steady.run_steady_problem(port.load_config(GRAY), method="newton",
                                       device="cpu")


def test_build_steady_coeffs_bit_equal_jax():
    for deck in (GRAY, MG, LLNL):
        cfg = port.load_config(deck)
        tables, _, _ = port_transport.build_tables(cfg)
        jcfg = jax_load_config(deck)
        jtables, _, _ = jax_transport.build_tables(jcfg)
        got = port_steady.build_steady_coeffs(cfg, tables)
        want = jax_steady.build_steady_coeffs(jcfg, jtables)
        for name, g, w in zip(got._fields, got, want):
            if isinstance(w, float):
                assert g == w, name
            else:
                assert g.dtype == np.float64, name
                np.testing.assert_array_equal(g, np.asarray(w), name)
        got32 = port_steady.build_steady_coeffs(cfg, tables, dtype=F32)
        want32 = jax_steady.build_steady_coeffs(jcfg, jtables,
                                                dtype=jax.numpy.float32)
        np.testing.assert_array_equal(got32.a, np.asarray(want32.a))
        assert got32.a.dtype == np.float32


# -- solve_steady_cycle -------------------------------------------------------

@pytest.mark.parametrize("ts", [1, 2])
def test_cycle_equals_direct_for_be_cn(ts):
    over = _key(dict(ts_method=ts))
    direct, _, _ = _held("direct", MG, over)
    cycle, _, _ = _held("cycle", MG, over)
    assert _rel(cycle, direct) < 1e-12


def test_cycle_is_exact_bdf2_fixed_point():
    cfg = port.load_config(MG)
    assert cfg.ts_method == 3
    ends, _, res = _held("cycle", MG, ())
    assert res < 1e-10
    assert _rel(_march_from(MG, (), ends, 200), ends) < 1e-10


def test_bdf2_cycle_bias_quirk():
    """QUIRKS #16: the BDF2 predictor-corrector fixed point is not the
    spatial scheme's steady state; on this deck the bias is ~6.4e-4, and
    neither dt nor dx moves it. Replicated, not corrected."""
    direct, _, _ = _held("direct", MG, ())
    cycle, _, _ = _held("cycle", MG, ())
    gap = _rel(cycle, direct)
    assert 1e-4 < gap < 3e-3
    jgap = _rel(_jax("cycle", MG, ())[0], _jax("direct", MG, ())[0])
    assert abs(gap - jgap) < 1e-9 * jgap / gap + 1e-10
    cfg = port.load_config(MG)
    cfg2 = port.load_config(MG, dt=cfg.dt / 4)
    tables, _, _ = port_transport.build_tables(cfg2)
    b2 = port_steady.solve_steady_cycle(cfg2, tables, device="cpu")
    assert abs(_rel(b2.ends.numpy(), direct) - gap) < 0.1 * gap


def test_llnl_steady_small():
    """The shipped LLNL deck shape (N = 50, kappa over [2e-2, 1e6]: the
    optically thick groups take the a -> 0 underflow path); marched BE
    with a large dt agrees."""
    over = _key(dict(ts_method=1, dt=1.0, max_timesteps=120))
    ends, _, _ = _held("direct", LLNL, over)
    cfg = port.load_config(LLNL, **dict(over))
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, device="cpu")
    assert _rel(eng.ends(eng.solve(num_steps=120)).numpy(), ends) < 1e-12
    _held("cycle", LLNL, over)


@pytest.mark.parametrize("N,reflective", [(100, True), (100, False),
                                          (101, True), (128, True)])
def test_padded_and_unpadded_n(N, reflective):
    """FastEngine pads N = 100 and 101 to whole chunks (the reflective
    outflow read at the last real cell through FastEngine.substep's
    scan=); N = 128 splits into whole chunks."""
    over = _key(dict(N=N, ts_method=1, bc_left_indicator=2 if reflective
                     else 1))
    cfg = port.load_config(GRAY, **dict(over))
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, device="cpu")
    assert (eng.pad > 0) == (N != 128)
    ends, _, _ = _held("direct", GRAY, over)
    assert _rel(_march_from(GRAY, over, ends, 30), ends) < 1e-13
    if N == 100 and reflective:
        _held("cycle", GRAY, over)


@pytest.mark.parametrize("method,deck", [("direct", MG), ("cycle", GRAY)])
def test_float32(method, deck):
    over = _key(dict(ts_method=1))
    got = _held(method, deck, over, F32)
    assert got[2] < (50 * torch.finfo(F32).eps if method == "direct"
                     else 1e-4)


# -- the CLI ------------------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:       # argparse's refusals
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("deck", [GRAY, MG])
@pytest.mark.parametrize("method", ["direct", "cycle"])
def test_cli_steady_matches_jax(tmp_path, deck, method):
    args = [deck, "--steady", "--steady-method", method]
    rc, out, err = _run(port_cli.main, args + [
        "--outdir", str(tmp_path / "pt"), "--device", "cpu", "--profile"])
    assert rc == 0, err
    # The JAX CLI end to end, its steady solve (the deck as shipped, the
    # call _jax made for this module) taken from _jax.
    want = _jax(method, deck, ())
    jcfg = jax_load_config(deck)

    def cached(cfg, tables, dtype, tol=None, **kw):
        assert cfg == jcfg and dtype == jax.numpy.float64 and tol is None
        return jax_steady.SteadyResult(jax.numpy.asarray(want[0]), *want[1:])

    name = {"direct": "solve_steady", "cycle": "solve_steady_cycle"}[method]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steady, name, cached)
        jrc, jout, _ = _run(jax_cli.main, args + ["--outdir",
                                                  str(tmp_path / "jx")])
    assert jrc == 0
    unit = "matvecs" if method == "cycle" else "sweeps"
    line = [ln for ln in out.splitlines() if ln.startswith("steady solve")]
    jline = [ln for ln in jout.splitlines() if ln.startswith("steady solve")]
    print(line, jline)
    assert len(line) == 1 and f"steady solve ({method}): " in line[0]
    assert f" {unit}, residual " in line[0]
    n, jn = (int(ln[0].split(": ")[1].split()[0]) for ln in (line, jline))
    assert (n == jn) if method == "direct" else abs(n - jn) <= 2
    assert "wrote 8 CSVs" in out and "updates/s) on cpu" in out
    phi_scale = np.max(np.abs(np.loadtxt(tmp_path / "jx" / "phi.csv")))
    for name in CSVS:
        got = np.loadtxt(tmp_path / "pt" / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(tmp_path / "jx" / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), name
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) / (scale + 1e-300) < 1e-12, name


@pytest.mark.parametrize("extra,message", [
    (["--steady-method", "cycle"], "--steady-method requires --steady"),
    (["--steady", "--checkpoint-dir", "ck"],
     "--steady does not support --checkpoint-dir"),
    (["--steady", "--balance-every", "2"],
     "--steady does not support --balance-every"),
    (["--steady", "--mesh", "1x2"], "--steady does not support --mesh"),
    (["--steady", "--ensemble-kappa", "k.txt"],
     "--steady does not support --ensemble-kappa"),
    (["--steady", "--steps", "3"], "--steady does not support --steps"),
    (["--steady", "--check"], "--steady does not support --check"),
    (["--steady", "--engine", "fast"], "--steady has a single "
     "implementation (the tiled f64/f32 sweep); drop --engine"),
])
def test_cli_steady_refusals_match_jax(tmp_path, extra, message):
    argv = [GRAY, "--outdir", str(tmp_path), *extra]
    rc, _, err = _run(port_cli.main, argv + ["--device", "cpu"])
    assert rc == 2 and message in err, err
    jrc, _, jerr = _run(jax_cli.main, argv)
    assert jrc == 2 and message in jerr
    assert not list(tmp_path.glob("*.csv"))
