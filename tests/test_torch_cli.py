"""The port's CLI end to end against the JAX package's CLI.

Both run ``--engine pallas`` on a shipped deck (the JAX kernels in
interpret mode, the port's plain versions with ``--device cpu``) and
write the reference's 8 CSVs, which must agree within 1e-5 of each
file's largest magnitude: f32 sweeps that differ only in rounding (see
tests/test_torch_sweep.py) over up to 20 steps, then float64
diagnostics. The LLNL deck runs its own 2 steps: at 20 steps the JAX
interpreter spends about a minute compiling its K=8 program for Bh=124.
The JAX CLI's programs there compile with XLA's backend optimisation off
(test_torch_general._jit_opt_off). The CSV writers themselves are
byte-identical for identical arrays.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)
from conftest import deck_edit

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.utils import io as jax_io

from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.utils import io as port_io

from test_torch_general import _jit_opt_off

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")


def _deck(name):
    return os.path.join(REPO, "prm", name)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("deck,steps", [("llnl_slab_test.prm", 2),
                                        ("single_group.prm", 20)])
def test_cli_csvs_match_jax(tmp_path, monkeypatch, deck, steps):
    monkeypatch.setattr(jax, "jit", _jit_opt_off)
    port_cs.reset_launch_counts()
    args = [_deck(deck), "--engine", "pallas", "--steps", str(steps)]
    rc, out = _run(port_cli.main, args + ["--outdir", str(tmp_path / "pt"),
                                          "--device", "cpu", "--profile"])
    assert rc == 0, out
    assert "wrote 8 CSVs" in out and "balance |sinks-sources|" in out
    assert "M updates/s) on cpu" in out
    # On the CPU the plain versions run; no kernel was launched.
    assert port_cs.bdf2_launch.launches == 0
    rc, jout = _run(jax_cli.main, args + ["--outdir", str(tmp_path / "jx")])
    assert rc == 0
    phi_scale = np.max(np.abs(np.loadtxt(tmp_path / "jx" / "phi.csv")))
    for name in CSVS:
        got = np.loadtxt(tmp_path / "pt" / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(tmp_path / "jx" / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape, name
        assert np.all(np.isfinite(got)), name
        # F = sum_m mu_m w_m psi_m cancels to roundoff noise at
        # equilibrium (single_group.prm starts there: max|F| ~ 1e-5 of
        # phi's 51), so its scale is phi, which bounds |F|.
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        err = np.max(np.abs(got - ref)) / (scale + 1e-300)
        assert err < 1e-5, (name, err)


def test_writers_byte_identical(tmp_path):
    """Identical arrays give byte-identical files (the JAX writers may
    take their native backend; it is byte-identical to Python's)."""
    cfg = jax_load_config(_deck("multi_group_equilibrium.prm"), N=9)
    jt, grid, _ = jax_transport.build_tables(cfg)
    rng = np.random.default_rng(5)
    ends = rng.uniform(0.1, 9.0, (cfg.M, cfg.G, cfg.N, 2))
    res = jax_transport.result_from_ends(cfg, jt, jnp.asarray(ends))
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    host = type("R", (), {k: np.asarray(v) for k, v in res._asdict().items()
                          if v is not None})
    jax_io.write_solution_csvs(str(tmp_path / "jx"), host, x, grid.e_ave)
    tensors = type("R", (), {k: torch.as_tensor(np.array(v))
                             for k, v in res._asdict().items()
                             if v is not None})
    port_io.write_solution_csvs(str(tmp_path / "pt"), tensors, x,
                                grid.e_ave)
    for name in CSVS:
        assert ((tmp_path / "pt" / f"{name}.csv").read_bytes()
                == (tmp_path / "jx" / f"{name}.csv").read_bytes()), name


@pytest.mark.parametrize("extra", [
    ["--steady", "--mesh", "1x2"],
    ["--engine", "fast", "--mesh", "1x2"],
    ["--engine", "df", "--mesh", "1x2"],
    ["--engine", "pallas", "--mesh", "1x2"],
    ["--ensemble-kappa", "kappas.txt"],
    ["--engine", "pallas", "--device", "tpu"],
    ["--balance-every", "2", "--checkpoint-dir", "ck"],
    ["--steady-method", "cycle"],
])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    """Exit 2 and no CSV: a steady solve on a mesh and a mesh of more
    ranks than run, an ensemble table that cannot be read, an unknown
    device, and the JAX CLI's flag hygiene (argparse errors)."""
    argv = [_deck("single_group.prm"), "--outdir", str(tmp_path), *extra]
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    try:
        rc = port_cli.main(argv)
    except SystemExit as exc:  # argparse refuses bad flags and choices
        rc = exc.code
    assert rc == 2
    assert not list(tmp_path.glob("*.csv"))


@pytest.mark.parametrize("extra,message", [
    (["--steady-method", "cycle"], "--steady-method requires --steady"),
    (["--steady", "--mesh", "1x2"], "--steady does not support --mesh"),
    (["--steady", "--engine", "fast"], "--steady has a single "
     "implementation")])
def test_cli_refusals_name_their_roadmap_item(tmp_path, capsys, extra,
                                              message):
    """The steady solve's refusals, in the JAX CLI's words (argparse
    errors, exit 2)."""
    try:
        rc = port_cli.main([_deck("single_group.prm"), "--outdir",
                            str(tmp_path), "--device", "cpu", *extra])
    except SystemExit as exc:
        rc = exc.code
    assert rc == 2
    assert message in capsys.readouterr().err


BAL_RE = re.compile(r"^step\s+(\d+): balance max=", re.M)


def _moving_deck(tmp_path, thick):
    """single_group.prm with a boundary source of 2.0 against B = 4.0931
    (the state moves), at N = 64 as JAX tests/test_cli_flags.py runs it,
    or thick (N = 2048, X = 20.48) where the halo engines' creep bound
    admits it."""
    text = deck_edit(open(_deck("single_group.prm")).read(),
                     "psi_source=4.0931 4.0931", "psi_source=2.0 2.0")
    for old, new in ([("N=100", "N=2048"), ("X=1.", "X=20.48")] if thick
                     else [("N=100", "N=64")]):
        text = deck_edit(text, old, new)
    path = tmp_path / ("thick.prm" if thick else "deck.prm")
    path.write_text(text)
    return str(path)


BALANCE_MODES = [
    (["--engine", "general"], False),
    (["--engine", "general", "--dtype", "float32"], False),
    (["--engine", "pallas", "--dtype", "float32"], False),
    (["--engine", "auto", "--dtype", "float32"], False),
    (["--engine", "df"], False),
    (["--engine", "auto"], True),
    (["--engine", "halo", "--dtype", "float32"], True),
    (["--engine", "fused", "--dtype", "float32"], False),
    (["--engine", "fast"], False),
]


@pytest.mark.parametrize("extra,thick", BALANCE_MODES,
                         ids=[" ".join(m[0]) for m in BALANCE_MODES])
def test_balance_every_prints_in_every_mode(tmp_path, extra, thick):
    """--balance-every streams the balance diagnostic on every engine (the
    mesh engines in tests/test_torch_checkpoint.py), one line a chunk,
    ragged last chunk included."""
    rc, out = _run(port_cli.main, [
        _moving_deck(tmp_path, thick), "--outdir", str(tmp_path),
        "--steps", "5", "--balance-every", "2", "--device", "cpu", *extra])
    assert rc == 0, out[-2000:]
    assert [int(n) for n in BAL_RE.findall(out)] == [2, 4, 5], out[-2000:]
    assert "wrote 8 CSVs" in out


def test_balance_every_matches_plain_run(tmp_path):
    """Chunking with the balance stream does not change the solution."""
    deck = _moving_deck(tmp_path, False)
    a, b = tmp_path / "a", tmp_path / "b"
    common = [deck, "--engine", "pallas", "--dtype", "float32", "--steps",
              "4", "--device", "cpu"]
    assert _run(port_cli.main, common + ["--outdir", str(a)])[0] == 0
    assert _run(port_cli.main, common + ["--outdir", str(b),
                                         "--balance-every", "1"])[0] == 0
    for name in CSVS:
        assert (a / f"{name}.csv").read_bytes() == (
            b / f"{name}.csv").read_bytes(), name


def test_cli_cuda_without_card_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs this path")
    rc = port_cli.main([_deck("single_group.prm"), "--outdir",
                        str(tmp_path), "--engine", "pallas"])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.csv"))


# -- --engine fast and --ensemble-kappa -------------------------------------------

def _run_jax(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off)
        return _run(jax_cli.main, argv)


def _csv_err(got_dir, ref_dir):
    """The largest error over the 8 CSVs, each against its own largest
    magnitude (F against max|phi|, which bounds it)."""
    phi = np.max(np.abs(np.loadtxt(os.path.join(ref_dir, "phi.csv"))))
    worst = 0.0
    for name in CSVS:
        got = np.loadtxt(os.path.join(got_dir, f"{name}.csv"), ndmin=2)
        ref = np.loadtxt(os.path.join(ref_dir, f"{name}.csv"), ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), name
        scale = phi if name == "F" else np.max(np.abs(ref))
        worst = max(worst, float(np.max(np.abs(got - ref)) / scale))
    return worst


@pytest.mark.parametrize("deck,steps", [("llnl_slab_test.prm", 2),
                                        (None, 20)])
def test_cli_fast_csvs_match_jax(tmp_path, deck, steps):
    """--engine fast at float64 against the JAX CLI's: 1e-12 (deck None:
    the moving single_group.prm at N = 64)."""
    path = _moving_deck(tmp_path, False) if deck is None else _deck(deck)
    args = [path, "--engine", "fast", "--steps", str(steps)]
    rc, out = _run(port_cli.main, args + ["--outdir", str(tmp_path / "pt"),
                                          "--device", "cpu"])
    assert rc == 0, out[-2000:]
    rc, jout = _run_jax(args + ["--outdir", str(tmp_path / "jx")])
    assert rc == 0, jout[-2000:]
    assert _csv_err(tmp_path / "pt", tmp_path / "jx") < 1e-12


def test_cli_fast_kill_and_resume_byte_equal(tmp_path):
    """--engine fast with --checkpoint-dir: killed at 4 (a checkpoint every
    2) and resumed to 6, byte-equal to 6 straight."""
    common = [_moving_deck(tmp_path, False), "--engine", "fast",
              "--device", "cpu"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
          "2"]
    assert _run(port_cli.main, common + ["--steps", "6", "--outdir",
                                         str(tmp_path / "a")])[0] == 0
    assert _run(port_cli.main, common + ck + [
        "--steps", "4", "--outdir", str(tmp_path / "killed")])[0] == 0
    rc, out = _run(port_cli.main, common + ck + [
        "--steps", "6", "--outdir", str(tmp_path / "b")])
    assert rc == 0 and "resumed from step 4" in out
    for name in CSVS:
        assert (tmp_path / "a" / f"{name}.csv").read_bytes() == (
            tmp_path / "b" / f"{name}.csv").read_bytes(), name


KAPPAS = "# three opacity members of G = 1\n0.5\n1.0\n1.7\n"


def _ensemble_files(tmp_path):
    (tmp_path / "kappas.txt").write_text(KAPPAS)
    return _moving_deck(tmp_path, False), str(tmp_path / "kappas.txt")


@pytest.mark.parametrize("engine", ["general", "fast"])
def test_cli_ensemble_matches_jax(tmp_path, engine):
    """--ensemble-kappa through the vmapped general solver and the stacked
    fast engine at float64: each member's 8 CSVs within 1e-12 of the JAX
    CLI's."""
    deck, kappas = _ensemble_files(tmp_path)
    args = [deck, "--engine", engine, "--steps", "5", "--ensemble-kappa",
            kappas]
    rc, out = _run(port_cli.main, args + ["--outdir", str(tmp_path / "pt"),
                                          "--device", "cpu", "--profile"])
    assert rc == 0, out[-2000:]
    assert "M updates/s aggregate) on cpu" in out
    assert "wrote 3 member output sets under" in out
    rc, jout = _run_jax(args + ["--outdir", str(tmp_path / "jx")])
    assert rc == 0, jout[-2000:]
    for k in range(3):
        sub = f"member_{k:03d}"
        assert f"member {k:3d}: balance max" in out
        assert _csv_err(tmp_path / "pt" / sub, tmp_path / "jx" / sub) < 1e-12


@pytest.mark.parametrize("engine,tol", [("pallas", 5e-5), ("auto", 5e-5),
                                        ("df", 1e-10)])
def test_cli_ensemble_kernel_engines(tmp_path, engine, tol):
    """--ensemble-kappa on the stacked kernels' plain versions (auto runs
    the float32 kernels at the default float64, as in JAX): every member's
    8 CSVs, within the engine's bar of the general ensemble's."""
    deck, kappas = _ensemble_files(tmp_path)
    common = [deck, "--steps", "5", "--ensemble-kappa", kappas, "--device",
              "cpu"]
    assert _run(port_cli.main, common + ["--outdir",
                                         str(tmp_path / "gen")])[0] == 0
    rc, out = _run(port_cli.main, common + ["--engine", engine, "--outdir",
                                            str(tmp_path / engine)])
    assert rc == 0, out[-2000:]
    for k in range(3):
        sub = f"member_{k:03d}"
        assert len(list((tmp_path / engine / sub).glob("*.csv"))) == 8
        assert _csv_err(tmp_path / engine / sub, tmp_path / "gen" / sub) < tol


@pytest.mark.parametrize("extra,message", [
    (["--checkpoint-dir", "ck"], "does not support --checkpoint-dir"),
    (["--balance-every", "2"], "does not support --balance-every"),
    (["--mesh", "1x2"], "does not support --mesh"),
    (["--check"], "does not support --check"),
    (["--engine", "halo"], "supports --engine general/fast/pallas/auto"),
    (["--engine", "fused"], "--ensemble-kappa supports engines"),
    (["--ensemble-kappa", "missing.txt"], "cannot read --ensemble-kappa"),
    (["--ensemble-kappa", "two_columns.txt"], "needs G=1 columns per row"),
])
def test_cli_ensemble_refusals(tmp_path, capsys, extra, message):
    """The JAX CLI's refusals with its words: exit 2, no CSV."""
    deck, kappas = _ensemble_files(tmp_path)
    (tmp_path / "two_columns.txt").write_text("1.0 2.0\n1.5 2.5\n")
    argv = [deck, "--outdir", str(tmp_path / "out"), "--device", "cpu",
            "--ensemble-kappa", kappas]
    for a in extra:
        argv.append(str(tmp_path / a) if a.endswith(".txt") else a)
    try:
        rc = port_cli.main(argv)
    except SystemExit as exc:  # argparse errors
        rc = exc.code
    assert rc == 2
    assert message in capsys.readouterr().err
    assert not list(tmp_path.rglob("*.csv"))
