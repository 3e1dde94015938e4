"""The port's CLI end to end against the JAX package's CLI.

Both run ``--engine pallas`` on a shipped deck (the JAX kernels in
interpret mode, the port's plain versions with ``--device cpu``) and
write the reference's 8 CSVs, which must agree within 1e-5 of each
file's largest magnitude: f32 sweeps that differ only in rounding (see
tests/test_torch_sweep.py) over up to 20 steps, then float64
diagnostics. The LLNL deck runs its own 2 steps: at 20 steps the JAX
interpreter spends about a minute compiling its K=8 program for Bh=124.
The CSV writers themselves are byte-identical for identical arrays.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)
from conftest import deck_edit

import contextlib
import io
import os
import re

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
def test_cli_csvs_match_jax(tmp_path, deck, steps):
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
    ["--steady"],
    ["--engine", "fast"],
    ["--engine", "df", "--mesh", "1x2"],
    ["--engine", "pallas", "--mesh", "1x2"],
    ["--ensemble-kappa", "kappas.txt"],
    ["--engine", "pallas", "--device", "tpu"],
    ["--balance-every", "2", "--checkpoint-dir", "ck"],
    ["--steady-method", "cycle"],
])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    """Exit 2 and no CSV: what is not ported yet (A7, A10), a mesh of more
    ranks than run, an unknown device, and the JAX CLI's flag hygiene
    (argparse errors)."""
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
    (["--steady"], "--steady is not ported yet (ROADMAP A7"),
    (["--engine", "fast"], "--engine fast is not ported yet (ROADMAP A7"),
    (["--ensemble-kappa", "kappas.txt"],
     "--ensemble-kappa is not ported yet (ROADMAP A10")])
def test_cli_refusals_name_their_roadmap_item(tmp_path, capsys, extra,
                                              message):
    rc = port_cli.main([_deck("single_group.prm"), "--outdir", str(tmp_path),
                        "--device", "cpu", *extra])
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
