"""The port's plot.py against the JAX package's, on the same CSVs.

The CSVs come from the port's general engine on the CPU (default.prm, 3
steps, float64), written by the port's writers (through its C++ library)
and, with a file prefix, by the JAX package's writers on their Python
path (``_native`` monkeypatched: the JAX package's own library is never
built here, see tests/test_torch_native.py).

* ``read_solution`` equals JAX's exactly, with and without ``prefix``;
* psi, phi and the other six arrays read back to the solver's result
  within rtol 1e-12 (``%.17g`` round-trips a double exactly);
* ``plot_solution`` makes the 5 figures, and ``main`` (the ``python -m
  radiative_transfer_tpu_torch.plot OUTDIR`` CLI) prints their 5 paths,
  also when run as the module's ``__main__``.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from radiative_transfer_tpu import plot as jax_plot
from radiative_transfer_tpu.utils import io as jax_io

from radiative_transfer_tpu_torch import load_config, native, plot
from radiative_transfer_tpu_torch.models import transport
from radiative_transfer_tpu_torch.utils import io as port_io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")
FIGURES = ("F", "phi", "phi_plus", "psi", "ends")


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """(outdir, the result's 8 arrays): port CSVs in outdir, the same
    arrays as JAX-written CSVs named with the prefix 'run_'."""
    cfg = load_config(os.path.join(REPO, "prm", "default.prm"),
                      max_timesteps=3)
    result = transport.run_problem(cfg, device="cpu")
    _, grid, _ = transport.build_tables(cfg)
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    e_ave = np.asarray(grid.e_ave)
    outdir = str(tmp_path_factory.mktemp("csvs"))
    native.reset_call_counts()
    port_io.write_solution_csvs(outdir, result, x, e_ave)
    assert native.call_counts()["write_psi"] == 1
    arrays = {k: getattr(result, k).numpy() for k in KEYS
              if k not in ("x", "e_ave")}
    arrays.update(x=x, e_ave=e_ave)
    host = type("R", (), arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_io, "_native", lambda: None)
        jax_io.write_solution_csvs(outdir, host, x, e_ave, prefix="run_")
    return outdir, arrays


@pytest.mark.parametrize("prefix", ["", "run_"])
def test_read_solution_matches_jax(solved, prefix):
    outdir, _ = solved
    got = plot.read_solution(outdir, prefix)
    ref = jax_plot.read_solution(outdir, prefix)
    assert sorted(got) == sorted(ref) == sorted(KEYS)
    for k in KEYS:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("prefix", ["", "run_"])
def test_read_solution_round_trips_the_result(solved, prefix):
    outdir, arrays = solved
    sol = plot.read_solution(outdir, prefix)
    assert sol["psi"].shape == arrays["psi"].shape == (2, 2, 100)
    for k in KEYS:
        np.testing.assert_allclose(sol[k], arrays[k].reshape(sol[k].shape),
                                   rtol=1e-12, atol=0, err_msg=k)


def test_plot_solution_makes_five_pngs(solved, tmp_path):
    pytest.importorskip("matplotlib")
    made = plot.plot_solution(plot.read_solution(solved[0]),
                              str(tmp_path / "figs"))
    assert [os.path.basename(p) for p in made] == [f + ".png"
                                                   for f in FIGURES]
    for p in made:
        assert os.path.getsize(p) > 0


def test_main_prints_the_five_paths(solved, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    save = str(tmp_path / "figs")
    assert plot.main([solved[0], "--prefix", "run_", "--save-dir",
                      save]) == 0
    printed = capsys.readouterr().out.split()
    assert printed == [os.path.join(save, f + ".png") for f in FIGURES]
    assert all(os.path.getsize(p) > 0 for p in printed)


def test_python_m_plot_writes_five_pngs(solved, tmp_path, monkeypatch,
                                       capsys):
    """``python -m radiative_transfer_tpu_torch.plot OUTDIR`` as a user
    runs it (the module's __main__ block, in this process): the PNGs land
    in OUTDIR."""
    pytest.importorskip("matplotlib")
    outdir = tmp_path / "out"
    outdir.mkdir()
    for k in KEYS:
        (outdir / f"{k}.csv").write_bytes(
            open(os.path.join(solved[0], f"{k}.csv"), "rb").read())
    monkeypatch.setattr(sys, "argv", [plot.__file__, str(outdir)])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(plot.__file__, run_name="__main__")
    assert done.value.code == 0
    assert capsys.readouterr().out.split() == [str(outdir / (f + ".png"))
                                               for f in FIGURES]
    assert all((outdir / (f + ".png")).stat().st_size > 0 for f in FIGURES)
