"""The port's leftovers of the JAX package (ROADMAP A15) against it.

* ``ops/correction.planck_mean_opacities`` bit-equal to JAX's on the cases
  of tests/test_diagnostics.py (the reference's emission normalisation,
  the LLNL deck's 124 groups), with JAX's checks.
* ``data/llnl_opacity``: the port's own copy of the 124-group tables equal
  to ``prm/llnl_slab_test_group_*.txt`` and to JAX's arrays, and
  ``write_tables`` round-tripping them.
* The package's lazy submodules (JAX ``__init__.py``'s ``__getattr__``):
  each resolves to the port's own module; ``plot`` and ``native``, which
  are not ported, raise AttributeError naming their ROADMAP items.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from radiative_transfer_tpu import constants as jax_constants
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.data import llnl_opacity as jax_llnl
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import correction as jax_corr

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.data import llnl_opacity as port_llnl
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import correction as port_corr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deck(name):
    return os.path.join(REPO, "prm", name)


# -- planck_mean_opacities ----------------------------------------------------

@pytest.mark.parametrize("deck,bar", [("multi_group_equilibrium.prm", 1e-10),
                                      ("llnl_slab_test.prm", 1e-8),
                                      ("single_group.prm", 1e-10)])
def test_planck_mean_opacities_bit_equal_jax(deck, bar):
    pcfg = port.load_config(_deck(deck))
    _, pgrid, pct = port_transport.build_tables(pcfg)
    got = port_corr.planck_mean_opacities(pcfg.T, pgrid.e_edge, pgrid.e_ave,
                                          pct.B, pcfg.kappa_grey)
    jcfg = jax_load_config(_deck(deck))
    _, jgrid, jct = jax_transport.build_tables(jcfg)
    want = jax_corr.planck_mean_opacities(jcfg.T, jgrid.e_edge, jgrid.e_ave,
                                          jct.B, jcfg.kappa_grey)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.float64
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    # JAX's own checks (tests/test_diagnostics.py): sum kappa_g B_g is the
    # grey emission, the 1/E^3 shape falls toward high energy.
    total = float(np.sum(got["kappa"] * pct.B))
    ac = port.constants.AC
    assert ac == jax_constants.AC
    assert abs(total - pcfg.kappa_grey * ac * pcfg.T ** 4) < bar
    assert np.all(got["kappa"] > 0) and np.all(np.isfinite(got["kappa"]))
    assert got["emission_spectrum"].shape == (pcfg.G,)
    if pcfg.G > 1:
        assert got["kappa"][0] > got["kappa"][-1]
    assert port_corr.validate_emission(got["kappa"], pct.B, pcfg.T,
                                       pcfg.kappa_grey)


# -- data/llnl_opacity --------------------------------------------------------

def test_llnl_tables_equal_shipped_files_and_jax():
    bounds = np.loadtxt(_deck("llnl_slab_test_group_bounds.txt"))
    kappa = np.loadtxt(_deck("llnl_slab_test_group_kappa_a.txt"))
    assert port_llnl.GROUP_BOUNDS.shape == (125,)
    assert port_llnl.GROUP_KAPPA_A.shape == (124,)
    assert port_llnl.NUM_GROUPS == 124
    np.testing.assert_array_equal(port_llnl.GROUP_BOUNDS, bounds)
    np.testing.assert_array_equal(port_llnl.GROUP_KAPPA_A, kappa)
    np.testing.assert_array_equal(port_llnl.GROUP_BOUNDS,
                                  jax_llnl.GROUP_BOUNDS)
    np.testing.assert_array_equal(port_llnl.GROUP_KAPPA_A,
                                  jax_llnl.GROUP_KAPPA_A)
    assert np.all(np.diff(port_llnl.GROUP_BOUNDS) > 0)


def test_llnl_tables_feed_the_deck():
    """The tables are the LLNL deck's: its config reads the same group
    bounds and opacities from the shipped files."""
    cfg = port.load_config(_deck("llnl_slab_test.prm"))
    assert cfg.G == port_llnl.NUM_GROUPS
    np.testing.assert_array_equal(cfg.group_bounds_array(),
                                  port_llnl.GROUP_BOUNDS)
    np.testing.assert_array_equal(cfg.group_kappa_array(),
                                  port_llnl.GROUP_KAPPA_A)


def test_write_tables_round_trip(tmp_path):
    bp, kp = port_llnl.write_tables(str(tmp_path / "p"))
    jb, jk = jax_llnl.write_tables(str(tmp_path / "j"))
    assert os.path.basename(bp) == os.path.basename(jb)
    assert os.path.basename(kp) == os.path.basename(jk)
    np.testing.assert_array_equal(np.loadtxt(bp), port_llnl.GROUP_BOUNDS)
    np.testing.assert_array_equal(np.loadtxt(kp), port_llnl.GROUP_KAPPA_A)
    # Byte-equal to the JAX writer's files.
    assert open(bp, "rb").read() == open(jb, "rb").read()
    assert open(kp, "rb").read() == open(jk, "rb").read()


def test_write_tables_as_a_script(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "radiative_transfer_tpu_torch.data"
         ".llnl_opacity", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "llnl_slab_test_group_kappa_a.txt"),
        port_llnl.GROUP_KAPPA_A)


def test_data_module_imports_no_jax():
    src = open(port_llnl.__file__).read()
    assert "import jax" not in src and "radiative_transfer_tpu." not in src


# -- the lazy submodules ------------------------------------------------------

LAZY = ("parallel", "ops", "utils", "cli", "adjoint", "ensemble", "data",
        "steady")


@pytest.mark.parametrize("name", LAZY)
def test_lazy_submodule_resolves_to_the_port(name):
    mod = getattr(port, name)
    assert mod is importlib.import_module(
        f"radiative_transfer_tpu_torch.{name}")
    assert mod.__name__ == f"radiative_transfer_tpu_torch.{name}"
    assert name in port.__all__


@pytest.mark.parametrize("name,item", [("plot", "A13"), ("native", "A14")])
def test_unported_modules_raise_naming_the_roadmap_item(name, item):
    with pytest.raises(AttributeError, match=f"ROADMAP {item}"):
        getattr(port, name)
    assert name not in port.__all__


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        port.nope  # noqa: B018


def test_all_names_resolve():
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert {"Config", "load_config", "constants", "transport"} <= set(
        port.__all__)
