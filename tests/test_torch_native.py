"""The port's native I/O (native.py, csrc/rtio.cc) against the Python paths.

Three backends must agree: the port's C++ library, the port's Python
paths (config/config.py, utils/io.py with the library masked off) and
the JAX package's Python paths. The JAX package's own library is never
built or called here: its ``native.available()`` runs ``make`` into the
JAX package's tree, which its own tests (tests/test_native.py) do, so
the JAX side is always held on its Python path (``prefer_native=False``,
or ``available``/``_native`` monkeypatched for one test, which changes
nothing on disk).

* every deck of prm/ parses to the same records; the grammar's quirks
  (CRLF, a lone CR, first-wins duplicates, '#' only at column 0, values
  untrimmed) and the table tokenizer's (a hex float or ``1_000`` stops a
  table; -0.0, 1e-300, 1e300 and subnormals read exactly) agree;
* the tables of prm/ read to the same values, and ``load_config`` gives
  equal Configs through both of the port's backends and JAX's;
* the three writers write byte-identical files at float64 and float32,
  from numpy arrays and from torch tensors;
* the build: two processes building into a fresh directory at once both
  load a whole library, a compiler error and an ABI mismatch raise
  RuntimeError, and with no compiler on PATH ``available()`` is False
  while the port's readers and writers take their Python paths;
* each entry point counts its calls into the library.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radiative_transfer_tpu import native as jax_native
from radiative_transfer_tpu.config import config as jax_config
from radiative_transfer_tpu.utils import io as jax_io

from radiative_transfer_tpu_torch import native
from radiative_transfer_tpu_torch.config import config as port_config
from radiative_transfer_tpu_torch.utils import io as port_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("default.prm", "single_group.prm", "multi_group_equilibrium.prm",
         "llnl_slab_test.prm", "template.prm")
TABLES = sorted(os.path.basename(p)
                for p in glob.glob(os.path.join(REPO, "prm", "*.txt")))


def _deck(name):
    return os.path.join(REPO, "prm", name)


@pytest.fixture
def jax_python(monkeypatch):
    """The JAX package's readers and writers on their Python paths."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_io, "_native", lambda: None)


# -- decks and tables ------------------------------------------------------------

def _three_parses(path):
    """(port native, port Python, JAX Python) records of one deck."""
    before = native.parse_deck.calls
    nat = port_config.PrmFile(path).params
    assert native.parse_deck.calls == before + 1
    assert native.parse_deck_dict(path) == nat
    return (nat, port_config.PrmFile(path, prefer_native=False).params,
            jax_config.PrmFile(path, prefer_native=False).params)


@pytest.mark.parametrize("deck", DECKS)
def test_deck_parse_matches_python(deck):
    nat, py, jx = _three_parses(_deck(deck))
    assert list(nat.items()) == list(py.items()) == list(jx.items())
    assert nat


QUIRKS = {
    "crlf": (b"a=1\r\nb=2\r\n", {"a": "1", "b": "2"}),
    "lone_cr": (b"a=1\rb=2\r\nc=3\n", {"a": "1", "b": "2", "c": "3"}),
    "cr_cr_lf": (b"a=1\r\r\nb=2", {"a": "1", "b": "2"}),
    "first_wins": (b"k=1\nk=2\n k=3\n", {"k": "1", " k": "3"}),
    "hash_at_column_0": (b"#a=1\n #b=2\nc=#3\n", {" #b": "2", "c": "#3"}),
    "untrimmed": (b"key = spaced value # tail \nempty=\n=novalue\nnoequals\n",
                  {"key ": " spaced value # tail ", "empty": "",
                   "": "novalue"}),
    "first_equals_splits": (b"a=b=c\n", {"a": "b=c"}),
    "tabs": (b"\tk\t=\tv\t\n", {"\tk\t": "\tv\t"}),
    "no_trailing_newline": (b"a=1\nb=2", {"a": "1", "b": "2"}),
    "empty": (b"", {}),
}


@pytest.mark.parametrize("case", QUIRKS)
def test_parse_quirks(tmp_path, case):
    text, want = QUIRKS[case]
    p = tmp_path / "q.prm"
    p.write_bytes(text)
    nat, py, jx = _three_parses(str(p))
    assert list(nat.items()) == list(py.items()) == list(jx.items())
    assert nat == want


TOKENS = {
    "hex_float_stops": ("1.5 0x1C 7\n", [1.5]),
    "upper_hex_stops": ("0X1p3 8\n", []),
    "digit_groups_stop": ("2.5 1_000 9\n", [2.5]),
    "bad_token_stops": ("1.5 2e3\n  -4.25 nope 7\n", [1.5, 2000.0, -4.25]),
    "partial_number_stops": ("1.5e 2\n", []),
    "signed_zero_and_extremes": ("-0.0 1e-300 1e300\n", [-0.0, 1e-300, 1e300]),
    "subnormal_and_max": ("4.9e-324 1.7976931348623157e308\n",
                          [5e-324, 1.7976931348623157e308]),
    "forms": ("+.5 5. .5e1 1E+02\n", [0.5, 5.0, 5.0, 100.0]),
    "whitespace": ("1\t2\r\n3\v4\f5", [1.0, 2.0, 3.0, 4.0, 5.0]),
    "empty": ("", []),
}


def _three_tables(path):
    before = native.read_table.calls
    nat = port_config._read_table(path)
    assert native.read_table.calls == before + 1
    return (nat, port_config._read_table(path, prefer_native=False),
            jax_config._read_table(path, prefer_native=False))


@pytest.mark.parametrize("case", TOKENS)
def test_tokenizer_edge_cases_agree(tmp_path, case):
    text, want = TOKENS[case]
    p = tmp_path / "t.txt"
    p.write_text(text)
    want = np.asarray(want, dtype=np.float64)
    for got in _three_tables(str(p)):
        assert got.dtype == np.float64
        assert got.tobytes() == want.tobytes(), (case, got)


@pytest.mark.parametrize("table", TABLES)
def test_table_read_matches_python(table):
    nat, py, jx = _three_tables(_deck(table))
    assert nat.size > 0
    assert nat.tobytes() == py.tobytes() == jx.tobytes()
    np.testing.assert_array_equal(nat, np.loadtxt(_deck(table)).reshape(-1))


@pytest.mark.parametrize("deck", DECKS)
def test_load_config_same_through_every_backend(deck, monkeypatch,
                                                jax_python):
    native.reset_call_counts()
    nat = dataclasses.asdict(port_config.load_config(_deck(deck)))
    assert native.call_counts()["parse_deck"] == 1
    jx = dataclasses.asdict(jax_config.load_config(_deck(deck)))
    monkeypatch.setattr(native, "available", lambda: False)
    native.reset_call_counts()
    py = dataclasses.asdict(port_config.load_config(_deck(deck)))
    assert not any(native.call_counts().values())
    assert nat == py == jx


# -- writers ----------------------------------------------------------------------

SPECIALS = {
    np.float64: (0.0, -0.0, 1e-300, 1e300, 5e-324, 123456789.123456789,
                 np.inf, -np.inf),
    np.float32: (0.0, -0.0, 1e-30, 1e30, 1e-45, 3.4e38, np.inf, -np.inf),
}
SHAPES = {"vector": (257,), "matrix": (5, 33), "psi": (4, 3, 17)}


def _data(writer, dtype):
    rng = np.random.default_rng(7)
    shape = SHAPES[writer]
    a = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-12, 12, shape)).astype(dtype)
    flat = a.reshape(-1)
    for i, special in enumerate(SPECIALS[dtype]):
        flat[7 * i + 3] = special
    return a


def _write(tmp_path, name, fn, data):
    path = tmp_path / name
    fn(str(path), data)
    return path.read_bytes()


@pytest.mark.parametrize("container", ["numpy", "torch"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("writer", list(SHAPES))
def test_writers_byte_identical(tmp_path, monkeypatch, jax_python, writer,
                                dtype, container):
    a = _data(writer, dtype)
    data = torch.from_numpy(a.copy()) if container == "torch" else a
    name = f"write_{writer}"
    native.reset_call_counts()
    nat = _write(tmp_path, "nat.csv", getattr(native, name), data)
    via_io = _write(tmp_path, "io.csv", getattr(port_io, name), data)
    assert native.call_counts()[name] == 2
    jx = _write(tmp_path, "jx.csv", getattr(jax_io, name), a)
    monkeypatch.setattr(port_io, "_native", lambda: None)
    py = _write(tmp_path, "py.csv", getattr(port_io, name), data)
    assert native.call_counts()[name] == 2
    assert nat == via_io == py == jx
    assert b"-0\n" in nat or b"-0 " in nat
    assert b"inf" in nat


def test_solution_csvs_all_go_through_native(tmp_path):
    """write_solution_csvs: 3 matrices, psi and 4 vectors, each one call
    into the library."""
    rng = np.random.default_rng(3)
    M, G, N = 2, 3, 5
    res = type("R", (), {
        "psi": torch.from_numpy(rng.random((M, G, N))),
        **{k: torch.from_numpy(rng.random((G, N)))
           for k in ("phi", "phi_plus", "F")},
        **{k: torch.from_numpy(rng.random(G))
           for k in ("left_ends", "right_ends")}})
    native.reset_call_counts()
    paths = port_io.write_solution_csvs(str(tmp_path), res,
                                        np.arange(N) + 0.5, rng.random(G))
    assert len(paths) == 8
    assert native.call_counts() == {"parse_deck": 0, "read_table": 0,
                                    "write_matrix": 3, "write_vector": 4,
                                    "write_psi": 1}
    native.reset_call_counts()
    assert not any(native.call_counts().values())


def test_writers_refuse_the_wrong_rank(tmp_path):
    with pytest.raises(ValueError, match="write_psi"):
        native.write_psi(str(tmp_path / "p.csv"), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="write_matrix"):
        native.write_matrix(str(tmp_path / "m.csv"), np.zeros((2, 3, 4)))


def test_readers_raise_on_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_deck(str(tmp_path / "nope.prm"))
    with pytest.raises(FileNotFoundError):
        native.read_table(str(tmp_path / "nope.txt"))


# -- the build ----------------------------------------------------------------------

# One of two processes building the library into a fresh directory at
# once. It loads native.py under a bare package (the package's __init__
# imports torch, seconds a process, which the build does not need), waits
# until both have started, builds, and reads a deck and a table.
_CHILD = r"""
import os, sys, time, types
from pathlib import Path
repo, build, ready, rank, deck, table = sys.argv[1:7]
pkg = types.ModuleType("radiative_transfer_tpu_torch")
pkg.__path__ = [os.path.join(repo, "radiative_transfer_tpu_torch")]
sys.modules[pkg.__name__] = pkg
from radiative_transfer_tpu_torch import native
native.BUILD_DIR = Path(build)
open(os.path.join(ready, rank), "w").close()
t0 = time.time()
while len(os.listdir(ready)) < 2:
    if time.time() - t0 > 120:
        sys.exit("the other process never started")
    time.sleep(0.002)
assert native.ensure_built() and native.available()
assert "torch" not in sys.modules
print(sorted(native.parse_deck_dict(deck).items()))
print(native.read_table(table).tobytes().hex())
"""


def test_concurrent_first_builds_both_load(tmp_path):
    build, ready = tmp_path / "build", tmp_path / "ready"
    ready.mkdir()
    deck = _deck("llnl_slab_test.prm")
    table = _deck("llnl_slab_test_group_kappa_a.txt")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, REPO, str(build), str(ready), str(r),
         deck, table],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    want = (str(sorted(jax_config.PrmFile(deck, prefer_native=False)
                       .params.items())) + "\n"
            + jax_config._read_table(table, prefer_native=False)
            .tobytes().hex() + "\n")
    assert [out for out, _ in outs] == [want, want]
    # One whole library, no temporary file left behind.
    files = sorted(p.name for p in build.rglob("*") if p.is_file())
    assert files == ["librtio.so"]


def _private_build(tmp_path, monkeypatch, edit=None):
    """Point the build at a copy of rtio.cc (edited) under tmp_path."""
    src = tmp_path / "src" / "rtio.cc"
    src.parent.mkdir()
    text = native.SOURCE.read_text()
    src.write_text(edit(text) if edit else text)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_compile_error_raises(tmp_path, monkeypatch):
    build = _private_build(tmp_path, monkeypatch,
                           lambda t: t + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed with exit code"):
        native.ensure_built()
    with pytest.raises(RuntimeError, match="error"):
        native.available()
    assert not [p for p in build.rglob("*") if p.is_file()]


def test_abi_mismatch_raises(tmp_path, monkeypatch):
    old = "int rtio_abi_version() { return 1; }"
    assert old in native.SOURCE.read_text()
    _private_build(tmp_path, monkeypatch, lambda t: t.replace(
        old, "int rtio_abi_version() { return 2; }"))
    assert native.ensure_built()
    with pytest.raises(RuntimeError, match="ABI version 2"):
        native.available()


def test_no_compiler_means_python_paths(tmp_path, monkeypatch, jax_python):
    _private_build(tmp_path, monkeypatch)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert native.available() is False
    assert native.ensure_built() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.write_vector(str(tmp_path / "v.csv"), [1.0])
    # The port still reads and writes, on its Python paths.
    native.reset_call_counts()
    deck = _deck("llnl_slab_test.prm")
    assert (dataclasses.asdict(port_config.load_config(deck))
            == dataclasses.asdict(jax_config.load_config(deck)))
    a = _data("psi", np.float64)
    assert (_write(tmp_path, "p.csv", port_io.write_psi, a)
            == _write(tmp_path, "j.csv", jax_io.write_psi, a))
    assert not any(native.call_counts().values())
