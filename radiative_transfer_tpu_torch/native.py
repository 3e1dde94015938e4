"""ctypes bindings for the port's native runtime I/O library (csrc/rtio.cc).

Port of radiative_transfer_tpu/native.py, name for name. The host-side
data path (deck parsing, table reads and the large CSV dumps) runs in
C++ as the reference's does (reference: src/param.cpp,
src/ParameterHandler.cpp:136-198, src/main.cc:37-57), with this module as
the thin boundary. config/config.py and utils/io.py take it whenever
``available()``, and their Python paths otherwise: the two give the same
records and byte-identical CSVs.

The library is built at first use with the C++ compiler on PATH (g++,
else c++) into radiative_transfer_tpu_torch/_build/<hash>/librtio.so,
keyed by the source and the flags; concurrent first builds each install
a whole library atomically (_build_cache.py). Unlike the JAX package's
bindings, which fall back to Python on any failure, a build that fails
is an error: ``available()`` is False only when the library is not built
and no C++ compiler is on PATH. A compiler that fails, or a library
whose ABI version differs, raises RuntimeError.

Every entry point counts its calls into the library (``write_psi.calls``
and so on; ``call_counts()``, ``reset_call_counts()``), as the kernel
wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import _build_cache

SOURCE = Path(__file__).resolve().parent / "csrc" / "rtio.cc"
BUILD_DIR = _build_cache.BUILD_DIR
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
ABI_VERSION = 1

_FIELD_SEP = "\x1f"
_RECORD_SEP = "\x1e"

_lock = threading.Lock()


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++")


def _build() -> Optional[Path]:
    """The library's path, compiling it first if this source and these
    flags have none yet; None when there is none and no compiler."""
    with _lock:
        out = _build_cache.output_path(CXX_FLAGS, [SOURCE], "librtio.so",
                                       BUILD_DIR)
        if out.exists():
            return out
        cxx = _compiler()
        if cxx is None:
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = _build_cache.temporary(out)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed with exit code {proc.returncode} ({SOURCE}):\n"
                + proc.stderr[-6000:])
        return _build_cache.install(out)


def ensure_built() -> bool:
    """Compile librtio.so unless it is built. Returns whether it is built
    afterwards: False only when no C++ compiler is on PATH. Raises
    RuntimeError, with the compiler's errors, when the compiler fails."""
    return _build() is not None


@functools.cache
def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.rtio_parse_deck.argtypes = [ctypes.c_char_p]
    lib.rtio_parse_deck.restype = ctypes.c_void_p
    lib.rtio_read_table.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.rtio_read_table.restype = ctypes.c_void_p
    lib.rtio_write_matrix.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.rtio_write_matrix.restype = ctypes.c_int
    lib.rtio_write_vector.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64
    ]
    lib.rtio_write_vector.restype = ctypes.c_int
    lib.rtio_write_psi.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.rtio_write_psi.restype = ctypes.c_int
    lib.rtio_free.argtypes = [ctypes.c_void_p]
    lib.rtio_free.restype = None
    lib.rtio_abi_version.argtypes = []
    lib.rtio_abi_version.restype = ctypes.c_int
    version = lib.rtio_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{path}: rtio ABI version {version}, this module "
                           f"binds version {ABI_VERSION}")
    return lib


def _load() -> Optional[ctypes.CDLL]:
    path = _build()
    return None if path is None else _open(str(path))


def available() -> bool:
    """True iff the native library is loadable (building it on demand)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("librtio.so is not built and no C++ compiler "
                           "(g++ or c++) is on PATH")
    return lib


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def parse_deck(path: str) -> List[Tuple[str, str]]:
    """(key, value) records of a .prm deck, file order, first-wins.
    Raises FileNotFoundError if the file cannot be opened."""
    lib = _lib()
    parse_deck.calls += 1
    ptr = lib.rtio_parse_deck(os.fsencode(path))
    if not ptr:
        raise FileNotFoundError(path)
    try:
        raw = ctypes.string_at(ptr).decode("utf-8", errors="surrogateescape")
    finally:
        lib.rtio_free(ptr)
    out: List[Tuple[str, str]] = []
    for rec in raw.split(_RECORD_SEP):
        if not rec:
            continue
        key, _, value = rec.partition(_FIELD_SEP)
        out.append((key, value))
    return out


def parse_deck_dict(path: str) -> Dict[str, str]:
    return dict(parse_deck(path))


def read_table(path: str) -> np.ndarray:
    """Whitespace-separated doubles; stops at the first bad token."""
    lib = _lib()
    read_table.calls += 1
    n = ctypes.c_int64()
    ptr = lib.rtio_read_table(os.fsencode(path), ctypes.byref(n))
    if not ptr:
        raise FileNotFoundError(path)
    try:
        if n.value == 0:
            return np.empty(0, dtype=np.float64)
        buf = ctypes.cast(
            ptr, ctypes.POINTER(ctypes.c_double * n.value)
        ).contents
        return np.frombuffer(bytearray(buf), dtype=np.float64).copy()
    finally:
        lib.rtio_free(ptr)


# ---------------------------------------------------------------------------
# Writers (numpy arrays, or torch tensors on any device)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    # utils/io.py imports torch; the readers above need none of it.
    from .utils.io import _host

    return _host(x)


def _as_c_double(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_matrix(path: str, m) -> None:
    lib = _lib()
    a, p = _as_c_double(np.atleast_2d(_host(m)))
    if a.ndim != 2:
        raise ValueError(f"write_matrix: a matrix, got shape {a.shape}")
    write_matrix.calls += 1
    rc = lib.rtio_write_matrix(os.fsencode(path), p, a.shape[0], a.shape[1])
    if rc != 0:
        raise OSError(f"rtio_write_matrix failed for {path}")


def write_vector(path: str, v) -> None:
    lib = _lib()
    a, p = _as_c_double(_host(v).reshape(-1))
    write_vector.calls += 1
    rc = lib.rtio_write_vector(os.fsencode(path), p, a.size)
    if rc != 0:
        raise OSError(f"rtio_write_vector failed for {path}")


def write_psi(path: str, psi) -> None:
    """(M, G, N) C-order tensor -> the interleaved n*G+g column layout."""
    lib = _lib()
    a, p = _as_c_double(_host(psi))
    if a.ndim != 3:
        raise ValueError(f"write_psi: an (M, G, N) tensor, got shape "
                         f"{a.shape}")
    write_psi.calls += 1
    rc = lib.rtio_write_psi(
        os.fsencode(path), p, a.shape[0], a.shape[1], a.shape[2]
    )
    if rc != 0:
        raise OSError(f"rtio_write_psi failed for {path}")


_COUNTED = (parse_deck, read_table, write_matrix, write_vector, write_psi)


def call_counts() -> Dict[str, int]:
    """Calls into the library since the last reset, by entry point."""
    return {fn.__name__: fn.calls for fn in _COUNTED}


def reset_call_counts() -> None:
    """Zero every entry point's count of calls into the library."""
    for fn in _COUNTED:
        fn.calls = 0


reset_call_counts()
