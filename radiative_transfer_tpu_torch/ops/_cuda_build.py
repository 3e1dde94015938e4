"""Build and load the hand-written CUDA kernels of csrc/.

``load()`` compiles csrc/*.cu with nvcc into a shared library with a
plain C interface, at first use, and loads it with ctypes. The library
lands in radiative_transfer_tpu_torch/_build/<hash>/, keyed by a hash of
the sources and flags, so a checkout builds once and a changed source
rebuilds. The compiler's output (``-Xptxas -v``: registers, shared
memory and spills of every kernel) is kept beside it as build.log.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each C entry point in csrc/sweep.cu (pointers and the stream
# as c_void_p, so ctypes never cuts a 64-bit address).
_SIGNATURES = {
    "rt_sweep_bdf2": [_P] * 14 + [_I, _I, _I, _F, _F, _F, _I, _I, _P],
    "rt_sweep_multistep": [_I] + [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    "rt_sweep_substep": [_I] + [_P] * 12 + [_I, _I, _F, _I, _P],
    "rt_sweep_halo_bdf2": [_P] * 13 + [_I] * 5 + [_P],
    "rt_sweep_halo_multistep": [_I] + [_P] * 9 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / "libsweep.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libsweep.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           + proc.stderr[-6000:])
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
