"""Build and load the hand-written CUDA kernels of csrc/.

``load()`` compiles each csrc/*.cu with its own nvcc, all started
together (the build's wall time is the slowest file's, not their sum),
links the objects into one shared library with a plain C interface, at
first use, and loads it with ctypes. The library
lands in radiative_transfer_tpu_torch/_build/<hash>/, keyed by a hash of
the sources and flags, so a checkout builds once and a changed source
rebuilds. The compiler's output (``-Xptxas -v``: registers, shared
memory and spills of every kernel) is kept beside it as build.log, each
command with its wall seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)     # an array of plane pointers
# argtypes of each C entry point in csrc/sweep.cu, csrc/df_sweep.cu,
# csrc/adjoint.cu, csrc/sharded.cu and csrc/fused.cu (pointers and the
# stream as c_void_p, so ctypes never cuts a 64-bit address).
_SIGNATURES = {
    "rt_sweep_bdf2": [_P] * 14 + [_I, _I, _I, _F, _F, _F] + [_I] * 4 + [_P],
    "rt_sweep_multistep": [_I] + [_P] * 10 + [_I, _I, _I, _F] + [_I] * 3
    + [_P],
    "rt_sweep_geometry": [_I] * 6 + [_P],
    "rt_sweep_substep": [_I] + [_P] * 12 + [_I, _I, _F, _I, _I, _P],
    "rt_sweep_substep_geometry": [_I, _I, _P],
    "rt_sweep_halo_bdf2": [_P] * 13 + [_I] * 7 + [_P],
    "rt_sweep_halo_bdf2_geometry": [_I] * 6 + [_P],
    "rt_sweep_halo_multistep": [_I] + [_P] * 9 + [_I] * 6 + [_P],
    "rt_sweep_halo_multistep_geometry": [_I] * 6 + [_P],
    "rt_df_bdf2": [_P] * 10 + [_PP] + [_I] * 8 + [_P],
    "rt_df_bdf2_geometry": [_I] * 5 + [_P],
    "rt_df_multistep": [_I] + [_P] * 6 + [_PP] + [_I] * 7 + [_P],
    "rt_df_multistep_geometry": [_I] * 5 + [_P],
    "rt_df_halo_bdf2": [_P] * 9 + [_PP] + [_I] * 8 + [_P],
    "rt_df_halo_bdf2_geometry": [_I] * 6 + [_P],
    "rt_df_halo_multistep": [_I] + [_P] * 5 + [_PP] + [_I] * 7 + [_P],
    "rt_df_halo_multistep_geometry": [_I] * 6 + [_P],
    "rt_adj_fwd_record": [_I] + [_P] * 15 + [_I] * 3 + [_F] * 3 + [_I] * 3
    + [_P],
    "rt_adj_fwd_geometry": [_I, _I, _P],
    "rt_adj_bwd": [_I] + [_P] * 21 + [_I] * 3 + [_F] * 3 + [_I] * 4 + [_P],
    "rt_adj_bwd_geometry": [_I] * 6 + [_P],
    "rt_adj_fwd_record_k": [_P] * 19 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "rt_adj_fwd_record_k_geometry": [_I] * 4 + [_P],
    "rt_adj_bwd_k": [_P] * 25 + [_I] * 4 + [_F] * 3 + [_I] * 4 + [_P],
    "rt_sharded_substep": [_I] + [_P] * 15 + [_I] * 3 + [_P],
    "rt_sharded_geometry": [_I, _I, _P],
    "rt_fused_step": [_P] * 12 + [_I] * 5 + [_P],
    "rt_fused_geometry": [_I, _I, _P],
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


def _run(cmd: list[str]):
    """Run one compiler command: (command, process, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return cmd, proc, time.perf_counter() - t0


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
    objs = [out.with_name(f"{p.stem}.{os.getpid()}.o") for p in cu]
    with ThreadPoolExecutor(len(cu)) as pool:
        results = list(pool.map(_run, (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(cu, objs))))
    if all(proc.returncode == 0 for _, proc, _ in results):
        results.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                             *map(str, objs)]))
    # Each command, its wall seconds, then its output.
    (out.parent / "build.log").write_text("".join(
        f"{' '.join(cmd)}\n# {secs:.2f} s\n{proc.stdout}{proc.stderr}"
        for cmd, proc, secs in results))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, proc, _ in results:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} ({cmd[-1]}):\n"
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
