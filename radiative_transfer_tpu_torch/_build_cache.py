"""Where the port's compiled libraries go, and how one is put there.

Both of the port's builds, the kernel library (ops/_cuda_build.py,
nvcc) and the host I/O library (native.py, the C++ compiler on PATH),
write into radiative_transfer_tpu_torch/_build/<hash>/, keyed by a hash
of the compiler flags and the sources, so a checkout builds once and a
changed source rebuilds. Several processes may build the same library at
once (pytest-xdist workers, torchrun ranks): each compiles into a
temporary file named by its pid, then moves it into place with
``os.replace``, which is atomic, so no process loads a half-written
library and the last to finish leaves a whole one.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Iterable, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def output_path(flags: Sequence[str], sources: Iterable[Path], name: str,
                build_dir: Path = BUILD_DIR) -> Path:
    """build_dir/<16 hex digits of the flags' and sources' hash>/name."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / h.hexdigest()[:16] / name


def temporary(out: Path) -> Path:
    """The file this process compiles `out` into before ``install``."""
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp{out.suffix}")


def install(out: Path) -> Path:
    """Move this process's ``temporary(out)`` to `out`, atomically."""
    os.replace(temporary(out), out)
    return out
