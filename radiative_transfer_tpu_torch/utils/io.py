"""CSV writers matching the reference output conventions.

Port of radiative_transfer_tpu/utils/io.py. Each writer goes through the
port's C++ writers (native.py, csrc/rtio.cc) when they are available and
formats value by value in Python otherwise; the two write the same bytes.
The reference dumps Eigen objects with `operator<<` (reference:
src/main.cc:37-57): matrices as whitespace-separated rows, vectors one
value per line, and the rank-3 psi tensor (column-major) as M rows whose
columns interleave groups fastest — column index n*G + g. Values print at
full float64 precision.
"""

from __future__ import annotations

import os

import numpy as np
import torch

FMT = "%.17g"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _native():
    """The C++ writer backend (native.py, byte-identical output) when it
    is available, else None."""
    from .. import native

    return native if native.available() else None


def write_vector(path: str, v) -> None:
    """One value per line (Eigen VectorXd print)."""
    nat = _native()
    if nat is not None:
        nat.write_vector(path, v)
        return
    v = _host(v).reshape(-1)
    with open(path, "w") as fh:
        for val in v:
            fh.write(FMT % val + "\n")


def write_matrix(path: str, m) -> None:
    """Whitespace-separated rows (Eigen MatrixXd print)."""
    nat = _native()
    if nat is not None:
        nat.write_matrix(path, m)
        return
    m = np.atleast_2d(_host(m))
    with open(path, "w") as fh:
        for row in m:
            fh.write(" ".join(FMT % val for val in row) + "\n")


def write_psi(path: str, psi) -> None:
    """(M, G, N) -> M rows with columns ordered n*G + g (column-major
    Eigen Tensor print, see module doc)."""
    nat = _native()
    if nat is not None:
        nat.write_psi(path, psi)
        return
    psi = _host(psi)
    M, G, N = psi.shape
    rows = psi.transpose(0, 2, 1).reshape(M, N * G)
    write_matrix(path, rows)


def write_solution_csvs(outdir: str, result, x, e_ave) -> dict:
    """The 8 files of the reference driver (src/main.cc:117-133)."""
    os.makedirs(outdir, exist_ok=True)

    def p(name):
        return os.path.join(outdir, name)

    write_matrix(p("phi.csv"), result.phi)
    write_matrix(p("phi_plus.csv"), result.phi_plus)
    write_psi(p("psi.csv"), result.psi)
    write_vector(p("x.csv"), x)
    write_matrix(p("F.csv"), result.F)
    write_vector(p("e_ave.csv"), e_ave)
    write_vector(p("left_ends.csv"), result.left_ends)
    write_vector(p("right_ends.csv"), result.right_ends)
    return {n: p(n + ".csv") for n in
            ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends", "right_ends")}
