"""Gauss-Legendre angular quadrature (S_N direction set).

Equivalent of the reference's Newton-on-Legendre builder
(reference: src/GLQuad.cpp:4-44): nodes mu ascending in (-1, 1) with the
negative directions first, weights symmetric and normalised so that
sum(w) == norm (the solver uses norm = 4*pi, src/solver.cpp:76).

Setup-time code: runs once on the host in float64; the resulting arrays
are tiny (M,) constants baked into the compiled step function.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import constants


def gauss_legendre(n: int, norm: float = constants.FOUR_PI) -> Tuple[np.ndarray, np.ndarray]:
    """Return (mu, wt): mu ascending (first half negative), sum(wt) == norm."""
    assert n >= 2 and n % 2 == 0, "quadrature order must be even and >= 2"
    # numpy's leggauss produces the same ascending nodes and standard
    # weights (sum = 2) that the reference's Newton iteration converges to
    # at tolerance 1e-12; rescale weights to the requested norm.
    mu, w = np.polynomial.legendre.leggauss(n)
    wt = w * (norm / 2.0)
    return mu.astype(np.float64), wt.astype(np.float64)
