"""Group-integrated Planck emission: B_g = ∫ B dE and dB_g/dT.

Equivalent of the reference Planck integrator
(reference: src/Planck.cpp:44-337, include/Planck.h:57-145):

* three-regime evaluation per group — 12-point Gauss-Legendre quadrature
  for z2 <= 0.7, a truncated (adaptive-N) series for z1 >= 0.5, and a
  split at z = 0.6 otherwise;
* the remainder of the grey integral a_long*c*T^4 is assigned to the
  LAST group so total emission is conserved exactly
  (src/Planck.cpp:60-77);
* grey closed forms a_long*c*T^4 and 4*a_long*c*T^3.

This is setup-time host code (float64 numpy): the material temperature
is frozen in this problem class, so the (G,) tables are computed once
and baked into the compiled step function — unlike the reference, which
recomputes them every timestep (src/solver.cpp:608).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import constants
from .quadrature import gauss_legendre

_H = constants.PLANCK_CONSTANT
_K = constants.BOLTZMANN_CONSTANT
_C = constants.SPEED_OF_LIGHT

_EPS = np.finfo(np.float64).eps

# 12-point quadrature is sufficient to integrate B for z < 1
# (src/Planck.cpp:253). Standard interval [-1, 1], weights summing to 2.
_QPTS, _QWTS = gauss_legendre(12, norm=2.0)


def _equal(l: float, r: float, ulp: int = 2) -> bool:
    return abs(l - r) <= _EPS * abs(l + r) * ulp or abs(l - r) < np.finfo(
        np.float64
    ).tiny


def planck_B(T: float, E) -> np.ndarray:
    """Pointwise Planck function B(E,T) = 2E^3 / (h^3 c^2 (e^{E/kT}-1))."""
    E = np.asarray(E, dtype=np.float64)
    if _equal(T, 0.0):
        return np.zeros_like(E)
    return 2.0 * E**3 / (_H**3 * _C**2) / (np.exp(E / (_K * T)) - 1.0)


def planck_dBdT(T: float, E) -> np.ndarray:
    """Pointwise dB/dT = (2/(h^3 c^2 k)) E^4 T^-2 e^{E/kT} (e^{E/kT}-1)^-2."""
    E = np.asarray(E, dtype=np.float64)
    if _equal(T, 0.0):
        return np.zeros_like(E)
    x = np.exp(E / (_K * T))
    return 2.0 / (_H**3 * _C**2 * _K) * E**4 / T**2 * x / (x - 1.0) ** 2


def integrate_B_grey(T: float) -> float:
    return constants.RADIATION_CONSTANT_A_LONG * _C * T**4


def integrate_dBdT_grey(T: float) -> float:
    return 4.0 * constants.RADIATION_CONSTANT_A_LONG * _C * T**3


def _series_B(z1: float, z2: float, accuracy: float) -> float:
    """sum_n e^{-n z}/n^4 (n^3 z^3 + 3 n^2 z^2 + 6 n z + 6) evaluated at z1
    minus z2, with N chosen adaptively against `accuracy`."""
    N = 32
    norm = np.exp(-z1) * (z1**3 + 3.0 * z1**2 + 6.0 * z1 + 6.0)
    norm = max(norm, _EPS)
    while True:
        n1 = N + 1.0
        val = (
            np.exp(-n1 * z1)
            / (1.0 - np.exp(-z1))
            * n1**-4.0
            * ((n1 * z1) ** 3 + 3.0 * (n1 * z1) ** 2 + 6.0 * n1 * z1 + 6.0)
            / norm
        )
        if val > accuracy:
            N += 1
        else:
            break
    ns = np.arange(N, 0, -1, dtype=np.float64)
    s1 = np.sum(
        np.exp(-ns * z1) / ns**4 * ((ns * z1) ** 3 + 3 * (ns * z1) ** 2 + 6 * ns * z1 + 6)
    )
    s2 = np.sum(
        np.exp(-ns * z2) / ns**4 * ((ns * z2) ** 3 + 3 * (ns * z2) ** 2 + 6 * ns * z2 + 6)
    )
    return float(s1 - s2)


def _series_dBdT(z1: float, z2: float, accuracy: float) -> float:
    N = 32
    norm = np.exp(-z1) * (z1**4 + 4.0 * z1**3 + 12.0 * z1**2 + 24.0 * z1 + 24.0)
    norm = max(norm, _EPS)
    while True:
        n1 = N + 1.0
        val = (
            np.exp(-n1 * z1)
            / (1.0 - np.exp(-z1))
            * n1**-4.0
            * (
                (n1 * z1) ** 4
                + 4.0 * (n1 * z1) ** 3
                + 12.0 * (n1 * z1) ** 2
                + 24.0 * n1 * z1
                + 24.0
            )
            / norm
        )
        if val > accuracy:
            N += 1
        else:
            break
    ns = np.arange(N, 0, -1, dtype=np.float64)

    def poly(z):
        nz = ns * z
        return np.sum(np.exp(-nz) / ns**4 * (nz**4 + 4 * nz**3 + 12 * nz**2 + 24 * nz + 24))

    return float(poly(z1) - poly(z2))


def integrate_B(T: float, E_min: float, E_max: float, accuracy: float = _EPS) -> float:
    """Group-integrated Planck function over [E_min, E_max], keV units.

    NOT a per-steradian quantity: includes the 4*pi factor."""
    assert T >= 0.0 and E_min >= 0.0 and E_max > E_min
    if _equal(T, 0.0) or _equal(E_min, E_max):
        return 0.0

    z1 = E_min / (_K * T)
    z2 = E_max / (_K * T)

    if z2 <= 0.7:  # Gauss quadrature over the whole group
        g_mid = 0.5 * (E_max + E_min)
        g_map = 0.5 * (E_max - E_min)
        Bg = float(np.sum(g_map * _QWTS * planck_B(T, g_mid + g_map * _QPTS)))
    elif z1 >= 0.5:  # truncated series
        Bg = 2.0 * (_K * T) ** 4 * _series_B(z1, z2, accuracy) / (_H**3 * _C**2)
    else:  # split at z = 0.6
        zs = 0.6
        g_mid = 0.5 * (zs * _K * T + E_min)
        g_map = 0.5 * (zs * _K * T - E_min)
        gauss = float(np.sum(g_map * _QWTS * planck_B(T, g_mid + g_map * _QPTS)))
        Bg = gauss + 2.0 * (_K * T) ** 4 * _series_B(zs, z2, accuracy) / (_H**3 * _C**2)

    return Bg * 4.0 * constants.PI


def integrate_dBdT(T: float, E_min: float, E_max: float, accuracy: float = _EPS) -> float:
    assert T >= 0.0 and E_min >= 0.0 and E_max > E_min
    if _equal(T, 0.0) or _equal(E_min, E_max):
        return 0.0

    z1 = E_min / (_K * T)
    z2 = E_max / (_K * T)

    if z2 <= 0.7:
        g_mid = 0.5 * (E_max + E_min)
        g_map = 0.5 * (E_max - E_min)
        d = float(np.sum(g_map * _QWTS * planck_dBdT(T, g_mid + g_map * _QPTS)))
    elif z1 >= 0.5:
        d = 2.0 * _K**4 * T**3 * _series_dBdT(z1, z2, accuracy) / (_H**3 * _C**2)
    else:
        zs = 0.6
        g_mid = 0.5 * (zs * _K * T + E_min)
        g_map = 0.5 * (zs * _K * T - E_min)
        gauss = float(np.sum(g_map * _QWTS * planck_dBdT(T, g_mid + g_map * _QPTS)))
        d = gauss + 2.0 * _K**4 * T**3 * _series_dBdT(zs, z2, accuracy) / (_H**3 * _C**2)

    return d * 4.0 * constants.PI


def planck_group_integrals(
    T: float, edisc: np.ndarray, accuracy: float = _EPS
) -> Tuple[np.ndarray, np.ndarray]:
    """(B_g, dB_g/dT) for all groups, keV units, with the grey-integral
    remainder assigned to the last group (src/Planck.cpp:50-77)."""
    edisc = np.asarray(edisc, dtype=np.float64)
    G = edisc.shape[0]
    B = np.zeros(G, dtype=np.float64)
    dBdT = np.zeros(G, dtype=np.float64)

    B_sum = integrate_B_grey(T)
    dBdT_sum = integrate_dBdT_grey(T)
    for g in range(G - 1):
        b = integrate_B(T, edisc[g, 0], edisc[g, 1], accuracy)
        B[g] = b
        B_sum -= b
        d = integrate_dBdT(T, edisc[g, 0], edisc[g, 1], accuracy)
        dBdT[g] = d
        dBdT_sum -= d

    if B_sum > 0.0:
        B[G - 1] = B_sum
    if dBdT_sum > 0.0:
        dBdT[G - 1] = dBdT_sum
    return B, dBdT
