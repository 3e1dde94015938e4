"""Relativistic (v/c) correction source tables (host numpy).

Port of radiative_transfer_tpu/ops/correction.py (reference:
src/correction.cpp:11-401). Every T-dependent table is computed once on
the host in float64. The psi-dependent assembly total_correction
(correction.cpp:382-399) is the general engine's, in torch on the solve's
device; the kernel engines fold the correction into their per-kind
coefficients (ops/fast_sweep._kind_coeff_fields).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from . import planck as planck_mod

_AC = constants.AC
_KCON = constants.BOLTZMANN_CONSTANT_JPK
_TOL = constants.VALIDATION_TOLERANCE


def pf(E: np.ndarray, T: float) -> np.ndarray:
    """Planck function in jk/(cm^2-sh-keV-steradian)
    (src/correction.cpp:11-22): k_JPK * E^3 / (h^3 c^2 (e^{E/T} - 1))."""
    E = np.asarray(E, dtype=np.float64)
    h = constants.PLANCK_CONSTANT
    c = constants.SPEED_OF_LIGHT
    denom = h**3 * c**2 * (np.exp(E / T) - 1.0)
    return _KCON * E**3 / denom


class CorrectionTables(NamedTuple):
    """All T-frozen (G,) tables, float64 numpy (host)."""

    B: np.ndarray          # (G,) Planck integrals, jk/(cm^2-sh)
    dBdT: np.ndarray       # (G,)
    kappa_edge: np.ndarray # (G+1,) group-edge opacities
    dEB: np.ndarray        # (G,) energy differences of E*B
    dsigEdE: np.ndarray    # (G,) energy derivative of kappa*E
    dkapEB: np.ndarray     # (G,) energy differences of kappa*E*B
    cor1: np.ndarray       # (G,)
    cor2: np.ndarray       # (G,)
    cor3: np.ndarray       # (G,)


def compute_group_edge_opacities(
    kappa: np.ndarray, e_edge: np.ndarray, e_ave: np.ndarray
) -> np.ndarray:
    """Linear-in-e_ave interpolation of group kappas onto group edges
    (src/correction.cpp:125-159)."""
    G = kappa.shape[0]
    kappa_edge = np.zeros(G + 1, dtype=np.float64)
    kappa_edge[0] = kappa[0]
    for g in range(1, G):
        wgt_L = (e_ave[g] - e_edge[g]) / (e_ave[g] - e_ave[g - 1])
        wgt_R = (e_edge[g] - e_ave[g - 1]) / (e_ave[g] - e_ave[g - 1])
        kappa_edge[g] = kappa[g - 1] * wgt_L + kappa[g] * wgt_R
    kappa_edge[G] = kappa[G - 1]
    return kappa_edge


def build_correction_tables(
    T: float,
    rho: np.ndarray,
    kappa: np.ndarray,
    e_edge: np.ndarray,
    e_ave: np.ndarray,
    de_ave: np.ndarray,
    edisc: np.ndarray,
) -> CorrectionTables:
    G = kappa.shape[0]

    # Planck integrals in keV units -> jk units (src/correction.cpp:25-36).
    B_keV, dBdT_keV = planck_mod.planck_group_integrals(T, edisc)
    B = _KCON * B_keV
    dBdT = _KCON * dBdT_keV

    kappa_edge = compute_group_edge_opacities(kappa, e_edge, e_ave)

    # Energy differences of E*B (src/correction.cpp:162-174). First and
    # last groups are one-sided (no flux through E=0 or E=inf); for G == 1
    # only the first-group form applies (the last-group overwrite is
    # guarded by num_groups > 1 in the reference).
    dEB = np.zeros(G, dtype=np.float64)
    dEB[0] = e_edge[1] * pf(e_edge[1], T)
    if G > 1:
        for g in range(1, G - 1):
            dEB[g] = e_edge[g + 1] * pf(e_edge[g + 1], T) - e_edge[g] * pf(e_edge[g], T)
        dEB[G - 1] = -e_edge[G - 1] * pf(e_edge[G - 1], T)

    # Energy derivative of kappa*E (src/correction.cpp:206-211). NOTE the
    # last-group form uses the UPPER edge index G and is NOT guarded for
    # G == 1, so in the grey case it overwrites entry 0 — replicated.
    dsigEdE = np.zeros(G, dtype=np.float64)
    dsigEdE[0] = kappa_edge[1] * e_edge[1] / de_ave[0]
    for g in range(1, G - 1):
        dsigEdE[g] = (
            kappa_edge[g + 1] * e_edge[g + 1] - kappa_edge[g] * e_edge[g]
        ) / de_ave[g]
    dsigEdE[G - 1] = -kappa_edge[G] * e_edge[G] / de_ave[G - 1]

    # Energy differences of kappa*E*B (src/correction.cpp:241-249); the
    # last-group form uses edge index G-1 (as written in the reference).
    dkapEB = np.zeros(G, dtype=np.float64)
    dkapEB[0] = kappa_edge[1] * e_edge[1] * pf(e_edge[1], T)
    if G > 1:
        for g in range(1, G - 1):
            dkapEB[g] = kappa_edge[g + 1] * e_edge[g + 1] * pf(
                e_edge[g + 1], T
            ) - kappa_edge[g] * e_edge[g] * pf(e_edge[g], T)
        dkapEB[G - 1] = -kappa_edge[G - 1] * e_edge[G - 1] * pf(e_edge[G - 1], T)

    # cor1/2/3 are spatially uniform (src/correction.cpp:328-340).
    cor1 = dsigEdE.copy()
    cor2 = 3.0 * rho * kappa * B - dkapEB
    cor3 = cor1 * (4.0 * B - dEB)

    return CorrectionTables(
        B=B,
        dBdT=dBdT,
        kappa_edge=kappa_edge,
        dEB=dEB,
        dsigEdE=dsigEdE,
        dkapEB=dkapEB,
        cor1=cor1,
        cor2=cor2,
        cor3=cor3,
    )


def total_correction(
    psi: torch.Tensor,   # (M, G, N)
    mu: torch.Tensor,    # (M,)
    cor1: torch.Tensor,  # (G,)
    cor2: torch.Tensor,
    cor3: torch.Tensor,
    beta,
) -> torch.Tensor:
    """(cor1*psi + cor2)*mu*beta - cor3*mu^2*beta^2, per (direction, group,
    cell) (src/correction.cpp:382-399)."""
    mu_b = (mu * beta)[:, None, None]
    c1 = cor1[None, :, None]
    c2 = cor2[None, :, None]
    c3 = cor3[None, :, None]
    return (c1 * psi + c2) * mu_b - c3 * mu_b * mu_b


def equilibrium_psi_source(
    B: np.ndarray, dEB: np.ndarray, mu: np.ndarray, V: float
) -> np.ndarray:
    """Comoving-equilibrium boundary intensities with the O(beta) Doppler
    term: psi_src(i,g) = B_g + (4 B_g - dEB_g) * mu_i * V/c
    (reference: src/solver.cpp:287-315)."""
    val = 4.0 * B[None, :] - dEB[None, :]
    return B[None, :] + val * (mu[:, None] * V / constants.SPEED_OF_LIGHT)


def planck_mean_opacities(
    T: float,
    e_edge: np.ndarray,
    e_ave: np.ndarray,
    B: np.ndarray,
    kappa_grey: float,
) -> dict:
    """Planck-averaged multigroup opacity generator
    (src/correction.cpp:66-97; the reference never calls it, its call
    site is commented out at correction.cpp:376; offered as a utility, as
    in the JAX package).

    Builds a 1/E^3-shaped opacity spectrum, Planck-averages it per group
    (ukappa), and normalises so the total emission matches the grey code:
    sum_g kappa_g B_g = kappa_grey * a * c * T^4 exactly. Also returns the
    group-centred spectrum ckappa = (1 - e^{-E_g/T}) / E_g^3 and the
    per-group emission spectrum kappa_g * B_g. Host float64 numpy.
    """
    e_edge = np.asarray(e_edge, dtype=np.float64)
    e_ave = np.asarray(e_ave, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)

    tmp1 = (
        2.0 * constants.FOUR_PI * _KCON * T
        / (constants.PLANCK_CONSTANT**3 * constants.SPEED_OF_LIGHT**2)
    )
    tmp2 = np.exp(-e_edge[:-1] / T) - np.exp(-e_edge[1:] / T)
    ukappa = tmp1 * tmp2 / B
    ckappa = (1.0 - np.exp(-e_ave / T)) / e_ave**3

    acT4 = _AC * T**4
    kappa_nfac = acT4 / float(np.sum(ukappa * B))
    kappa = kappa_grey * kappa_nfac * ukappa
    return {
        "kappa": kappa,
        "emission_spectrum": kappa * B,
        "unnormalized": ukappa,
        "group_centered": ckappa,
    }


def validate_planck_integrals(B: np.ndarray, dBdT: np.ndarray, T: float) -> bool:
    """|sum B_g - a c T^4| and |sum dBdT_g - 4 a c T^3| < 1e-6
    (src/correction.cpp:39-63)."""
    acT4 = _AC * T**4
    dacT4 = 4.0 * _AC * T**3
    return (
        abs(acT4 - float(np.sum(B))) <= _TOL
        and abs(dacT4 - float(np.sum(dBdT))) <= _TOL
    )


def validate_emission(kappa: np.ndarray, B: np.ndarray, T: float, kappa_grey: float) -> bool:
    """|sum kappa_g B_g - kappa_grey a c T^4| < 1e-6 (src/correction.cpp:100-122)."""
    return abs(float(np.sum(kappa * B)) - kappa_grey * _AC * T**4) <= _TOL
