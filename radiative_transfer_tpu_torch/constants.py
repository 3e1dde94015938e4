"""Physical constants in the keV-shake-jerk-cm unit system.

Mirrors the reference unit system (reference: include/Constants.h:6-24)
value-for-value so that solutions are comparable bit-for-bit at the
tolerance level of the reference's own validation checks (1e-6).

Units:
    energy      keV (temperatures also in keV, k_B = 1)
    time        shake (1 sh = 1e-8 s)
    energy(mat) jerk (1 jk = 1e9 J)
    length      cm
"""

from __future__ import annotations

import math

PLANCK_CONSTANT_JS = 6.626083e-35  # jk-sh
PLANCK_CONSTANT = 4.141895e-10  # keV-sh
BOLTZMANN_CONSTANT = 1.0  # keV/keV
BOLTZMANN_CONSTANT_JPK = 1.601558e-25  # jk/keV
SPEED_OF_LIGHT = 299.79245800  # cm/sh
# The reference defines its own (slightly off) PI; kept verbatim because the
# quadrature weight normalisation (sum w = 4*PI) and the Planck integrals
# (factor 4*PI) bake it into every number downstream.
PI = 3.1415926546
FOUR_PI = 4.0 * PI
RADIATION_CONSTANT_A = 1.3653104e-2  # jk/(cm^3-keV^4)
KELVIN2KEV = 8.6173281e-8  # keV/K
NATURAL_LOG_2 = 0.6931471806
VALIDATION_TOLERANCE = 1.0e-6

# a = 8 pi^5 k^4 / (15 h^3 c^3) in keV/(cm^3-keV^4); equals
# RADIATION_CONSTANT_A / BOLTZMANN_CONSTANT_JPK to ~5 digits.
RADIATION_CONSTANT_A_LONG = (8.0 * PI**5 * BOLTZMANN_CONSTANT**4) / (
    15.0 * PLANCK_CONSTANT**3 * SPEED_OF_LIGHT**3
)

# a*c — the equilibrium radiation intensity scale: phi_eq = a c T^4.
AC = RADIATION_CONSTANT_A * SPEED_OF_LIGHT


def ac_T4(T: float) -> float:
    """Equilibrium angle-integrated intensity a*c*T^4 (jk/cm^2-sh)."""
    return AC * math.pow(T, 4)
