"""Numerical kernels: quadrature, group grids, Planck integrals,
correction tables, sweep coefficients and the CUDA sweep engine."""
