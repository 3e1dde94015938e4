"""Numerical kernels: quadrature, group grids, Planck integrals,
correction tables, sweep coefficients, the general engine's sweep and
scan, and the CUDA sweep engines."""
