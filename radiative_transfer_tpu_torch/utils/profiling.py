"""Step-rate accounting (port of radiative_transfer_tpu/utils/profiling.py,
the part the CLI's --profile uses)."""

from __future__ import annotations


def updates_per_step(cfg) -> int:
    """Cell-angle-group sub-updates in ONE full timestep: BDF2 runs 4
    sub-steps (solver.cpp:700-811), BE/CN one."""
    subs = 4 if cfg.ts_method == 3 else 1
    return subs * cfg.M * cfg.G * cfg.N
