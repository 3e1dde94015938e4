"""Example 2: multigroup slab with v/c correction sources, on the port.

Runs the 4-group comoving-equilibrium deck (moving material, V = 1 cm/sh,
relativistic correction sources on) with the fast engine in float64,
prints the physics tables and the per-group balance, and writes the CSVs
and the plots (where matplotlib is installed).

    python -m radiative_transfer_tpu_torch.examples.multigroup_correction \
        [outdir] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import load_config
from ..models import transport
from ..ops.fast_sweep import FastEngine
from ..utils import diagnostics, io as io_mod
from ._common import add_device, deck, device_of


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="out_multigroup")
    ap.add_argument("--steps", type=int, default=100)
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)
    outdir = args.outdir
    cfg = load_config(deck("multi_group_equilibrium.prm"),
                      max_timesteps=args.steps)

    tables, grid, ct = transport.build_tables(cfg)
    print(diagnostics.render_table(
        diagnostics.planck_table(grid.edisc, ct.B, ct.dBdT)))

    eng = FastEngine(cfg, tables, dtype=torch.float64, device=dev)
    ends = eng.ends(eng.solve())
    result = transport.result_from_ends(cfg, tables, ends)
    bal = result.balance.cpu().numpy()
    print(diagnostics.render_table(diagnostics.balance_table(bal)))

    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    io_mod.write_solution_csvs(outdir, result, x, np.asarray(grid.e_ave))
    plotted = []
    try:
        from .. import plot as plot_mod

        plotted = plot_mod.plot_solution(plot_mod.read_solution(outdir),
                                         outdir)
        print(f"CSVs + figures in {os.path.abspath(outdir)}")
    except ImportError:
        print(f"CSVs in {os.path.abspath(outdir)} (matplotlib not available)")
    return {"rc": 0, "balance": bal, "ends": ends.cpu().numpy(),
            "outdir": outdir, "plots": plotted}


if __name__ == "__main__":
    sys.exit(main()["rc"])
