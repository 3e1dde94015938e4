"""Command-line driver: deck in, CSVs out.

Port of radiative_transfer_tpu/cli.py on its single-device kernel engine
paths (reference: src/main.cc:60-136): read a .prm deck, run it on the
CUDA sweep kernels, print the per-group balance diagnostic and write the 8
CSVs the reference plot scripts consume.

Usage:
    python -m radiative_transfer_tpu_torch.cli DECK --outdir D
        --engine pallas|halo|df|auto [--dtype float64|float32] [--steps n]
        [--scan-tol x] [--profile] [--device cuda|cpu]

Engines:

* ``pallas``: CudaSweepEngine, the fused f32 sweep (kernels B1-B3);
* ``halo``: HaloCudaEngine, the packed-rows halo engine at one device
  (B4-B5; the JAX CLI's ``--engine halo`` with its implied ``--mesh 1x1``);
  exits 2 with guidance where its creep bound rejects the workload;
* ``df``: DFCudaEngine, the f64-grade double-float sweep (B6-B7), at
  either ``--dtype`` (its tables are float64 whatever the dtype; at
  float32 it says so, as the JAX CLI does);
* ``auto``: at float64 (the default, as in JAX) the f64-grade selection,
  printed as ``auto engine: df (single chip, double-float kernel)``: the
  packed-rows DFHaloCudaEngine at tiny batches (Bh < 8, B14-B15) where its
  creep bound admits the deck, then also printed as ``auto engine:
  packed-rows df halo at 1-device mesh (tiny batch)``, else DFCudaEngine;
  at ``--dtype float32`` parallel.make_multichip_engine's pick (the halo
  engine at tiny batches where feasible, else CudaSweepEngine), printed as
  ``auto engine: <Engine> (single chip)``. An explicit ``--engine df``
  keeps the plain DFCudaEngine, as in JAX.

One routing differs from the JAX CLI's on purpose: auto at float64 stays
on the double-float kernels for an N with no TPU-friendly block, where JAX
falls back to its XLA engine (the CUDA kernels tile any N).

``pallas`` and ``halo`` are float32 engines; at ``--dtype float64`` they
print a note and run in float32, as the JAX CLI does. ``--device cuda``
(the default) runs the CUDA kernels and fails with exit code 2 when there
is no CUDA device; ``--device cpu`` runs the kernels' plain PyTorch
versions. Every other engine (``general``, ROADMAP A2; ``fast``, A7) and
flag of the JAX package's CLI is refused with exit code 2: it is not
ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="radiative_transfer_tpu_torch",
        description="1-D multigroup S_N thermal radiative transfer on "
                    "hand-written CUDA sweep kernels",
        allow_abbrev=False,
    )
    default_deck = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "prm", "default.prm",
    )
    ap.add_argument("deck", nargs="?", default=default_deck,
                    help=".prm input deck (reference grammar)")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--steps", type=int, default=None,
                    help="override max_timesteps")
    ap.add_argument("--engine", default="general",
                    help="pallas: the fused f32 sweep on the CUDA kernels; "
                         "halo: the packed-rows halo engine at one device; "
                         "df: the f64-grade double-float sweep; auto: the "
                         "shape-aware pick of df and its packed-rows halo at "
                         "float64, of pallas and halo at float32 (the JAX "
                         "package's default, general, is not ported yet)")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64",
                    help="float32 for the f32 engines; float64 (default) "
                         "picks the double-float engine under auto")
    ap.add_argument("--scan-tol", type=float, default=1e-10,
                    help="accuracy bound of the plain versions' truncated "
                         "prefix scan (neglected upwind tail a^(2^k)/(1-a) "
                         "< tol; 0 = full scan)")
    ap.add_argument("--profile", action="store_true",
                    help="print wall-clock and updates/s of the solve")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the CUDA kernels (default); cpu: their "
                         "plain PyTorch versions")
    args, extra = ap.parse_known_args(argv)

    if extra:
        print(f"not ported yet: {' '.join(extra)} (this CLI takes --outdir, "
              "--steps, --engine pallas|halo|df|auto, --dtype, --scan-tol, "
              "--profile, --device)", file=sys.stderr)
        return 2
    if args.engine not in ("pallas", "halo", "df", "auto"):
        item = {"general": " (ROADMAP A2)", "fast": " (ROADMAP A7)"}
        print(f"--engine {args.engine} is not ported yet"
              f"{item.get(args.engine, '')}; use --engine pallas, halo, df "
              "or auto", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (--device cpu "
              "runs the plain PyTorch versions)", file=sys.stderr)
        return 2
    if not os.path.exists(args.deck):
        print(f"deck not found: {args.deck}", file=sys.stderr)
        return 2

    from . import load_config
    from .models import transport
    from .ops.cuda_df import DFCudaEngine
    from .parallel import make_multichip_engine
    from .utils import io as io_mod
    from .utils.profiling import updates_per_step

    overrides = {}
    if args.steps is not None:
        overrides["max_timesteps"] = args.steps
    cfg = load_config(args.deck, **overrides)
    print(f"filename: {args.deck}")

    tables, grid, ct = transport.build_tables(cfg)
    if cfg.include_validation and not transport.validate_tables(cfg, ct):
        print("Invalid Correction Terms", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    engine = args.engine
    auto_df = engine == "auto" and args.dtype == "float64"
    if auto_df:
        engine = "df"
        print("auto engine: df (single chip, double-float kernel)")
    elif engine == "df" and args.dtype != "float64":
        print("note: --engine df is f64-grade; building its tables at "
              "float64 despite --dtype float32")
    elif engine in ("pallas", "halo") and args.dtype != "float32":
        print(f"note: the {engine} engine is float32-only")
    try:
        if engine == "df" and not auto_df:
            # An explicit --engine df pins the plain double-float kernel.
            eng = DFCudaEngine(cfg, tables, scan_tol=args.scan_tol,
                               device=args.device)
        else:
            # pallas is the plain CudaSweepEngine, the selection's "single".
            eng = make_multichip_engine(
                cfg, tables, None,
                engine="single" if engine == "pallas" else engine,
                scan_tol=args.scan_tol, device=args.device)
    except ValueError as e:
        print(f"--engine {args.engine} infeasible for this workload: "
              f"{e}\nfall back to --engine pallas", file=sys.stderr)
        return 2
    if engine == "auto":
        print(f"auto engine: {type(eng).__name__} (single chip)")
    elif auto_df and not isinstance(eng, DFCudaEngine):
        print("auto engine: packed-rows df halo at 1-device mesh (tiny "
              "batch)")
    ends = eng.ends(eng.solve())
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    result = transport.result_from_ends(cfg, tables, ends)

    if args.profile:
        steps_run = cfg.max_timesteps
        ups = updates_per_step(cfg) * steps_run
        print(f"wall: {wall:.3f} s for {steps_run} steps "
              f"({wall / max(steps_run, 1) * 1e3:.2f} ms/step, "
              f"{ups / wall / 1e6:.1f} M updates/s) on {args.device}")

    # Balance diagnostic (printed, not asserted) in the reference's
    # per-group console format (solver.cpp:277-282), plus a summary.
    bal = result.balance.cpu().numpy()
    srcs = result.sources.cpu().numpy()
    snks = result.sinks.cpu().numpy()
    for gi in range(bal.shape[0]):
        print(f"sources: {srcs[gi]:.6g}")
        print(f"sinks: {snks[gi]:.6g}")
        print(f"balance at ({gi}): {bal[gi]:.6g}")
    print("balance |sinks-sources|/sources per group:")
    print("  max = %.3e   mean = %.3e" % (bal.max(), bal.mean()))

    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    paths = io_mod.write_solution_csvs(args.outdir, result, x,
                                       np.asarray(grid.e_ave))
    print(f"wrote {len(paths)} CSVs to {os.path.abspath(args.outdir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
