"""Command-line driver: deck in, CSVs out.

Port of radiative_transfer_tpu/cli.py on its general and kernel engine
paths, on one device and on a mesh (reference: src/main.cc:60-136): read a
.prm deck, run it, print the per-group balance diagnostic and write the 8
CSVs the reference plot scripts consume.

Usage:
    python -m radiative_transfer_tpu_torch.cli DECK --outdir D
        [--engine general|pallas|halo|fused|df|auto] [--mesh GxX]
        [--dtype float64|float32] [--steps n] [--scan-tol x] [--profile]
        [--device cuda|cpu]

    torchrun --nproc_per_node P -m radiative_transfer_tpu_torch.cli DECK
        --mesh GxX ...        (P = G*X ranks, one shard each)

Engines without ``--mesh``:

* ``general`` (the default, as in JAX): models/transport.solve, the
  readable scan-parallel path in plain PyTorch at ``--dtype`` (float64 by
  default);
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

With ``--mesh GxX`` (``halo`` and ``fused`` imply ``--mesh 1x1``, as in
JAX) every rank of the process group (torchrun's environment,
parallel/distributed.py) runs its shard of a (group, spatial) mesh, and
rank 0 writes the CSVs from the gathered ends:

* ``general``: parallel/sharded.solve_sharded, the general engine on the
  mesh at ``--dtype``;
* ``pallas``: ShardedCudaEngine (B8, one exchange a sub-step);
* ``fused``: FusedExchangeCudaEngine (B13, one exchange a BDF2 step);
* ``halo``: HaloCudaEngine on the mesh (B4-B5), exit 2 where infeasible;
* ``df``, and ``auto`` at float64: DFHaloCudaEngine on the mesh (B14-B15);
  where its creep bound rejects the deck, exit 2 (JAX falls back to its
  XLA ShardedFastEngine, ROADMAP A7);
* ``auto`` at float32: parallel.make_multichip_engine's mesh pick (halo
  where feasible, else fused at BDF2, else sharded), printed as ``auto
  engine: <Engine>``.

``pallas``, ``halo`` and ``fused`` are float32 engines; at ``--dtype
float64`` they print a note and run in float32, as the JAX CLI does.
``--device cuda`` (the default) runs on the card and fails with exit
code 2 when there is no CUDA device; ``--device cpu`` runs the general
engine and the kernels' plain PyTorch versions on the CPU. Every other
engine (``fast``, ROADMAP A7) and flag of the JAX package's CLI is refused
with exit code 2: it is not ported yet.
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
                    help="general: the readable scan path at --dtype "
                         "(default; with --mesh, on the mesh); pallas: the "
                         "fused f32 sweep on the CUDA kernels (with --mesh, "
                         "the per-sub-step mesh engine); halo: the "
                         "packed-rows halo engine (implies --mesh 1x1); "
                         "fused: the single-exchange fused BDF2 mesh engine "
                         "(implies --mesh 1x1); df: the f64-grade "
                         "double-float sweep (with --mesh, its halo engine); "
                         "auto: the shape-aware pick for the mesh and dtype")
    ap.add_argument("--mesh", default=None, metavar="GxX",
                    help="solve on a (group, spatial) mesh of G*X ranks, "
                         "one shard each, e.g. 1x4 under torchrun "
                         "--nproc_per_node 4")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64",
                    help="the general engine's dtype; float32 for the f32 "
                         "engines; float64 (default) picks the double-float "
                         "engine under auto")
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
              "--steps, --engine general|pallas|halo|fused|df|auto, --mesh, "
              "--dtype, --scan-tol, --profile, --device)", file=sys.stderr)
        return 2
    if args.engine not in ("general", "pallas", "halo", "fused", "df",
                           "auto"):
        item = {"fast": " (ROADMAP A7)"}
        print(f"--engine {args.engine} is not ported yet"
              f"{item.get(args.engine, '')}; use --engine general, pallas, "
              "halo, fused, df or auto", file=sys.stderr)
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
    from .parallel import distributed
    from .utils import io as io_mod
    from .utils.profiling import updates_per_step

    # The halo and fused engines are mesh engines: their implied mesh must
    # exist before the process group is joined (as JAX's cli.py:277-278).
    if args.engine in ("halo", "fused") and not args.mesh:
        args.mesh = "1x1"
    device = torch.device(args.device)
    if args.mesh:
        distributed.initialize(device_type=args.device)
        device = distributed.local_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)   # NCCL's collectives need it
    is_p0 = distributed.process_index() == 0
    say = print if is_p0 else (lambda *a, **k: None)

    overrides = {}
    if args.steps is not None:
        overrides["max_timesteps"] = args.steps
    cfg = load_config(args.deck, **overrides)
    say(f"filename: {args.deck}")

    tables, grid, ct = transport.build_tables(cfg)
    if cfg.include_validation and not transport.validate_tables(cfg, ct):
        print("Invalid Correction Terms", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    if args.engine == "general":
        ends = _general(args, cfg, tables, device)
    else:
        eng = (_mesh_engine(args, cfg, tables, device, say) if args.mesh
               else _single_engine(args, cfg, tables))
        ends = eng if isinstance(eng, int) else eng.ends(eng.solve())
    if isinstance(ends, int):
        return ends
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if not is_p0:
        return 0
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


def _general(args, cfg, tables, device):
    """The general engine's final ends (JAX's transport.solve, or its
    _run_sharded on --mesh), or an exit code."""
    from .models import transport
    from .parallel import sharded

    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    state = transport.initial_state(cfg, tables)
    if not args.mesh:
        return transport.solve(cfg, tables, state, dtype=dtype,
                               device=device).ends
    mesh = _mesh(args)
    if isinstance(mesh, int):
        return mesh
    try:
        return sharded.solve_sharded(cfg, tables, state, mesh, dtype=dtype,
                                     device=device).ends
    except ValueError as e:
        print(f"--engine general infeasible on --mesh {args.mesh}: {e}",
              file=sys.stderr)
        return 2


def _mesh(args):
    """The (group, spatial) mesh of --mesh GxX over this run's ranks, or
    an exit code."""
    from .parallel import distributed
    from .parallel import mesh as mesh_mod

    try:
        ng, nx = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        print(f"--mesh must look like 2x4, got {args.mesh!r}",
              file=sys.stderr)
        return 2
    ranks = distributed.process_count()
    if ng * nx != ranks:
        print(f"--mesh {args.mesh} needs {ng * nx} ranks, this run has "
              f"{ranks} (run it under torchrun --nproc_per_node "
              f"{ng * nx})", file=sys.stderr)
        return 2
    mesh = (mesh_mod.make_mesh_2d(ng, nx) if ng > 1
            else mesh_mod.make_mesh_1d(nx))
    distributed.assert_mesh_spans_hosts(mesh)
    return mesh


def _single_engine(args, cfg, tables):
    """The one-device engine of --engine (no --mesh), or an exit code."""
    from .ops.cuda_df import DFCudaEngine
    from .parallel import make_multichip_engine

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
    return eng


def _mesh_engine(args, cfg, tables, device, say):
    """The mesh engine of --engine on --mesh GxX (JAX's _run_sharded), or
    an exit code."""
    from .parallel import make_multichip_engine

    mesh = _mesh(args)
    if isinstance(mesh, int):
        return mesh
    engine, f64 = args.engine, args.dtype == "float64"
    kw = dict(scan_tol=args.scan_tol, device=device)
    if engine == "df" and not f64:
        say("note: --engine df is f64-grade; building its tables at "
            "float64 despite --dtype float32")
    elif engine in ("pallas", "halo", "fused") and f64:
        say(f"note: the {engine} mesh engine is float32-only")
    pick = {"pallas": "pallas", "halo": "halo", "fused": "fused",
            "df": "df_halo", "auto": "df_halo" if f64 else "auto"}[engine]
    try:
        eng = make_multichip_engine(cfg, tables, mesh, engine=pick, **kw)
    except ValueError as e:
        if pick == "df_halo":
            print(f"--engine {engine} infeasible for this mesh workload: "
                  f"{e}\nthe f64 fallback, the sharded XLA engine, is not "
                  "ported yet (ROADMAP A7); use --dtype float32",
                  file=sys.stderr)
        else:
            print(f"--engine {engine} infeasible for this workload: {e}\n"
                  "fall back to --engine pallas (per-substep exchange)",
                  file=sys.stderr)
        return 2
    if engine == "auto":
        say(f"auto engine: {type(eng).__name__}")
    return eng


if __name__ == "__main__":
    rc = main()
    from .parallel import distributed
    distributed.shutdown()
    sys.exit(rc)
