"""Command-line driver: deck in, CSVs out.

Port of radiative_transfer_tpu/cli.py on its general, fast and kernel
engine paths, on one device and on a mesh, its opacity ensembles and its
direct steady-state solves (reference: src/main.cc:60-136): read a
.prm deck, echo the input quantities
(ParameterHandler::display_input_quantities, src/ParameterHandler.cpp:
20-96) and the solver's quadrature and group tables, run it, print the
per-group balance diagnostic and write the 8 CSVs the reference plot
scripts consume.

Usage:
    python -m radiative_transfer_tpu_torch.cli DECK --outdir D
        [--engine general|fast|pallas|halo|fused|df|auto] [--mesh GxX]
        [--dtype float64|float32] [--steps n] [--scan-tol x] [--profile]
        [--device cuda|cpu]
        [--checkpoint-dir DIR [--checkpoint-every n] [--no-resume]]
        [--balance-every K] [--check [--check-positivity]]
        [--print-tables] [--trace LOGDIR] [--metrics-json FILE]
        [--ensemble-kappa FILE] [--steady [--steady-method direct|cycle]]

    torchrun --nproc_per_node P -m radiative_transfer_tpu_torch.cli DECK
        --mesh GxX ...        (P = G*X ranks, one shard each)

Engines without ``--mesh``:

* ``general`` (the default, as in JAX): models/transport.solve, the
  readable scan-parallel path in plain PyTorch at ``--dtype`` (float64 by
  default);
* ``fast``: ops/fast_sweep.FastEngine, the tiled constant-coefficient
  scan in plain PyTorch at ``--dtype``;
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
* ``fast``: parallel/sharded_fast.ShardedFastEngine, FastEngine's tiled
  scan on the mesh in plain PyTorch at ``--dtype``;
* ``df``: DFHaloCudaEngine on the mesh (B14-B15); where its creep bound
  rejects the deck, exit 2;
* ``auto`` at float64: DFHaloCudaEngine on the mesh where its creep bound
  admits the deck, else, as in JAX, the sharded f64 engine it prints
  (``auto engine: df halo infeasible (<reason>); falling back to the
  sharded XLA f64 engine``): ShardedFastEngine at float64, or FastEngine
  at a one-rank mesh in one process;
* ``auto`` at float32: parallel.make_multichip_engine's mesh pick (halo
  where feasible, else fused at BDF2, else sharded), printed as ``auto
  engine: <Engine>``.

``pallas``, ``halo`` and ``fused`` are float32 engines; at ``--dtype
float64`` they print a note and run in float32, as the JAX CLI does.
``--device cuda`` (the default) runs on the card and fails with exit
code 2 when there is no CUDA device; ``--device cpu`` runs the general
engine and the kernels' plain PyTorch versions on the CPU.

The run-time flags work on every engine and mesh, with the JAX CLI's
semantics (utils/checkpoint.py, utils/debug.py, utils/diagnostics.py,
utils/profiling.py):

* ``--checkpoint-dir DIR`` writes ``ckpt_%09d.npz`` every
  ``--checkpoint-every`` steps (default 100) and resumes from the newest
  one (``--no-resume`` ignores them), printing ``resumed from step N``;
  the files cross between this package and the JAX package both ways;
* ``--balance-every K`` runs in K-step chunks and prints the per-group
  balance and step metrics after each (an argparse error, exit 2, with
  ``--checkpoint-dir``, whose chunking owns the loop);
* ``--check`` guards every chunk's ends (finite; with
  ``--check-positivity`` also positive) and aborts with the check named
  before any CSV or poisoned checkpoint is written;
* ``--print-tables`` prints every physics table and writes them as CSVs;
* ``--trace LOGDIR`` writes a torch.profiler Chrome trace of the solve
  (the kernels included on the card) to LOGDIR/trace_rank<r>.json;
* ``--metrics-json FILE`` writes the run's metrics as one JSON object.

``--ensemble-kappa FILE`` runs an opacity ensemble (K rows of G
opacities, whitespace-separated, # comments) as JAX's does: ``--engine
general`` vmaps the float64 general solver (ensemble.solve_ensemble);
``auto``, ``pallas``, ``fast`` and ``df`` run the K members stacked into
one problem of K*G groups (ensemble.solve_ensemble_stacked on auto,
single, fast and df; ``fast`` at ``--dtype``, the others their own
precision, so ``auto`` runs the float32 kernels even at float64, as in
JAX). Each member writes its 8 CSVs to OUTDIR/member_NNN/; ``--profile``
prints the aggregate rate. With ``--checkpoint-dir``, ``--balance-every``,
``--mesh`` or ``--check``, and with ``--engine halo``, it is an argparse
error (exit 2), as in JAX.

``--steady`` solves for the steady state directly instead of marching
(steady.run_steady_problem on FastEngine at ``--dtype`` on ``--device``):
``--steady-method direct`` (the default) is the spatial scheme's steady
state in one sweep (a few with the v/c correction), ``cycle`` the exact
fixed point of the deck's integrator by matrix-free GMRES. It prints
``steady solve (<method>): N sweeps|matvecs, residual R`` and writes the
same 8 CSVs. As in JAX it is an argparse error (exit 2) with
``--checkpoint-dir``, ``--balance-every``, ``--mesh``,
``--ensemble-kappa``, ``--steps``, ``--check`` and any ``--engine``, and
``--steady-method`` without ``--steady`` is one too.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _echo_inputs(cfg) -> None:
    """Byte-format replica of display_input_quantities
    (src/ParameterHandler.cpp:20-96): same lines, same default-`cout`
    number formatting (%g at 6 significant digits), same BC wording and
    blank-line placement. psi_source prints Eigen-style (column-aligned
    matrix; one value per line when G==1, matching a column vector)."""
    from .constants import SPEED_OF_LIGHT

    g = lambda v: f"{v:.6g}"  # noqa: E731 - cout's default double format
    bc_name = {0: "vacuum", 2: "reflective", 1: "source"}

    out = ["", "--- Input Parameters ---"]
    out.append(f"Angle quadrature order: {cfg.M}")
    out.append(f"Number of energy groups: {cfg.G}")
    if cfg.have_group_bounds:
        out.append("Group bounds (keV) specified in file: "
                   f"{cfg.filename_group_bounds}")
    else:
        out.append("Group bounds (keV) will be computed logarithmically, "
                   f"with first group edge at {g(cfg.efirst)} and last "
                   f"group edge at {g(cfg.elast)}")
    out.append(f"Slab thickness (cm): {g(cfg.X)}")
    out.append(f"Number of cells: {cfg.N}")
    out.append(f"Material density (g/cm^3): {g(cfg.rho)}")
    if cfg.have_group_absorption_opacities:
        out.append("Group opacities (cm^2/g) specified in file: "
                   f"{cfg.filename_group_kappa}")
    else:
        out.append("Group opacities will be set to the constant grey "
                   f"opacity (cm^2/g): {g(cfg.kappa_grey)}")
    out.append(f"Material temperature (keV): {g(cfg.T)}")
    out.append(f"Material velocity (cm/shake): {g(cfg.V)}")
    out.append(f"Beta: {g(cfg.V / SPEED_OF_LIGHT)}")
    out.append("Right boundary condition: "
               + bc_name.get(cfg.bc_right_indicator,
                             "Incorrect boundary conditions provided."))
    out.append("Left boundary condition: "
               + bc_name.get(cfg.bc_left_indicator,
                             "Incorrect boundary conditions provided."))
    out.append("")
    out.append("Psi_source: ")
    src = [[g(v) for v in row] for row in cfg.psi_source] or [[]]
    w = max((len(s) for row in src for s in row), default=0)
    for row in src:
        out.append(" ".join(s.rjust(w) for s in row).rstrip())
    print("\n".join(out))


def _echo_solver_tables(cfg) -> None:
    """Byte-format replica of the quadrature and energy-group tables the
    reference prints at Solver construction (src/solver.cpp:80-87,
    107-122): setw/left iostream layout, showpos on the quadrature
    values, %g-6 number formatting, same trailing blank lines."""
    from .ops.groups import build_group_grid
    from .ops.quadrature import gauss_legendre

    g = lambda v: f"{v:.6g}"        # noqa: E731 - cout default format
    gp = lambda v: f"{v:+.6g}"      # noqa: E731 - with showpos

    mu, wt = gauss_legendre(cfg.M)
    out = ["Mu".ljust(16) + "Wt".ljust(16),
           "--".ljust(16) + "--".ljust(16)]
    for i in range(cfg.M):
        out.append(gp(mu[i]).ljust(16) + gp(wt[i]).ljust(16))
    out.append("")

    grid = build_group_grid(cfg.G, cfg.efirst, cfg.elast,
                            cfg.group_bounds_array())
    out.append("Group Index".ljust(13) + "Average Energy".ljust(16)
               + "Upper Energy".ljust(14) + "Group Width".ljust(13))
    out.append("-----------".ljust(13) + "(keV)---------".ljust(16)
               + "(keV)-------".ljust(14) + "(keV)------".ljust(13))
    for gi in range(cfg.G):
        out.append(str(gi).ljust(13) + g(grid.e_ave[gi]).ljust(16)
                   + g(grid.e_edge[gi + 1]).ljust(14)
                   + g(grid.de_ave[gi]).ljust(13))
    out.append("")
    out.append("")
    print("\n".join(ln.rstrip() for ln in out))


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
                         "(default; with --mesh, on the mesh); fast: the "
                         "tiled fast engine at --dtype; pallas: the "
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
                    help="the general and fast engines' dtype; float32 "
                         "for the f32 engines; float64 (default) picks the "
                         "double-float engine under auto")
    ap.add_argument("--scan-tol", type=float, default=1e-10,
                    help="accuracy bound of the plain versions' truncated "
                         "prefix scan (neglected upwind tail a^(2^k)/(1-a) "
                         "< tol; 0 = full scan)")
    ap.add_argument("--profile", action="store_true",
                    help="print wall-clock and updates/s of the solve")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the CUDA kernels (default); cpu: their "
                         "plain PyTorch versions")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write .npz checkpoints here and resume from the "
                         "newest one (exact restart)")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="full timesteps between checkpoints")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints in --checkpoint-dir")
    ap.add_argument("--print-tables", action="store_true",
                    help="print every physics table (quadrature, groups, "
                         "Planck integrals, correction components) and "
                         "write them as CSVs to --outdir")
    ap.add_argument("--check", action="store_true",
                    help="numeric guards: verify the intensity state is "
                         "finite after every solve chunk (and at the end), "
                         "aborting with the failing check named (the "
                         "solver.cpp:609-612 assert analogue)")
    ap.add_argument("--check-positivity", action="store_true",
                    help="with --check, also enforce strictly positive "
                         "edge intensities (reference debug-build assert, "
                         "solver.cpp:402; off by default because vacuum "
                         "boundaries legitimately reach ~0)")
    ap.add_argument("--trace", default=None, metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace of the solve "
                         "(host operators, and the kernels on the card) to "
                         "LOGDIR/trace_rank<r>.json")
    ap.add_argument("--metrics-json", default=None, metavar="FILE",
                    help="write one JSON object of run metrics (wall "
                         "time, steps, updates/s, balance, engine/mesh/"
                         "dtype) to FILE")
    ap.add_argument("--balance-every", type=int, default=None, metavar="K",
                    help="run in K-step chunks, printing the per-group "
                         "balance diagnostic and step metrics after each "
                         "(every engine and mesh mode; incompatible with "
                         "--checkpoint-dir, whose chunking owns the loop)")
    ap.add_argument("--steady", action="store_true",
                    help="solve for the steady state DIRECTLY instead of "
                         "time-marching (steady.py): one modified sweep "
                         "(plus a short fixed-point iteration when "
                         "use_correction couples the source to psi); "
                         "writes the same CSV set")
    ap.add_argument("--steady-method", choices=("direct", "cycle"),
                    default="direct",
                    help="direct: the spatial discretization's steady "
                         "solution (exact BE/CN march limit); cycle: the "
                         "exact fixed point of the configured "
                         "integrator's full step map via matrix-free "
                         "GMRES, where a BDF2 march actually settles "
                         "(differs from direct by the reference's "
                         "predictor-corrector bias, docs/QUIRKS.md #16)")
    ap.add_argument("--ensemble-kappa", default=None, metavar="FILE",
                    help="opacity ensemble: FILE has K rows x G columns "
                         "(whitespace-separated, # comments); the members "
                         "run as one stacked problem (--engine general: "
                         "the vmapped f64 solver) and each writes its 8 "
                         "CSVs to OUTDIR/member_NNN/")
    args = ap.parse_args(argv)

    if args.balance_every and args.checkpoint_dir:
        ap.error("--balance-every and --checkpoint-dir both chunk the "
                 "solve loop; pick one")
    if args.steady_method != "direct" and not args.steady:
        ap.error("--steady-method requires --steady")
    if args.steady:
        # A steady solve has no time loop to checkpoint or chunk and no
        # marching engine to select: loud refusals, as the JAX CLI's.
        for val, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                          (args.balance_every, "--balance-every"),
                          (args.mesh, "--mesh"),
                          (args.ensemble_kappa, "--ensemble-kappa"),
                          (args.steps, "--steps"),
                          (args.check, "--check")):
            if val:
                ap.error(f"--steady does not support {name}")
        if args.engine != "general":
            ap.error("--steady has a single implementation (the tiled "
                     "f64/f32 sweep); drop --engine")
    if (args.balance_every is not None and args.balance_every < 1
            or args.checkpoint_every < 1):
        ap.error("--balance-every and --checkpoint-every take a positive "
                 "number of steps")
    if args.ensemble_kappa:
        # Loud refusal over a silent no-op, as the JAX CLI's.
        for val, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                          (args.balance_every, "--balance-every"),
                          (args.mesh, "--mesh"),
                          (args.check, "--check")):
            if val:
                ap.error(f"--ensemble-kappa does not support {name} "
                         "(use the library API ensemble.solve_ensemble"
                         "_stacked for meshes/custom loops)")
        if args.engine == "halo":
            ap.error("--ensemble-kappa supports --engine "
                     "general/fast/pallas/auto")
    if args.engine not in ("general", "fast", "pallas", "halo", "fused",
                           "df", "auto"):
        print(f"unknown --engine {args.engine}; use --engine general, "
              "fast, pallas, halo, fused, df or auto", file=sys.stderr)
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
    from .utils import profiling

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
    if is_p0:
        print(f"filename: {args.deck}")
        _echo_inputs(cfg)
        _echo_solver_tables(cfg)

    tables, grid, ct = transport.build_tables(cfg)
    if args.print_tables and is_p0:
        from .utils import diagnostics

        print(diagnostics.full_report(cfg, tables, grid, ct))
        for p in diagnostics.write_tables_csv(args.outdir, cfg, tables,
                                              grid, ct):
            print(f"wrote {p}")
    if cfg.include_validation and not transport.validate_tables(cfg, ct):
        print("Invalid Correction Terms", file=sys.stderr)
        return 1
    if args.ensemble_kappa:
        return _run_ensemble(args, cfg, tables, device)

    check_fn = None
    if args.check:
        from .utils.debug import make_ends_checker

        check_fn = make_ends_checker(positivity=args.check_positivity)
    t0 = time.perf_counter()
    with profiling.trace(args.trace, device):
        if args.steady:
            result, steps_run = _run_steady(args, cfg, device)
        else:
            if args.engine == "general":
                eng = _general_engine(args, cfg, tables, device)
            elif args.mesh:
                eng = _mesh_engine(args, cfg, tables, device, say)
            else:
                eng = _single_engine(args, cfg, tables)
            if isinstance(eng, int):
                return eng
            ends, resumed = _run(args, eng, cfg, tables, check_fn, say)
        _sync(device)
    wall = time.perf_counter() - t0
    if args.trace:
        say(f"wrote trace to {profiling.trace_path(args.trace)}")
    if not is_p0:
        return 0
    if not args.steady:
        result = transport.result_from_ends(cfg, tables, ends)
        # steps_run excludes any checkpoint-resumed prefix.
        steps_run = cfg.max_timesteps - resumed
    ups = profiling.updates_per_step(cfg) * steps_run
    if args.profile:
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

    if args.metrics_json:
        import json

        with open(args.metrics_json, "w") as f:
            json.dump({
                "deck": args.deck,
                "engine": args.engine,
                "mesh": args.mesh,
                "dtype": args.dtype,
                "steps_run": steps_run,
                "wall_s": wall,
                "updates_per_s": ups / wall if wall > 0 else None,
                "balance_max": float(bal.max()),
                "balance_mean": float(bal.mean()),
                "outputs": {n: os.path.abspath(p)
                            for n, p in paths.items()},
            }, f, indent=1)
            f.write("\n")
        print(f"wrote metrics to {args.metrics_json}")
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _GeneralEngine:
    """The general engine behind the engine protocol the chunked solve
    loops use (init_state/solve/ends; JAX cli.py:774-786's adapter): on one
    device transport.solve, on a mesh parallel/sharded.solve_sharded;
    its state is the global transport.State, on every rank."""

    def __init__(self, cfg, tables, mesh, dtype, device):
        from .parallel import sharded

        self.cfg, self.tables, self.mesh = cfg, tables, mesh
        self.dtype, self.device = dtype, device
        if mesh is not None:
            sharded._Blocks(cfg, mesh)   # ValueError where it cannot split

    def init_state(self):
        from .models import transport

        return transport.initial_state(self.cfg, self.tables)

    def solve(self, state=None, num_steps=None):
        from .models import transport
        from .parallel import sharded

        if state is None:
            state = self.init_state()
        if self.mesh is None:
            return transport.solve(self.cfg, self.tables, state, num_steps,
                                   self.dtype, self.device)
        return sharded.solve_sharded(self.cfg, self.tables, state, self.mesh,
                                     num_steps, self.dtype, self.device)

    def ends(self, state):
        return state.ends


def _run_steady(args, cfg, device):
    """--steady: the steady state directly (steady.run_steady_problem at
    --dtype on --device). Returns (the SolveResult, its sweeps or
    matvecs)."""
    from .steady import run_steady_problem

    result, sr = run_steady_problem(cfg, dtype=_dtype(args),
                                    method=args.steady_method, device=device)
    unit = "matvecs" if args.steady_method == "cycle" else "sweeps"
    print(f"steady solve ({args.steady_method}): {sr.iterations} "
          f"{unit}, residual {sr.residual:.3e}")
    return result, sr.iterations


def _general_engine(args, cfg, tables, device):
    """The general engine of --engine general (on --mesh, the mesh's), or
    an exit code."""
    dtype = _dtype(args)
    mesh = None
    if args.mesh:
        mesh = _mesh(args)
        if isinstance(mesh, int):
            return mesh
    try:
        return _GeneralEngine(cfg, tables, mesh, dtype, device)
    except ValueError as e:
        print(f"--engine general infeasible on --mesh {args.mesh}: {e}",
              file=sys.stderr)
        return 2


def _run(args, eng, cfg, tables, check_fn, say):
    """Solve on `eng`: in checkpointed chunks (--checkpoint-dir), in
    chunks streaming the balance (--balance-every), or straight. Returns
    (the final global ends, the step resumed from)."""
    resumed = 0
    if args.checkpoint_dir:
        from .utils import checkpoint as ckpt

        kw = dict(every=args.checkpoint_every, resume=not args.no_resume,
                  check_fn=check_fn)
        if isinstance(eng, _GeneralEngine):
            st, resumed = ckpt.solve_with_checkpoints(
                cfg, tables, eng.init_state(), args.checkpoint_dir,
                solve_fn=eng.solve, **kw)
        else:
            st, resumed = ckpt.solve_with_checkpoints_engine(
                eng, cfg, args.checkpoint_dir, **kw)
        if resumed:
            say(f"resumed from step {resumed}")
    elif args.balance_every:
        st = _engine_balance_loop(eng, cfg, args, tables, check_fn, say)
    else:
        st = eng.solve()
    ends = eng.ends(st)
    if check_fn is not None:
        check_fn(ends, cfg.max_timesteps)
    return ends, resumed


def _engine_balance_loop(eng, cfg, args, tables, check_fn, say):
    """--balance-every on every engine and mesh mode: run in K-step
    chunks, printing the per-group balance summary and step metrics after
    each (the reference prints balance only at the end,
    solver.cpp:275-282; here it doubles as a live health monitor)."""
    from .models import transport
    from .utils.profiling import StepMetrics, updates_per_step

    state = eng.init_state()
    metrics = StepMetrics(updates_per_step=updates_per_step(cfg))
    done, total, every = 0, cfg.max_timesteps, args.balance_every
    while done < total:
        n = min(every, total - done)
        t0 = time.perf_counter()
        state = eng.solve(state, num_steps=n)
        ends = eng.ends(state).to(torch.float64)
        _sync(ends.device)
        metrics.add(n, time.perf_counter() - t0)
        done += n
        if check_fn is not None:
            check_fn(ends, done)
        wt = torch.as_tensor(np.asarray(tables.wt), device=ends.device)
        phi = transport.compute_phi(transport.psi_from_ends(ends), wt)
        bal = transport.compute_balance(cfg, tables, ends, phi).cpu().numpy()
        say(f"step {done:>6d}: balance max={bal.max():.3e} "
            f"mean={bal.mean():.3e}   [{metrics.summary()}]")
    return state


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


def _dtype(args) -> torch.dtype:
    return torch.float64 if args.dtype == "float64" else torch.float32


def _run_ensemble(args, cfg, tables, device) -> int:
    """--ensemble-kappa (JAX cli.py's _run_ensemble): the K-row opacity
    table becomes a {'kappa': (K, G)} ensemble, run stacked on the engines
    (--engine general: the vmapped f64 solver); each member writes the
    reference's 8 CSVs (src/main.cc:117-133) to OUTDIR/member_NNN/ and a
    one-line balance summary."""
    from . import ensemble
    from .models import transport
    from .utils import io as io_mod
    from .utils.profiling import updates_per_step

    try:
        kappas = np.loadtxt(args.ensemble_kappa, ndmin=2, dtype=np.float64)
    except OSError as e:
        print(f"cannot read --ensemble-kappa table: {e}", file=sys.stderr)
        return 2
    if kappas.shape[1] != cfg.G:
        print(f"--ensemble-kappa needs G={cfg.G} columns per row, got "
              f"{kappas.shape[1]}", file=sys.stderr)
        return 2
    K = kappas.shape[0]
    params = {"kappa": kappas}
    eng_name = {"auto": "auto", "pallas": "single", "fast": "fast",
                "df": "df"}
    if args.engine != "general" and args.engine not in eng_name:
        print(f"--ensemble-kappa supports engines {sorted(eng_name)} (got "
              f"{args.engine!r})", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    if args.engine == "general":
        final = ensemble.solve_ensemble(cfg, tables, params, device=device)
    else:
        kw = ({"dtype": _dtype(args)} if args.engine == "fast"
              else {"scan_tol": args.scan_tol})
        final = ensemble.solve_ensemble_stacked(
            cfg, tables, params, engine=eng_name[args.engine],
            device=device, **kw)
    ends = final.ends.to(torch.float64)
    _sync(device)
    wall = time.perf_counter() - t0

    if args.profile:
        ups = updates_per_step(cfg) * cfg.max_timesteps * K
        print(f"wall: {wall:.3f} s for {K} members x {cfg.max_timesteps} "
              f"steps ({ups / wall / 1e6:.1f} M updates/s aggregate) on "
              f"{args.device}")
    x = (np.arange(cfg.N) + 0.5) * cfg.dx
    e_ave = np.asarray(tables.e_ave)
    for k in range(K):
        tab_k = ensemble._host_member_tables(cfg, tables,
                                             {"kappa": kappas[k]})
        res = transport.result_from_ends(cfg, tab_k, ends[k])
        sub = os.path.join(args.outdir, f"member_{k:03d}")
        io_mod.write_solution_csvs(sub, res, x, e_ave)
        bal = res.balance.cpu().numpy()
        print(f"member {k:3d}: balance max {bal.max():.3e} "
              f"mean {bal.mean():.3e} -> {sub}")
    print(f"wrote {K} member output sets under "
          f"{os.path.abspath(args.outdir)}")
    return 0


def _single_engine(args, cfg, tables):
    """The one-device engine of --engine (no --mesh), or an exit code."""
    from .ops.cuda_df import DFCudaEngine
    from .ops.fast_sweep import FastEngine
    from .parallel import make_multichip_engine

    engine = args.engine
    if engine == "fast":
        return FastEngine(cfg, tables, dtype=_dtype(args),
                          device=args.device)
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
    # Each engine takes what it accepts (dtype: the fast engine's).
    kw = dict(scan_tol=args.scan_tol, dtype=_dtype(args), device=device)
    if engine == "df" and not f64:
        say("note: --engine df is f64-grade; building its tables at "
            "float64 despite --dtype float32")
    elif engine in ("pallas", "halo", "fused") and f64:
        say(f"note: the {engine} mesh engine is float32-only")
    pick = {"pallas": "pallas", "halo": "halo", "fused": "fused",
            "fast": "fast", "df": "df_halo",
            "auto": "df_halo" if f64 else "auto"}[engine]
    try:
        eng = make_multichip_engine(cfg, tables, mesh, engine=pick, **kw)
    except ValueError as e:
        if engine == "auto" and f64:
            # The f64 fallback, as JAX's: its sharded XLA engine, or at a
            # one-rank mesh in one process the plain fast engine.
            say(f"auto engine: df halo infeasible ({e}); falling back to "
                "the sharded XLA f64 engine")
            eng = _fast_mesh_engine(args, cfg, tables, mesh, device)
            if isinstance(eng, int):
                return eng
        elif engine in ("df", "fast"):
            print(f"--engine {engine} infeasible for this mesh workload: "
                  f"{e}", file=sys.stderr)
            return 2
        else:
            print(f"--engine {engine} infeasible for this workload: {e}\n"
                  "fall back to --engine pallas (per-substep exchange)",
                  file=sys.stderr)
            return 2
    if engine == "auto":
        say(f"auto engine: {type(eng).__name__}")
    return eng


def _fast_mesh_engine(args, cfg, tables, mesh, device):
    """auto's f64 fallback on a mesh: FastEngine at a one-rank mesh in one
    process, else ShardedFastEngine, at --dtype; or an exit code."""
    from .ops.fast_sweep import FastEngine
    from .parallel import distributed
    from .parallel.sharded_fast import ShardedFastEngine

    if mesh.size == 1 and distributed.process_count() == 1:
        return FastEngine(cfg, tables, dtype=_dtype(args), device=device)
    try:
        return ShardedFastEngine(cfg, tables, mesh, dtype=_dtype(args),
                                 device=device)
    except ValueError as e:
        print(f"--engine auto infeasible for this mesh workload: {e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    rc = main()
    from .parallel import distributed
    distributed.shutdown()
    sys.exit(rc)
