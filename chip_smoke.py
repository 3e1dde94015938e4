#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, one line each; any failure exits nonzero before the result line:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compile csrc/*.cu with nvcc for sm_90a (radiative_transfer_tpu_torch
   /_build/) and print its seconds, each nvcc command's seconds and the
   compiler's register report; then build the host I/O library
   csrc/rtio.cc with the C++ compiler on PATH (native.py; every CLI run
   below reads its deck and writes its CSVs through it) and print its
   seconds;
3. kernel parity: each CUDA kernel (B1 bdf2, B2 multistep, B3 substep) on
   seeded random states against its plain PyTorch version on the same card,
   max error over max magnitude <= 1e-5 (the kernels scan exactly, the plain
   versions truncate to scan_tol = 1e-10; the rest is f32 rounding); B3's
   look-back on its own shapes (BE, CN and BDF, reflective and source left:
   a row below one tile, a ragged last tile, whole tiles, 40 tiles, a
   169984-cell row by check_f64, the llnl deck's Bh = 124, N = 50 rows,
   and the bench shape (gray S_32, N = 2^20, reflective) at TOL, or by
   check_f64 where the float32 plain version itself lies above TOL from
   float64), REPEAT launches each, the worst held; step() at BE and CN
   within STEP_TOL of multi_step(st, 1);
4. main path: the port's CLI with --engine pallas --device cuda on
   prm/llnl_slab_test.prm (2 steps), prm/single_group.prm (200 steps) and its
   BE and CN variants, plus BE/CN engine.step() calls; the 8 CSVs must be
   finite and agree with the same CLI run on the CPU (plain versions)
   within the f32 drift of two trajectories (5e-5, see DRIFT_TOL);
5. full size: the bench.py workload (gray S_32, N = 2^20, BDF2, Courant 0.4,
   reflective left, source right): three windows of 64 steps after a
   two-launch warm-up, timed with CUDA events; prints the median updates/s,
   the plain version's time for one K-step launch at the same shape and
   the peak device memory above what the phase started with, and B1's
   and B2-CN's launch shapes at that size (rows x blocks a row x tiles;
   more than one block a row) and B3's (rows x tiles); then the same
   workload at BE and CN through step() (one B3 launch a step) and at CN
   through solve() (B2, K = 16), timed likewise;
6. tiny-batch auto route (the packed-rows halo engine, B4 and B5): B4's
   cluster wavefront (one cluster a packed row, the seeded chain's first
   tile taking its mail before it reseeds) on its own shapes, each launched
   REPEAT = 5 times, the launches bit-identical and within TOL of the plain
   version (check_f64 where that one lies above TOL from float64): a reset
   cell off the 4096-cell tile (a halo chain ending in a ragged tile that
   sends), reset 0, a halo chain of one tile (shorter than C), one of 5
   tiles at C = 4 (T_h >= C), a seeded chain of C + 1 tiles with a ragged
   last tile, packed rows 2 and 32, K 1, 2 and 8, both half modes; the CLI
   with --engine auto --dtype float32 on prm/single_group.prm (routes to
   the plain engine) against its CPU run; HaloCudaEngine against
   CudaSweepEngine at the benchmarks/suite.py gray_s8 shape (S_8 gray,
   Bh = 4, N = 2^18, Courant 0.4, reflective left) for BDF2, BE and CN, 64
   steps, ends, prev and half within DRIFT_TOL (and whether every plane is
   bit-equal, printed); then gray_s8 through
   make_multichip_engine("auto"), which must pick HaloCudaEngine, timed as
   in phase 5 beside B4's row walk, and the same workload on
   CudaSweepEngine; B4 at gray_s8's main launch held as its own shapes,
   and its grids at the main and fixup launches (rows x blocks a row x
   tiles; more than one block a row at the main launch); whether
   HaloCudaEngine is bit-equal to CudaSweepEngine at every kind, printed;
   gray_s8 at CN on HaloCudaEngine (auto's pick, B5) and CudaSweepEngine
   (B2), timed likewise beside B5's row walk; B5 at gray_s8's CN main
   launch held as its own shapes in phase 3, and its grids at the main and
   fixup launches (more than one block a row at the main launch);
7. f64-grade path (the double-float engine, B6 and B7): the CLI with
   --engine df on prm/single_group.prm (200 steps) and its BE and CN
   variants, prm/multi_group_equilibrium.prm (200 steps) and
   prm/llnl_slab_test.prm (2 steps), each within DF_CLI_TOL of its CPU run;
   --engine auto at the default float64 must print the df line; the
   equilibrium deck (single_group.prm with psi_source = B) must keep
   max|F| / B < 1e-12 after 200 steps; then the bench workload and gray_s8
   on DFCudaEngine, timed as in phase 5, beside the row walk's rates (see
   WALK_RATES), with B6's
   grid at both (rows x blocks a row; more than one block a row) and B7's
   at CN at both (the engine's K; more than one block a row);
8. f64 tiny-batch route (the packed-rows double-float halo engine, B14 and
   B15): B14 and B15 against their plain versions to DF_TOL in hi + lo
   (packed rows 2 and 32, a segment and a reset cell off the kernel's
   2048-cell tile, reset 0 and > 0, K 1 and 2 for BDF2 in both half modes,
   K 1 and 3 for BE and CN); B14's cluster wavefront (one cluster a chain)
   on its own shapes, each launched REPEAT = 5 times, the worst held to
   DF_TOL and the launches bit-identical (a reset cell off the tile with a
   ragged halo chain, reset 0, a seeded chain of C + 1 tiles behind a halo
   chain shorter than C, K 1, 2 and 4, both half modes, use_correction on
   and off, and gray_s8's main launch), and B14's grid at gray_s8's main
   and fixup launches (clusters x blocks a chain x tiles a chain; more than
   one block a chain); B15's cluster wavefront (one cluster a packed row,
   take-and-reseed) on its own shapes likewise (a ragged halo chain that
   sends, reset 0, a halo chain of 4 tiles at C = 3, a seeded chain of
   C + 1 tiles behind a one-tile halo chain, packed rows 2 and 32, BE and
   CN at K 1, 3 and 8, use_correction on and off); then the path: the CLI
   with --engine auto at
   the default float64 on a tiny-batch deck thick enough for the creep bound
   (single_group.prm at N = 2048, X = 20.48), which must print JAX's df halo
   line, within DF_CLI_TOL of its CPU run; DFHaloCudaEngine against
   DFCudaEngine at gray_s8 for BDF2, BE and CN, 64 steps, ends, prev and
   half within DF_TOL in hi + lo (and whether every plane is bit-equal,
   printed);
   then gray_s8 BDF2 through make_multichip_engine(engine="df"), which must
   pick DFHaloCudaEngine, timed as in phase 5, and on DFCudaEngine, beside
   the row walk's rates; gray_s8 at CN likewise on both engines (B15 and
   B7 their kernels); B15 at gray_s8's CN main launch held as its own
   shapes, and its grids at the main and fixup launches (more than one
   block a row at the main launch); DFCudaEngine's CN rate beside B7's row
   walk;
9. the adjoint path (B9 forward-with-records, B10 transposed step): B9 and
   B10 against their plain versions (planes and cbc <= 1e-5, gradient packs
   <= 1e-4 of their largest magnitude) for BE, CN and BDF2, reflective and
   source left, rows of 4 record tiles (13 B10 sub-tiles) and a ragged
   single tile; B10's cluster wavefront on its own shapes, each launched REPEAT =
   5 times, the worst held as check_f64 holds phase 3's wavefront shapes
   (both against the plain version evaluated in float64, the kernel within
   the float32 plain version's distance plus those bars) and the launches
   bit-identical
   (one record tile of fewer sub-tiles than blocks a row, C + 1 sub-tiles,
   a ragged last sub-tile at N = 52736, BE and CN at one block a row; both
   boundaries, both half modes); B9's step against B1's (B2's for BE/CN)
   at K = 1 (the same tiles' arithmetic, B9's carries composed by its
   look-back: held to 1e-6, or where above it by check_f64); B9's
   look-back scan on its own shapes (BE, CN, BDF2; both boundaries, both
   half modes; a row below one tile, one tile, T = 2, a ragged last tile
   at N = 52736, 2^18 cells with T above 32, Bh = 1), each launched REPEAT
   times, the worst held by check_f64 (planes and the records at the
   record tiles) and B10 run from its records by check_f64 (packs 1e-4);
   a transposition check
   independent of the plain versions (with Sb = c0 = 0 and bc = 0 the step
   is a linear map A of the state: <c, A d> = <B10(c), d> within 1e-5, for
   random d and c = A d); make_diff_solve_cuda(steps_per_launch=1)
   gradients on the card against the same call on the CPU (gray
   off-equilibrium, M = 4, N = 4096, 8 steps: value 1e-5, kappa 2e-3,
   psi_source 1e-4); then the path at benchmarks/adjoint_bench.py's chip
   shape (gray S_32, N = 2^17, BDF2, 96 steps): value_and_grad of
   sum(ends^2) * 1e-3 through make_diff_solve_cuda at K = 1 against the
   same 96 steps forward on CudaSweepEngine at its K, three CUDA-event
   windows each, the grad/forward ratio (beside the row walk's) and peak
   device memory, and B10's grid there (rows x blocks a row x sub-tiles;
   more than one block a row) and B9's (rows x tiles, one block a tile,
   the blocks a multiprocessor holds; more than one tile a row);
10. the K-fused adjoint (B11 K-step forward with records, B12 transposed
   K-step launch): B11 and B12 against their plain versions (the
   intermediate inputs with the planes; bars as phase 9) at K = 2, 3 and 4,
   reflective and source left, both half modes, a 13-tile row with a ragged
   last tile (N = 52736), 4-tile rows (N = 12800, one at K = 2), N = 5000
   and N = 100; B12's cluster wavefront on its own shapes as B10's in
   phase 9 (one record tile at K = 4, C + 1 sub-tiles at K = 1 and 2, N =
   52736 at K = 3 and 4, and K = 16 on Bh = 4 rows, where the blocks a row
   reach their cap of 16), the REPEAT launches bit-identical, packs
   included; B11's cluster wavefront on its own shapes (T = C + 1 tiles at
   K = 2 and 4, a 13-tile row with a ragged last tile at K = 3, a row below
   one tile, K = 16 on Bh = 4 rows), each launched REPEAT times, the
   launches bit-identical and the worst held by check_f64; B11 against B1
   at the same K (all six planes bit-equal) and B11's records and
   intermediate inputs against K chained B9 launches (within 1e-5; on
   B11's own shapes, the long rows, both by check_f64 against the float64
   plain version, the records at the record tiles), both held on every
   B11 shape; the transposition check <c, A d> = <B12(c), d>
   within 1e-5;
   K-fused against K = 1 gradients on the card within 1e-4 (JAX's
   test_kfused_gradients_match_k1 at N = 4096) and remat groups of K-step
   launches against none within 1e-4; card against CPU gradients at the
   K-fused default at phase 9's bars; the adjoint bench in turns: the
   forward, value_and_grad at K = 1 and at the K-fused default (K = 4),
   printed as fwd_seconds, grad_k1_seconds, grad_kfused_seconds and both
   ratios to the forward (beside the row walk's), with the K-fused step's
   peak memory and B11's and B12's grids there (more than one block a
   row); and 3
   fit_params(solver="pallas") iterations at that shape on the K-fused
   default (the off-equilibrium boundary source from 20% above it, the
   loss scaled to 1 at the start), every loss finite.
11. B8, the per-sub-step mesh engine's zero-inflow kernel (one block a
   512-cell tile, the tiles chained by decoupled look-back): BE, CN and BDF
   against its plain version with nonzero pending corrections and halo
   tails, each shape launched REPEAT = 5 times and the worst held: packed
   rows 32 at N = 4096 (8 tiles) and N = 26624 (52), <= 1e-5; rows 2 at N
   = 384 (below one tile), <= 1e-5, and at N = 131328 (256 full tiles and a
   ragged 257th) by check_f64; on the llnl-shipped rung's
   shard (rows 248, N_loc = 2^13), where the float32 plain version itself
   lies above 1e-5 from its float64 evaluation, within that distance plus
   1e-5 of the float64 evaluation (check_f64); timed at the gray rung's
   shape (rows 32, N_loc = 2^20, BDF) and at the llnl-shipped one, with
   its grid at the gray shard (more than one block a row);
12. B13, the fused engine's one-step kernel (one block a 1024-cell tile,
   the two cycles' eight sub-steps chained by a multi-slot decoupled
   look-back), both variants (the step and materialize_only) and both half
   modes against its plain version, and on its own shapes (a row below one
   tile, one tile, T = 2, a ragged last tile, 2^18 cells with T above 32,
   rows 2), each launched REPEAT times, the worst held by check_f64; both
   variants at the llnl-shipped shard as B8 there; timed at the gray
   rung's shape and at the llnl-shipped one, with its grid at the gray
   shard (more than one tile a row);
13. the mesh path (benchmarks/weak_scaling.py's rungs): the gray rung (S_32,
   G = 1, BDF2, Courant 0.4, 2^20 cells a shard) and the llnl-shipped rung
   (the 124-group LLNL deck at its own dt = 1e-3, 2^13 cells a shard) at a
   one-rank mesh on ShardedCudaEngine (B8), FusedExchangeCudaEngine (B13;
   its gray rate printed beside the one-block-a-row B13's)
   and, where its creep bound admits the rung (gray), HaloCudaEngine,
   beside CudaSweepEngine: ends, prev and half within 1e-5 of
   CudaSweepEngine after 8 steps (gray) and the deck's own 2 steps (llnl);
   64 steps timed (updates/s, peak memory; the row walk's gray rates
   beside them; B4's grid at the gray rung, more than one block a row),
   the 64-step drift within 5e-5
   where the reference's 64-step state stays inside bench.py's guard
   (finite, max|x| < 1e3; llnl leaves it), recorded where it does not;
   then two processes sharing the card over gloo (a check of the exchanges
   on the real kernels, not a scaling figure), each case of rank_cases at
   two shards against one rank: the gray rung (sharded, halo) and the LLNL
   deck at dt = 1e-5 at the llnl-shipped shard size (sharded, fused) within
   1e-5, the double-float halo engine on gray_s8 within DF_TOL, and the
   llnl-shipped rung recorded beside its witness (each float32 result's
   distance from DFCudaEngine); and the CLI with --mesh 1x1 for pallas,
   fused and auto (prm/single_group.prm) and halo (its thick variant,
   N = 2048, X = 20.48) against its CPU run;
14. the general f64 path (models/transport.py on ops/sweep.py and
   ops/scan.py, plain PyTorch with no kernel of its own): the CLI's
   default engine on the three shipped decks and single_group.prm at BE and
   CN, its CSVs within 1e-12 (F against max|phi|) of its CPU run, and on
   each the CLI's --engine pallas (B1, B2) within 5e-5 and
   run_problem(engine="df") (B6, B7) within 1e-10 of the card's general
   run, each of the four kernels launched there; the bench workload (gray
   S_32, N = 2^20, BDF2) at float64 and float32, 8 steps after 1 timed with
   CUDA events, with peak memory, the float64 state within 1e-10 of
   DFCudaEngine's; one make_diff_solve value and kappa gradient at the
   adjoint bench (N = 2^17, 96 BDF2 steps, remat) timed against the
   forward, with peak memory, within 1e-5 of phase 9's kernel adjoint
   (the value, and the kappa gradient as a sensitivity of the loss: at
   equilibrium it cancels to roundoff); and parallel/sharded.solve_sharded
   on two ranks sharing the card over gloo (`chip_smoke.py
   --general-worker` children: gray S_32 at 2^16 cells on 1x2, the
   multigroup deck at 4096 cells on 2x1) within 1e-12 of one rank.
15. A8's utilities (utils/checkpoint.py, utils/debug.py,
   utils/profiling.py and the CLI flags on them): the bench workload
   (gray S_32, BDF2) cut to A8_BENCH_N = 2^18 cells on CudaSweepEngine
   (B1, K = 4) from a seeded state, 5 steps straight against a run killed
   at step 3 with a checkpoint every 3 and resumed (chunks of 3 and 2 that
   do not divide K; two saves, each ~10 s of host zlib), bit-equal, with each save's and load's seconds, the
   checkpoint's bytes and the peak memory; through the CLI, 8 steps
   straight against killed at 6 (every 3) and resumed, on the general
   engine, pallas at CN (B2), halo at BDF2 and CN (B4, B5), df (B6, B7)
   and auto at float64 on the thick tiny-batch deck (B14, B15), each
   bit-equal, and on --mesh 1x2 with two ranks sharing the card
   (`chip_smoke.py --a8-worker` children) for general (bit-equal, and to
   one rank), pallas (B8) and fused (B13) within 1e-6 (bit-equality
   printed), and df (B14, B15) bit-equal; the card's general checkpoint
   resumed on the CPU within 1e-12; --balance-every, --check --check-positivity (a healthy
   run, and a checkpoint poisoned with a NaN aborting with no CSV),
   --metrics-json (the JAX CLI's keys) and --trace (a Chrome trace naming
   bdf2_kernel); B1, B2, B4-B8 and B13-B15 each launched in the phase.
16. ensembles (ensemble.py) and the fast engine (ops/fast_sweep.FastEngine,
   adjoint.make_diff_solve_fast; plain PyTorch, no kernel of their own):
   benchmarks/suite.py's gray_s8 with ENS_K = 8 seeded opacity members
   (kappa x U(0.5, 2)) from a seeded shared state, through
   ensemble.solve_ensemble_stacked on auto (the stacked Bh = 32 on
   CudaSweepEngine: B1 at BDF2, B2 at CN) and df (DFCudaEngine: B6, B7),
   each member against its own solve alone (auto's HaloCudaEngine, B4/B5;
   df's DFHaloCudaEngine, B14/B15): bit-equal, or within STEP_TOL (DF_TOL
   in hi + lo) with the reason printed; the stacked engine's 64 steps and
   each solo solve timed with CUDA events (median of 3 windows; aggregate
   and solo updates/s);
   the CLI's --ensemble-kappa (K = 4 on single_group.prm moving and its
   thick variant at BDF2 and CN, where auto and df pick the halo engines;
   K = 2 on prm/llnl_slab_test.prm, 2 steps) through pallas, auto, df,
   fast and general, every member's CSVs against the same CLI on the CPU
   (5e-5, df 1e-10, general and fast 1e-12); FastEngine at the bench at
   float64 and float32 from a seeded state against the general engine
   (1e-12; float32 5e-5), rates and peak memory; make_diff_solve_fast's
   value and dL/dkappa at the adjoint bench against make_diff_solve's
   (1e-10), grad/forward and peak memory, and card against CPU at N =
   4096 (1e-10); solve_ensemble (torch.func.vmap of the general solver) at
   K = 4 on gray_s8 cut to N = 2^14 against its member loop (1e-12); two
   ranks sharing the card (`chip_smoke.py --ensemble-worker` children):
   solve_ensemble on a one-axis mesh (1e-12) and the stacked members
   through auto on a 2x1 mesh (1e-5, bit-equality printed) against one
   rank; B1, B2, B4-B7, B14 and B15 each launched in the phase.
17. steady state (steady.py) and the sharded fast engine
   (parallel/sharded_fast.py; plain PyTorch, no kernel of their own):
   solve_steady at the bench (gray S_32, N = 2^20) at float64 and float32,
   finite, timed and its peak memory read, a fixed point of the dt-free BE
   sub-step to its own tol, and at N = 2^14 within 1e-12 (float32 5e-5) of
   the same call on the CPU; solve_steady_cycle on gray S_32 rows of 2^16
   cells at BE and CN (equal to solve_steady within 1e-12) and of 2^6
   cells at BDF2 (matvecs, seconds, residual < 1e-10); the CLI's --steady and --steady-method
   cycle on every shipped deck against the CPU (1e-12), with the sweeps or
   matvecs and seconds; the card's --steady on single_group.prm against a
   BE march (dt = 1) on --engine df run until it no longer moves (1e-10);
   two ranks sharing the card (`chip_smoke.py --fast-mesh-worker`
   children): ShardedFastEngine at the bench (float64, 8 steps) at 1x2
   and 2x1 against FastEngine on one device (1e-12), updates/s and peak
   memory a rank, and in the same ranks --engine fast --mesh 1x2 killed
   and resumed (byte-equal CSVs), --balance-every 2, and --engine auto at
   float64 on --mesh 1x2 with the LLNL deck at its shipped dt (the df halo
   infeasible: JAX's fallback to ShardedFastEngine, within 1e-12 of the
   single-device --engine fast CLI).
18. the native I/O (native.py, csrc/rtio.cc) and the plot reader
   (plot.py), host code with no kernel of its own: native.available()
   (no C++ compiler is a failure); the CLI on prm/single_group.prm with
   --engine pallas on the card, its deck read and its 8 CSVs written
   through the library (by its call counts, zeroed just before) and
   byte-equal to the same result written by the Python writers; a float32
   psi of 32 x 1 x 2^18 values made on the card, written and timed through
   both writers (host seconds, with the host CPU's model), byte-equal;
   plot.read_solution on the CLI's CSVs within rtol 1e-12 of the result;
   plot_solution's 5 PNGs where matplotlib is installed (else a line says
   it did not run).
19. the worked examples (radiative_transfer_tpu_torch/examples/, ROADMAP
   A16), each through its main() on the card at its shipped size, every
   wrapper's launch count zeroed just before it and read just after:
   gray_equilibrium (1000 BDF2 steps on the general engine; its return
   code 0: max F < 1e-6), multigroup_correction (FastEngine f64, the 8
   CSVs), llnl_production (auto selection, checkpoints every 10 steps
   and a resume from step 20; B1 or B4 launched), reference_precision
   (N = 2^14, 400 steps: the f32 drift <= 3e-5, the df and df-halo drift
   <= 1e-11, B1, B6 and B14 launched; fit_params(solver="pallas") on B11
   and B12, the recovered kappa printed beside its target),
   inverse_opacity (cut to 40 Adam iterations of its 400, EXAMPLE_CUTS;
   worst kappa error < 0.05, the JAX example's PASS bar, which it reaches
   on a CPU at the same arguments) and uncertainty (|ratio - 1| < 4/sqrt(2K) + 0.15, likewise);
   multichip on two ranks sharing the card over gloo (EXAMPLE_RANKS
   children, run while the other examples run in this process; its
   asserts: ShardedFastEngine within 1e-12 of FastEngine,
   the f32 mesh route within 2e-3) with each rank's launches; each
   example's seconds and figures. And, in two child processes of their
   own (`chip_smoke.py --remat-worker OUT 1|0`, one an arm) run while the
   examples run, the peak device memory of
   torch.func.vmap(torch.func.grad(...)) over make_diff_solve for
   REMAT_PEAK's 8 opacity members at 2^14 cells and 64 BDF2 steps (the gray
   S_2 slab off equilibrium, a source of 2), with
   remat on (adjoint._RematStep) and off: remat on must peak lower, and
   the gradients agree within 1e-12. And make_diff_solve_cuda at
   steps_per_launch 65 and 100 (each K-step group split into launches of
   64 steps and the rest) over 130 BDF2 steps: value and gradients within
   1e-4 of its K = 4 solve, B11 launched 64-step pieces.

After each phase a line gives its seconds and the run's so far.

Phase 3 also holds B4 and B5 against their plain versions (rows 2 and 8, a
segment and a reset cell off the kernel's tile, reset 0 and > 0, K 1/3/8
and 16 for BE/CN, both half modes), and B6 and B7 against theirs to
DF_TOL in hi + lo (B6 with both half modes, reflective and source left, K 1,
3 and the engine's, on an N off the kernel's tile and on N = 100; B7 BE and
CN with K 1, reflective and source left, and K 8). B6's cluster wavefront
is held on its own shapes too, each launched REPEAT times and the worst
held: a row of one 2048-cell tile, 3 tiles (as many blocks a row as
tiles), T = C + 1 tiles at K = 1 and 2 (C the blocks a row that
df_bdf2_geometry picks), 19 tiles with a ragged last one at K = 3 and the
engine's K; reflective and source left, both half modes, use_correction
on and off. B1's and B2's cluster wavefronts likewise, each shape
launched REPEAT times and the worst held by check_f64 (on 170k-cell rows
the float32 plain version itself lies above 1e-5 from its float64
evaluation): 41 whole tiles and a ragged one (T >= 2C) for B1 at K = 1,
4, 8 and B2 BE at K = 5 and CN at K = 16, a row below one tile for B1 at
K = 3 and B2 BE/CN at K = 1 and 3, 10 tiles for B2-CN at K = 1 (one
block a row, sending to itself); both boundaries, both half modes. B5's
cluster wavefront (B2's body on one cluster a packed row, take-and-reseed)
on its own shapes likewise, the worst held to TOL (check_f64 where the
float32 plain version lies above it): a ragged halo chain that sends, reset
0 (at K = 1 a one-block cluster), a one-tile halo chain shorter than C, a
halo chain of 5 tiles at C = 3, a seeded chain of C + 1 tiles, packed rows
2 and 32, BE and CN at K 1, 3 and 16 (and gray_s8's CN main launch in
phase 6). B7's (B15's body under OneChain) likewise, the worst held by
check_f64's rule against B7's function in float64 (df_truth) with DF_TOL,
the launches bit-equal to B15 on the same tiles: a row of one tile,
T = C + 1 tiles at K = 8 and at K = 1, 19 tiles with a ragged last at
K = 3, 83 tiles at K = 16; BE and CN, reflective and source left,
use_correction on and off. Every kernel wrapper's
launch count is zeroed before a path's phases and read after them: each
kernel of a path must have launched on it (B1-B3 on phases 4-5, B4-B5 on
phase 6, B6-B7 on phase 7, B14-B15 on phase 8, B9-B10 on phase 9,
B11-B12 on phase 10's K-fused grad steps and fit, B8 and B13 on phase 13;
phase 15 zeroes them again and needs B1, B2, B4-B8 and B13-B15).
With --mesh-worker OUT P STEPS the script is instead one rank of a
P-rank run (phase 13 starts two), with --general-worker OUT one rank of
phase 14's two-rank run, with --a8-worker DIR one rank of phase 15's,
with --ensemble-worker OUT one rank of phase 16's, with --fast-mesh-worker
OUT P DIR one rank of a ShardedFastEngine run (phase 17's two, or --ranks
P's), with --remat-worker OUT 1|0 one arm of phase 19's vmap(grad)
peaks (remat on or off). With --ranks P it runs only the mesh
path on P ranks, one a card where the host has P cards (NCCL), else
sharing them (gloo): every case of rank_cases at P shards against one
rank, the gray rung's weak scaling, the CLI under torchrun --mesh 1xP
against the single-device CLI, ShardedFastEngine at the bench at 1xP
and 2x(P/2) against FastEngine on one device, and the multichip example
on P ranks; --ranks P fast runs only ShardedFastEngine (see
ranks_check).
Then each kernel is timed against its plain version at its full-size shape,
beside its bound (the larger of the bytes it must move over 3.35 TB/s and
the operations it must do over 67 TFLOP/s f32, the H100 SXM data-sheet
peaks), and the redesigned kernels' shape choices are timed: B1 at the
bench at K = 1, 4, 8 and B2-CN there at K = 8, 16, each at the blocks a
row the geometry picks and at half as many; B6 at the df bench at K = 1,
2, 4 with 512 and 256 threads a block, at gray_s8 with at most 16 and 8
blocks a row; B14 at gray_s8 with at most 16 and 8 blocks a chain, and
its seeded and halo chains as two launches would run them; B4 at gray_s8's
and the gray rung's main launches, B15 and B5 at gray_s8's CN main launch
and B7 at the df bench's CN shape, each at the blocks a row the geometry
picks and at half as many; B11 at
the adjoint bench at the blocks a row the geometry picks and at half as
many; B3 at the bench (BE, CN, BDF) with 32-512 threads; B8 at the gray
shard with 32-512 threads; B9 at the adjoint bench with 32-512 threads;
B13 at the gray shard with 32-128 threads and its materialize_only
variant; B10 and B12 (K = 4) at the
adjoint bench with 256 and 128 threads a block, each at the blocks a row
the geometry picks and at half as many.
Lines set B3's (at BE, CN and BDF, beside their bounds), B4's, B5's,
B7's, B9's, B11's, B13's, B14's and B15's times (and the step(),
HaloCudaEngine and DFCudaEngine rates they carry) against their one-block
row walks'.
A line splits each kernel's launches on its path's phases into those at
the shape it is timed at and the rest. The last lines are the kernels
JSON, the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
# End to end, two f32 trajectories drift apart: over 200 steps of
# single_group.prm the plain versions on the CPU (every product rounded
# separately) drift 1.3e-5 from the JAX package's f64 solution, its f32
# Pallas kernel 2.8e-6 (measured on the CPU). The CSVs of the GPU run are
# held to the CPU run's within 5e-5.
DRIFT_TOL = 5e-5
# The double-float kernels against their plain versions, per launch, in
# max|d(hi + lo)| / max|hi + lo| (float64): both land within double-float
# roundoff of the exact sub-step whatever scan the base solve ran. The
# CLI's CSVs on the card against its CPU run: 1e-10 (trajectories of the
# f64-grade engine drift ~1e-13 a step from float64).
DF_TOL = 1e-11
DF_CLI_TOL = 1e-10
# The general engine in float64 on the card against its own CPU run, and on
# two ranks against one: the same float64 arithmetic in other kernels and
# reduction orders (the JAX package's general engine agrees with the
# port's CPU run to ~5e-15 after 20 steps, tests/test_torch_general.py).
GENERAL_TOL = 1e-12
# The kernel adjoint's (float32, make_diff_solve_cuda) value and kappa
# gradient against the general engine's float64 ones at the adjoint bench's
# shape, from a seeded state off equilibrium: JAX's bars for its f32 adjoint
# against its f64 one (tests/test_pallas_adjoint.py), 1e-5 on the value and
# 1e-4 on a gradient, relative to its own magnitude.
ADJ_TOL = 1e-5
ADJ_GRAD_TOL = 1e-4
# make_diff_solve on the card against the same call on the CPU (float64
# both): value and every gradient relative to its own magnitude, the bar of
# its CPU test against jax.grad (tests/test_torch_general_adjoint.py).
GENERAL_GRAD_TOL = 1e-10
# Phase 14's full-size shapes: the bench (gray S_M, N cells, BDF2; 8 steps
# timed after 1) and the adjoint bench (S_M, N cells, `steps` BDF2 steps);
# the adjoint's card-vs-CPU check at a cut N (S_M, N cells, `steps` steps).
GENERAL_BENCH = (32, 1 << 20, 8)
GENERAL_ADJ = (32, 1 << 17, 96)
GENERAL_ADJ_CPU = (32, 4096, 16)
# step() at BE and CN (B3's look-back) against multi_step(st, 1) (B2's
# wavefront) on the same state: exact scans over other tiles, composed in
# another order, so rounding apart (B9 against B1/B2 at K = 1 has the same
# bar).
STEP_TOL = 1e-6
# Phase 15, A8's utilities: kill and resume with checkpoints (the straight
# run's steps, the killed run's steps, the steps between checkpoints) on
# the CLI's routes, and on the bench workload on CudaSweepEngine, where
# chunks of 3 and 2 steps do not divide B1's K = 4. A checkpoint of the
# bench's 2^20 cells cost ~150-176 s of host zlib at np.savez_compressed's
# default level (three 512 MiB float64 arrays on one core; PERF.md; the
# port now deflates at level 1, utils/checkpoint.py) and a kill and
# resume needs two saves whatever the steps, so for the smoke's time limit
# the bench runs there at A8_BENCH_N = 2^18 cells (same K, a quarter of the
# bytes; at 2^19 the two saves took 88 and 93 s at the default level and,
# with phase 17, the smoke 1114 s of its 1200).
A8_STEPS = (8, 6, 3)
A8_BENCH_STEPS = (5, 3, 3)
A8_BENCH_N = 1 << 18
# The single-device routes phase 15 kills and resumes through the CLI:
# (tag, deck, CLI arguments, bar). The decks are a8_decks'; bar 0 is
# bit-equality: the general engine and the wavefront kernels (B1, B2,
# B4-B7, B14, B15) compute a step the same way whatever the steps a
# launch, and a float32 plane, or a double-float (hi, lo) pair, comes
# back from its float64 container unchanged.
A8_ROUTES = (
    ("general", "mv", ["--engine", "general"], 0.0),
    ("pallas-CN", "mv_cn", ["--engine", "pallas", "--dtype", "float32"],
     0.0),
    ("halo", "thick", ["--engine", "halo", "--dtype", "float32"], 0.0),
    ("halo-CN", "thick_cn", ["--engine", "halo", "--dtype", "float32"],
     0.0),
    ("df", "mv", ["--engine", "df"], 0.0),
    ("df-CN", "mv_cn", ["--engine", "df"], 0.0),
    ("auto-f64", "thick", ["--engine", "auto"], 0.0),
    ("auto-f64-CN", "thick_cn", ["--engine", "auto"], 0.0),
)
# The same on --mesh 1x2, two ranks sharing the card (chip_smoke.py
# --a8-worker children). B8's and B13's look-backs compose their tiles in
# an order that depends on timing, and a resumed sharded or fused state
# starts with no pending correction: STEP_TOL there.
A8_MESH_ROUTES = (
    ("mesh-general", "mv", ["--engine", "general"], 0.0),
    ("mesh-pallas", "mv", ["--engine", "pallas", "--dtype", "float32"],
     STEP_TOL),
    ("mesh-fused", "mv", ["--engine", "fused", "--dtype", "float32"],
     STEP_TOL),
    ("mesh-df", "thick", ["--engine", "df"], 0.0),
    ("mesh-df-CN", "thick_cn", ["--engine", "df"], 0.0),
)
# The kernels phase 15 must launch (B1, B2, B4-B8, B13-B15).
PATH_A8 = ("bdf2_launch", "multistep_launch", "halo_bdf2_launch",
           "halo_multistep_launch", "df_bdf2_launch", "df_multistep_launch",
           "sharded_substep_launch", "fused_step_launch",
           "df_halo_bdf2_launch", "df_halo_multistep_launch")
# The JAX CLI's --metrics-json keys (radiative_transfer_tpu/cli.py:350-362).
METRICS_KEYS = {"deck", "engine", "mesh", "dtype", "steps_run", "wall_s",
                "updates_per_s", "balance_max", "balance_mean", "outputs"}
# Phase 16, ensembles (A10) and the fast engine (A7's first half): the
# stacked members on benchmarks/suite.py:280's gray_s8 (S_8 gray, Bh = 4,
# N = 2^18, 64 steps, Courant 0.4, reflective left), K of them, each
# kappa x U(0.5, 2); a stacked Bh of 4 K >= 8 puts auto on CudaSweepEngine
# and df on DFCudaEngine, where each member alone runs the halo engines.
ENS_K = 8
ENS_S8 = (8, 1 << 18, 64)
# --ensemble-kappa through the CLI: (tag, deck, K, steps, engines). The
# decks are a8_decks' (single_group.prm moving; its thick variant, where
# the stacked Bh = 4 puts auto and df on the halo engines, B4, B5, B14,
# B15) and the LLNL deck; bars: the f32 drift, df's, general/fast f64.
ENS_CLI = (
    ("mv", "mv", 4, 20, ("pallas", "auto", "df", "fast", "general")),
    ("thick", "thick", 4, 20, ("auto", "df")),
    ("thick-CN", "thick_cn", 4, 20, ("auto", "df")),
    ("llnl", "llnl", 2, 2, ("pallas", "auto", "df", "fast", "general")),
)
ENS_CLI_TOL = {"pallas": DRIFT_TOL, "auto": DRIFT_TOL, "df": DF_CLI_TOL,
               "fast": GENERAL_TOL, "general": GENERAL_TOL}
# solve_ensemble (torch.func.vmap over the general solver): K members of
# gray_s8 cut to N = 2^14, its 64 steps.
ENS_VMAP = (4, 1 << 14)
# The kernels phase 16 must launch (B1, B2, B4-B7, B14, B15).
PATH_ENS = ("bdf2_launch", "multistep_launch", "halo_bdf2_launch",
            "halo_multistep_launch", "df_bdf2_launch", "df_multistep_launch",
            "df_halo_bdf2_launch", "df_halo_multistep_launch")
# Phase 17, steady state (steady.py) and the sharded fast engine
# (parallel/sharded_fast.py), A7's second half: solve_steady at the bench
# (gray S_32, N = 2^20, uncut) at float64 and float32, and the same call at
# N = 2^14 against the CPU; solve_steady_cycle on gray S_32 rows,
# (cells, ts_method): 2^16 cells at BE and CN, where the one-sweep warm
# start is already the fixed point, and BDF2 at 2^6 cells (its GMRES basis
# is restart + 1 host vectors of the state's size, ~21 GB at the bench, so
# the cycle never runs there; at BDF2 the bench's Courant 0.4 leaves the
# step map so close to the identity that GMRES resolves the cycle's bias
# in hundreds of matvecs at 2^6 cells and more as N grows, so BDF2 runs
# there and on the shipped decks); the CLI's --steady and --steady-method
# cycle on every shipped deck against the CPU.
STEADY_BENCH = (32, 1 << 20)
STEADY_CPU_N = 1 << 14
STEADY_CYCLE = ((1 << 16, 1), (1 << 16, 2), (1 << 6, 3))
STEADY_DECKS = ("default.prm", "llnl_slab_test.prm",
                "multi_group_equilibrium.prm", "single_group.prm",
                "template.prm")
# The BE march on --engine df that the card's --steady of single_group.prm
# is held against: single_group.prm at BE with dt = 1 (L-stable, it lands on
# the fixed point in tens of steps), run to STEADY_MARCH[1] steps and held
# converged against STEADY_MARCH[0] steps (GENERAL_TOL).
STEADY_MARCH = (60, 120)
# ShardedFastEngine at the bench (f64, uncut) on the ranks of a --ranks run
# or phase 17's two ranks sharing the card: SF_STEPS steps after one,
# against FastEngine on one device (GENERAL_TOL).
SF_STEPS = 8
# Phase 18, the native I/O: the CLI on prm/single_group.prm through
# --engine pallas for NATIVE_STEPS steps, and a float32 psi of the bench's
# directions over a quarter of its cells, NATIVE_PSI = (M, G, N), written
# through the library and through the Python writers (0.16 GB of text
# each; ~3 and ~7 s of one host core next to an H100, PERF.md section 5).
NATIVE_STEPS = 20
NATIVE_PSI = (32, 1, 1 << 18)
# Phase 19: the examples, each at its shipped size (argv beyond --device
# cuda; none is cut), and the vmap(grad) peak: (members, M, N, BDF2 steps)
# on the gray slab, at single_group.prm's own S_2.
EXAMPLES = (("gray_equilibrium", []), ("multigroup_correction", None),
            ("llnl_production", []), ("reference_precision", []),
            ("inverse_opacity", ["--iters", "40"]), ("uncertainty", []))
# The one cut: inverse_opacity's 400 Adam iterations took 245 s on one
# H100 (0.6 s an iteration: the general engine's many small launches at
# N = 64); at 40 its worst kappa error is 3.3e-2, inside the JAX example's
# PASS bar of 5e-2 (which the JAX example reaches on a CPU at --iters 40).
EXAMPLE_CUTS = {"inverse_opacity": "--iters 40 (of 400)"}
EXAMPLE_RANKS = 2
REMAT_PEAK = (8, 2, 1 << 14, 64)
# One rank of the multichip example: its main(), the rank's kernel launches
# printed after it as JSON.
MULTICHIP_RANK = """
import json, sys
sys.path.insert(0, {root!r})
from radiative_transfer_tpu_torch.examples import _common, multichip
from radiative_transfer_tpu_torch.parallel import distributed
_common.reset_launch_counts()
res = multichip.main(["--device", "cuda"])
print("LAUNCHES " + json.dumps(_common.launch_counts()), flush=True)
print("FIGURES " + json.dumps({{k: res[k] for k in ("ranks", "mesh",
      "backend", "err", "engine", "f32_err")}}), flush=True)
distributed.shutdown()
"""
# Launches of each redesigned kernel (B1's, B2's, B4's, B5's, B6's, B7's,
# B10's, B11's, B12's, B14's and B15's wavefronts, B8's, B9's and B13's
# look-backs) per new parity shape: a race shows intermittently, so the
# worst is held.
REPEAT = 5
# The rates (updates/s) these paths ran at while B1, B6 and B8 still walked
# each row on one thread block, measured on one H100 80GB HBM3 at 700 W
# (PERF.md sections 5-6), printed beside this run's.
WALK_RATES = {"bench": 3.56799e10, "gray_s8 CudaSweepEngine": 9.08025e9,
              "df bench": 7.97936e9, "df gray_s8 DFCudaEngine": 2.24642e9,
             "df gray_s8 DFHaloCudaEngine": 3.59772e9,
             "gray rung CudaSweepEngine": 3.54150e10,
             "gray rung HaloCudaEngine": 9.69710e10,
             "gray rung FusedExchangeCudaEngine": 3.01069e10,
             "gray rung ShardedCudaEngine": 1.62029e10}
# The adjoint bench's grad/forward ratios while B10 and B12 still walked each
# row on one thread block (the forward already on B1's wavefront), measured
# on one H100 80GB HBM3 at 700 W (PERF.md section 5), printed beside this
# run's.
WALK_GRAD_RATIOS = {"grad_k1_vs_fwd": 21.72, "grad_kfused_vs_fwd": 19.37}
# B11's and B14's one-launch times (the adjoint bench at K = 4, gray_s8's df
# halo main launch) and the figures of their paths while both still walked
# each row on one thread block (B1, B6, B10 and B12 already wavefronts),
# measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md
# sections 5-6), printed beside this run's.
B11_B14_WALK = {"fwd_record_k_launch ms": 2.832,
                "df_halo_bdf2_launch ms": 4.364, "grad_kfused_vs_fwd": 8.965,
                "df gray_s8 DFHaloCudaEngine": 3.63691e9}
# B9's and B13's one-launch times (the adjoint bench, the gray rung's shard)
# and the figures of their paths while both still walked each row on one
# thread block, measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (PERF.md sections 5-6), printed beside this run's.
B9_B13_WALK = {"fwd_record_launch ms": 0.9834, "fused_step_launch ms": 4.401,
               "grad_k1_vs_fwd": 13.06,
               "gray rung FusedExchangeCudaEngine": 2.99295e10}
# B3's one-launch times at the bench (gray S_32, N = 2^20, reflective) and
# step()'s rates on the bench workload at BE and CN while B3 still walked
# each row on one thread block (two launches a sub-step, one a half),
# measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md
# section 6), printed beside this run's.
B3_WALK = {"substep_launch BE ms": 3.2881, "substep_launch CN ms": 3.5854,
           "substep_launch BDF ms": 4.7249, "step() BE": 1.0195e10,
           "step() CN": 9.4121e9}
# B4's and B15's one-launch times (gray_s8's halo main launch, BDF2 K = 8
# and CN K = 8) and HaloCudaEngine's rates on gray_s8 and on the gray rung
# at one rank while both still walked each row on one thread block,
# measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md
# sections 5-6), printed beside this run's.
B4_B15_WALK = {"halo_bdf2_launch ms": 2.721,
               "df_halo_multistep_launch ms": 4.177,
               "gray_s8 HaloCudaEngine": 2.38634e10,
               "gray rung HaloCudaEngine": 9.92078e10}
# B5's and B7's one-launch times (gray_s8's CN halo main launch at K = 16,
# the df bench's CN shape at K = 8) and gray_s8's CN rates on the engines
# they carry (HaloCudaEngine, DFCudaEngine) while both still walked each row
# on one thread block, measured on one NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (PERF.md sections 5-6; the HaloCudaEngine rate timed as
# phase 6 times it), printed beside this run's.
B5_B7_WALK = {"halo_multistep_launch ms": 1.779,
              "df_multistep_launch ms": 32.325,
              "df gray_s8 CN DFCudaEngine": 2.09036e9,
              "gray_s8 CN HaloCudaEngine": 1.71243e10}
SWEEP_CU = "radiative_transfer_tpu_torch/csrc/sweep.cu"
DF_CU = "radiative_transfer_tpu_torch/csrc/df_sweep.cu"
ADJ_CU = "radiative_transfer_tpu_torch/csrc/adjoint.cu"
# The adjoint kernels against their plain versions: gradient packs are row
# sums over every cell, taken in another order than the plain version's
# per-block sums (and from exact rather than truncated scans).
ADJ_PACK_TOL = 1e-4
REPLACES = {
    "bdf2_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:444",
    "multistep_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:387",
    "substep_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:229",
    "halo_bdf2_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:638",
    "halo_multistep_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:568",
    "df_bdf2_launch": "radiative_transfer_tpu/ops/df_sweep.py:372",
    "df_multistep_launch": "radiative_transfer_tpu/ops/df_sweep.py:475",
    "df_halo_bdf2_launch": "radiative_transfer_tpu/ops/df_sweep.py:640",
    "df_halo_multistep_launch": "radiative_transfer_tpu/ops/df_sweep.py:541",
    "fwd_record_launch": "radiative_transfer_tpu/ops/pallas_adjoint.py:266",
    "bwd_launch": "radiative_transfer_tpu/ops/pallas_adjoint.py:374",
    "fwd_record_k_launch": "radiative_transfer_tpu/ops/pallas_adjoint.py:571",
    "bwd_k_launch": "radiative_transfer_tpu/ops/pallas_adjoint.py:687",
    "sharded_substep_launch":
        "radiative_transfer_tpu/ops/pallas_sweep.py:289",
    "fused_step_launch":
        "radiative_transfer_tpu/parallel/fused_exchange.py:149",
}
# The C entry point each kernel wrapper launches through. The script logs
# each launch's shape (the entry point's integer and float arguments) to
# split a path's launches into those at the shape its kernel is timed at
# and the rest.
ENTRY = {
    "bdf2_launch": "rt_sweep_bdf2", "multistep_launch": "rt_sweep_multistep",
    "substep_launch": "rt_sweep_substep",
    "halo_bdf2_launch": "rt_sweep_halo_bdf2",
    "halo_multistep_launch": "rt_sweep_halo_multistep",
    "df_bdf2_launch": "rt_df_bdf2", "df_multistep_launch": "rt_df_multistep",
    "df_halo_bdf2_launch": "rt_df_halo_bdf2",
    "df_halo_multistep_launch": "rt_df_halo_multistep",
    "fwd_record_launch": "rt_adj_fwd_record", "bwd_launch": "rt_adj_bwd",
    "fwd_record_k_launch": "rt_adj_fwd_record_k",
    "bwd_k_launch": "rt_adj_bwd_k",
    "sharded_substep_launch": "rt_sharded_substep",
    "fused_step_launch": "rt_fused_step",
}
# The kernels each path must launch.
PATH_PLAIN = ("bdf2_launch", "multistep_launch", "substep_launch")
PATH_AUTO = ("halo_bdf2_launch", "halo_multistep_launch")
PATH_DF = ("df_bdf2_launch", "df_multistep_launch")
PATH_DF_HALO = ("df_halo_bdf2_launch", "df_halo_multistep_launch")
PATH_ADJ = ("fwd_record_launch", "bwd_launch")
PATH_ADJ_K = ("fwd_record_k_launch", "bwd_k_launch")
PATH_SHARDED = ("sharded_substep_launch",)
PATH_FUSED = ("fused_step_launch",)
SHARDED_CU = "radiative_transfer_tpu_torch/csrc/sharded.cu"
FUSED_CU = "radiative_transfer_tpu_torch/csrc/fused.cu"
# Peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# f32 operations per cell of one sub-step, counted from substep_tile in
# csrc/sweep.cu: psi 2, source 3, right-hand sides (BE 4, CN 10, BDF 22),
# b 4, carry 2, u 2, two edges 8. The kernel's own scan work (the a^n
# products, shuffles) is not part of the function and is not counted.
FLOPS_PER_CELL = {"BE": 25, "CN": 31, "BDF": 43}
BDF2_STEP_FLOPS = 2 * FLOPS_PER_CELL["BE"] + FLOPS_PER_CELL["CN"] + \
    FLOPS_PER_CELL["BDF"]
# f32 operations per cell of one double-float sub-step, counted from
# df_substep in csrc/df_sweep.cu (two_sum 6, split 1 and an integer mask,
# prod_err 8, a captured product 12 and 14 with a lo part): the right-hand
# side's captures and two_sum cascades (BE 44, CN 110, BDF 226), the base
# solve 17 (b 4, the carry b + (c - g*c) 3, u 2, two edges 8), the residual
# 104, the correction solve 17, the renormalisation 12; the correction
# source adds 32 where use_correction is set. The scan work (the 1 - a^n
# terms, shuffles) and the integer masks are not counted.
DF_FLOPS_PER_CELL = {"BE": 194, "CN": 260, "BDF": 376}
DF_CORR_FLOPS = 32
# f32 operations per cell of one adjoint phase, counted from phase_adj in
# csrc/adjoint.cu: the cotangent solve and reversed-scan fix-up 14, the
# right-hand side recomputed (psi 2, source 3, BE 4, CN 10, BDF 22) and u 2,
# the cotangent right-hand sides and their history and shift terms (BE 8,
# CN 20, BDF 48), the coefficient-gradient sums 36; a BDF2 step adds 8
# adds that route the phases' cotangents. B10 also recomputes the forward
# step (FLOPS_PER_CELL). The scan work (a^n products, shuffles) and the
# row-end reductions are not counted.
ADJ_FLOPS_PER_CELL = {"BE": 75, "CN": 93, "BDF": 133}
ADJ_BDF2_STEP_FLOPS = (BDF2_STEP_FLOPS + 2 * ADJ_FLOPS_PER_CELL["BE"]
                       + ADJ_FLOPS_PER_CELL["CN"] + ADJ_FLOPS_PER_CELL["BDF"]
                       + 8)
# B8 rebuilds each input plane pair on load, counted from csrc/sharded.cu:
# j * ln_a, expf (one), * inc, and a multiply-add per edge: 7 a pair, 5
# for CN's lone p1 edge.
B8_FLOPS_PER_CELL = {"BE": FLOPS_PER_CELL["BE"] + 7,
                     "CN": FLOPS_PER_CELL["CN"] + 7 + 5,
                     "BDF": FLOPS_PER_CELL["BDF"] + 3 * 7}
# B13 runs two whole BDF2 cycles a cell (the correction cycle on zero
# planes does the same arithmetic in csrc/fused.cu) and adds the correction
# to both input edges.
B13_FLOPS_PER_CELL = 2 * BDF2_STEP_FLOPS + 2


def df_step_flops(ts_method: int, use_corr: bool) -> int:
    """Operations per cell of one double-float timestep."""
    phases = (("BE", "CN", "BE", "BDF") if ts_method == 3 else
              ("BE",) if ts_method == 1 else ("CN",))
    return sum(DF_FLOPS_PER_CELL[p] + DF_CORR_FLOPS * use_corr
               for p in phases)


def gray_cfg(M, N, ts_method, steps=64):
    """bench.py's and benchmarks/suite.py's gray workload: S_M, one group,
    cell Courant 0.4, reflective left, source right."""
    from radiative_transfer_tpu_torch import constants
    from radiative_transfer_tpu_torch.config.config import Config

    return Config(
        M=M, G=1, N=N, X=1.0, bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple((4.0931,) for _ in range(M)),
        rho=1.0, kappa_grey=1.0, T=1.0, ts_method=ts_method,
        dt=0.4 * (1.0 / N) / constants.SPEED_OF_LIGHT, max_timesteps=steps,
        include_validation=False)


def rung_cfgs(shards: int):
    """benchmarks/weak_scaling.py's rungs at `shards` shards, with the
    steps phase 13 compares them after: gray (S_32, G = 1, BDF2, Courant
    0.4, 2^20 cells a shard; 8 steps) and llnl-shipped (the 124-group LLNL
    deck at its own dt = 1e-3, 2^13 cells a shard; the deck's 2 steps)."""
    from radiative_transfer_tpu_torch import load_config

    llnl = os.path.join(ROOT, "prm", "llnl_slab_test.prm")
    return (("gray", gray_cfg(32, shards << 20, 3), 8),
            ("llnl", load_config(llnl, N=shards << 13), 2))


def rank_cases(shards: int):
    """The multi-rank checks at `shards` shards: (tag, cfg, steps,
    engines, bar) with each engine's planes after `steps` held to `bar`
    against the same engine at one rank; bar None records the reading
    where bench.py's guard is left (see Held.guarded). The two rungs of
    rung_cfgs on the per-sub-step engine and auto's pick (gray: halo;
    llnl-shipped: fused); the LLNL deck at dt = 1e-5 at the llnl-shipped
    shard size on the per-sub-step and fused engines (the halo creep bound
    still refuses it there, but its state stays inside the guard over the
    deck's 2 steps);
    and the double-float halo engine on gray_s8 (S_8, G = 1: a tiny batch,
    Bh = 4; 2^17 cells a shard) at DF_TOL."""
    from radiative_transfer_tpu_torch import load_config

    (gtag, gray, gsteps), (ltag, llnl, lsteps) = rung_cfgs(shards)
    small_dt = load_config(os.path.join(ROOT, "prm", "llnl_slab_test.prm"),
                           N=shards << 13, dt=1e-5)
    return ((gtag, gray, gsteps, ("pallas", "auto"), TOL),
            (ltag, llnl, lsteps, ("pallas", "auto"), None),
            ("llnl_dt1e-5", small_dt, 2, ("pallas", "fused"), TOL),
            ("gray_s8_df", gray_cfg(8, shards << 17, 3), 8, ("df_halo",),
             DF_TOL))


KIND_OF = {"ShardedCudaEngine": "pallas", "HaloCudaEngine": "halo",
           "FusedExchangeCudaEngine": "fused",
           "DFHaloCudaEngine": "df_halo"}


def planes_of(eng, st):
    """The global (ends, prev, half) of an engine's state."""
    return [eng.ends(st), *eng.prev_half_ends(st)]


def guard(planes):
    """(inside bench.py's guard: finite with max|x| < 1e3, max|x|)."""
    import numpy as np

    m = max(float(p.abs().max()) for p in planes)
    return bool(np.isfinite(m) and m < 1e3), m


class Held:
    """Comparisons held to a bar; a failure is collected and fails the
    phase. `guarded` holds a comparison only where the reference state is
    inside bench.py's guard: on the llnl-shipped rung dt = 1e-3 lies far
    outside BDF2's stability envelope (benchmarks/suite.py:52-53), the
    state leaves the guard within the deck's 2 steps, and there the
    float32 reference itself lies ~1e-4 from the double-float engine
    (compare_ranks prints that witness), so two float32 orders of
    summation can part by more than 1e-5: such a comparison is recorded,
    not held."""

    def __init__(self):
        self.failures = []

    def __call__(self, label, err, tol=TOL):
        if not err <= tol:
            self.failures.append(f"{label} {err:.3e} > {tol}")
        return f"{label} {err:.1e}"

    def guarded(self, label, err, ref_planes, tol=TOL):
        inside, mx = guard(ref_planes)
        if not inside:
            return (f"{label} {err:.2e} (reference max|x| {mx:.3g}: outside "
                    "the guard, recorded)")
        return self(label, err, tol)


def mesh_worker(out_path: str, shards: int, timed_steps: int) -> int:
    """One rank of a multi-rank run (started with
    parallel.distributed.launch_local): every case of rank_cases on a
    1 x shards mesh; ends/prev/half after the case's steps saved by rank
    0, and with `timed_steps` the gray rung's solve of that many steps
    timed (8-step warm-up)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke mesh worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import (
        distributed, make_multichip_engine, mesh)

    distributed.initialize(device_type="cuda")
    dev = distributed.local_device("cuda")
    torch.cuda.set_device(dev)
    m = mesh.make_mesh_1d(shards)
    out = {}
    for tag, cfg, steps, engines, _ in rank_cases(shards):
        tables, _, _ = transport.build_tables(cfg)
        for engine in engines:
            eng = make_multichip_engine(cfg, tables, m, engine=engine,
                                        device=dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            st = eng.solve(num_steps=steps)
            planes = planes_of(eng, st)
            torch.cuda.synchronize(dev)
            key = f"{tag}/{engine}"
            out[key + "/seconds"] = np.array(time.perf_counter() - t0)
            out[key] = np.stack([p.cpu().numpy() for p in planes])
            out[key + "/name"] = np.array(type(eng).__name__)
            if timed_steps and tag == "gray":
                eng.solve(num_steps=8)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                eng.solve(num_steps=timed_steps)
                torch.cuda.synchronize(dev)
                out[key + "/timed"] = np.array(time.perf_counter() - t0)
            del eng, st, planes
    if m.rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
    return 0


def run_ranks(shards: int, timed_steps: int = 0):
    """Start `shards` ranks of mesh_worker; returns (rank 0's results, the
    backend line rank 0 printed, wall seconds with start-up)."""
    import numpy as np

    from radiative_transfer_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out_path = os.path.join(tmp, "ranks.npz")
        t0 = time.perf_counter()
        runs = distributed.launch_local(
            [os.path.abspath(__file__), "--mesh-worker", out_path,
             str(shards), str(timed_steps)], shards, cwd=ROOT, timeout=900)
        wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"{shards}-rank run rc {r.returncode}:\n"
                                     + r.stdout[-2000:] + r.stderr[-4000:])
        backend = [ln for ln in runs[0].stdout.splitlines()
                   if ln.startswith("distributed:")]
        return dict(np.load(out_path)), (backend or [""])[0], wall


def compare_ranks(ranks, shards, mesh_engine, held):
    """Each case and engine of a multi-rank run (rank_cases) against the
    same engine at one rank on this process's card; on the llnl-shipped
    rung also the witness: every float32 result's distance from the
    double-float DFCudaEngine after the same steps. Returns the printed
    readings."""
    import torch

    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs

    lines = []
    for tag, cfg, steps0, engines, bar in rank_cases(shards):
        if bar is None:
            tables, _, _ = transport.build_tables(cfg)
            dev = torch.device("cuda", 0)
            dfe = cd.DFCudaEngine(cfg, tables, device=dev)
            witness = planes_of(dfe, dfe.solve(num_steps=steps0))
            ref = cs.CudaSweepEngine(cfg, tables, device=dev)
            ref_planes = planes_of(ref, ref.solve(num_steps=steps0))
            to_df = {"CudaSweepEngine": max(
                nerr(a, b) for a, b in zip(ref_planes, witness))}
            del dfe, ref, ref_planes
        for engine_name in engines:
            key = f"{tag}/{engine_name}"
            name = str(ranks[key + "/name"])
            eng = mesh_engine(cfg, KIND_OF[name])
            want = planes_of(eng, eng.solve(num_steps=steps0))
            got = [torch.as_tensor(g, device=w.device)
                   for g, w in zip(ranks[key], want)]
            err = max(nerr(g, w) for g, w in zip(got, want))
            label = (f"{tag} N={cfg.N} {engine_name} -> {name} {steps0} "
                     "steps vs one rank")
            line = (held.guarded(label, err, want) if bar is None
                    else held(label, err, bar))
            if bar is None:
                to_df[f"{name} at one rank"] = max(
                    nerr(a, b) for a, b in zip(want, witness))
                to_df[f"{name} at {shards} ranks"] = max(
                    nerr(a, b) for a, b in zip(got, witness))
            lines.append(line + f" (ranks' solve "
                         f"{float(ranks[key + '/seconds']):.3f} s)")
            del eng, want, got
        if bar is None:
            lines.append(f"{tag} N={cfg.N} witness, distance from "
                         f"DFCudaEngine after {steps0} steps: "
                         + json.dumps(to_df))
            del witness
    return lines


def ranks_check(shards: int, fast_only: bool = False) -> int:
    """`chip_smoke.py --ranks P`: the mesh path on P ranks, one a card where
    the host has P cards (NCCL), else sharing them (gloo): every case of
    rank_cases at P shards against one rank on card 0 (compare_ranks), the
    gray rung's 64 steps timed on each rank against one rank's 2^20-cell
    rung (weak scaling), the CLI under torchrun (--mesh 1xP; pallas,
    fused, auto) against the single-device CLI on card 0 (5e-5 over 200
    steps), and ShardedFastEngine at the bench at 1xP and 2x(P/2)
    (fast_mesh_worker) against FastEngine on card 0 (GENERAL_TOL), and
    the multichip example (phase 19) on P ranks. With `fast_only`
    (`--ranks P fast`) only ShardedFastEngine. Prints one JSON line; exits
    non-zero on a failed check."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import _cuda_build
    from radiative_transfer_tpu_torch.parallel import (
        distributed, make_multichip_engine)
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod

    card = card_line()
    print(f"ranks {shards}: torch {torch.__version__}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"nvidia-smi: {card}", flush=True)
    _cuda_build.build()                 # the ranks load the built library
    dev = torch.device("cuda", 0)
    mesh1 = mesh_mod.make_mesh_1d(1)

    def mesh_engine(cfg, engine_name):
        tables, _, _ = transport.build_tables(cfg)
        return make_multichip_engine(cfg, tables, mesh1, engine=engine_name,
                                     device=dev)

    held = Held()
    sf_ranks, sf_backend, sf_wall = run_fast_mesh(shards)
    sf = fast_mesh_vs_one(sf_ranks, shards, dev)
    sf_line = (f"ShardedFastEngine at the bench (f64, {SF_STEPS} steps after "
               f"1, seeded; {sf_backend}; {sf_wall:.1f} s wall with "
               f"start-up): " + json.dumps(sf))
    if fast_only:
        print(f"ranks {shards}: ok; {sf_line}; card: {card}", flush=True)
        print(json.dumps({"ok": True, "ranks": shards,
                          "backend": sf_backend}), flush=True)
        return 0
    mc_ranks, mc_wall = run_multichip(shards)
    mc_line = (f"the multichip example on {shards} ranks ({mc_wall:.1f} s "
               "wall with start-up): " + json.dumps(mc_ranks[0][1])
               + " launches " + json.dumps([r[0] for r in mc_ranks]))
    ranks, backend, wall = run_ranks(shards, timed_steps=64)
    lines = compare_ranks(ranks, shards, mesh_engine, held)
    scaling = {}
    one_cfg = rung_cfgs(1)[0][1]
    for engine_name in ("pallas", "auto"):
        name = str(ranks[f"gray/{engine_name}/name"])
        eng = mesh_engine(one_cfg, KIND_OF[name])
        eng.solve(num_steps=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.solve(num_steps=64)
        torch.cuda.synchronize()
        t1 = time.perf_counter() - t0
        tp = float(ranks[f"gray/{engine_name}/timed"])
        scaling[name] = {"one_rank_s": t1, "ranks_s": tp,
                         "efficiency": t1 / tp,
                         "updates_per_s": 4 * 32 * (shards << 20) * 64 / tp}
        del eng

    deck = os.path.join(ROOT, "prm", "single_group.prm")
    csvs = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
            "right_ends")
    cli_errs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        base = [deck, "--dtype", "float32", "--steps", "200"]
        ref_dir = os.path.join(tmp, "single")
        run = subprocess.run(
            [sys.executable, "-m", "radiative_transfer_tpu_torch.cli", *base,
             "--engine", "pallas", "--outdir", ref_dir], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError("single-device cli: " + run.stderr[-3000:])
        phi = np.loadtxt(os.path.join(ref_dir, "phi.csv"), ndmin=2)
        for engine_name in ("pallas", "fused", "auto"):
            outdir = os.path.join(tmp, engine_name)
            run = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--nproc_per_node", str(shards), "--master_port",
                 str(distributed.free_port()), "-m",
                 "radiative_transfer_tpu_torch.cli", *base, "--engine",
                 engine_name, "--mesh", f"1x{shards}", "--outdir", outdir],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                raise AssertionError(f"torchrun cli {engine_name}: "
                                     + run.stdout[-2000:] + run.stderr[-3000:])
            worst = 0.0
            for name in csvs:
                got = np.loadtxt(os.path.join(outdir, f"{name}.csv"), ndmin=2)
                ref = np.loadtxt(os.path.join(ref_dir, f"{name}.csv"),
                                 ndmin=2)
                scale = np.abs(phi).max() if name == "F" else np.abs(ref).max()
                worst = max(worst, float(np.abs(got - ref).max() / scale))
            cli_errs[engine_name] = worst
            if not worst <= DRIFT_TOL:
                held.failures.append(f"torchrun cli {engine_name} {worst:.3e}"
                                     f" > {DRIFT_TOL}")
    print(f"ranks {shards}: {'FAILED' if held.failures else 'ok'}; {backend}; "
          f"{wall:.1f} s wall with start-up; " + "; ".join(lines)
          + "; gray rung 64 steps (weak scaling, 2^20 cells a rank): "
          + json.dumps(scaling) + "; torchrun CLI --mesh 1x"
          f"{shards} vs the single-device CLI (200 steps): "
          + json.dumps(cli_errs) + f"; {sf_line}; {mc_line}; card: {card}",
          flush=True)
    if held.failures:
        print("failed: " + "; ".join(held.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "ranks": shards, "backend": backend}),
          flush=True)
    return 0


def general_rank_cases():
    """phase 14's two-rank checks of parallel/sharded.solve_sharded:
    (tag, cfg, mesh GxX, steps): the gray bench workload at 2^16 cells
    (S_32, BDF2, reflective left) with a boundary source of 2.0 (against
    B = 4.0931) split over 'x', and the multigroup equilibrium deck (G = 4,
    correction on) at 4096 cells split over 'g'; each from
    general_rank_state."""
    from radiative_transfer_tpu_torch import load_config

    gray = gray_cfg(32, 1 << 16, 3).replace(
        psi_source=tuple((2.0,) for _ in range(32)))
    mg = load_config(os.path.join(ROOT, "prm", "multi_group_equilibrium.prm"),
                     N=4096)
    return (("gray", gray, "1x2", 8), ("mg", mg, "2x1", 8))


def general_rank_state(cfg, tables):
    """A seeded random state around psi = B_g (float64, on the CPU): the
    same on every rank and on the one-rank side, and off equilibrium at
    every cell, so the shards' composed carries are exercised."""
    import torch

    from radiative_transfer_tpu_torch.models import transport

    g = torch.Generator().manual_seed(cfg.N)
    return transport.State(*(
        x * (0.5 + torch.rand(x.shape, generator=g, dtype=torch.float64))
        for x in transport.initial_state(cfg, tables)))


def general_worker(out_path: str) -> int:
    """One rank of phase 14's two-rank run (started with
    parallel.distributed.launch_local): every case of general_rank_cases
    through solve_sharded on the card; rank 0 saves the global (ends,
    prev, half) of each."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke general worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed, sharded
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod

    distributed.initialize(device_type="cuda")
    dev = distributed.local_device("cuda")
    torch.cuda.set_device(dev)
    out = {}
    for tag, cfg, shape, steps in general_rank_cases():
        ng, nx = (int(v) for v in shape.split("x"))
        m = (mesh_mod.make_mesh_2d(ng, nx) if ng > 1
             else mesh_mod.make_mesh_1d(nx))
        tables, _, _ = transport.build_tables(cfg)
        t0 = time.perf_counter()
        st = sharded.solve_sharded(cfg, tables,
                                   general_rank_state(cfg, tables), m,
                                   num_steps=steps, device=dev)
        torch.cuda.synchronize(dev)
        out[tag + "/seconds"] = np.array(time.perf_counter() - t0)
        out[tag] = np.stack([x.cpu().numpy() for x in st])
    if distributed.process_index() == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
    return 0


def cuda_seconds(fn):
    """(seconds between CUDA events around fn(), fn's result)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3, out


def median_seconds(fn, n: int = 3):
    """(the median of n cuda_seconds windows of fn(), the last result)."""
    runs = [cuda_seconds(fn) for _ in range(n)]
    return sorted(r[0] for r in runs)[n // 2], runs[-1][1]


def grads_card_vs_cpu(make, dev) -> dict:
    """A differentiable solve (adjoint.make_diff_solve or
    make_diff_solve_fast) on the card against the same call on the CPU at
    GENERAL_ADJ_CPU from a seeded state: {name: nerr} of the value and the
    gradients in kappa, rho, psi_source and the initial ends."""
    import torch

    from radiative_transfer_tpu_torch.models import transport

    Mc, Nc, nc = GENERAL_ADJ_CPU
    ccfg = gray_cfg(Mc, Nc, 3, nc)
    ctab, _, _ = transport.build_tables(ccfg)
    cst = general_rank_state(ccfg, ctab)
    cgrads = {}
    for where in (dev, "cpu"):
        prm = {"kappa": torch.ones(1, dtype=torch.float64),
               "rho": torch.ones(1, dtype=torch.float64),
               "psi_source": torch.full((Mc, 1), 2.0, dtype=torch.float64)}
        # A BDF2 step overwrites prev_ends and reads half_ends only after
        # its own snapshot, so only the initial ends carry a gradient.
        e0 = cst.ends.clone().requires_grad_(True)
        for x in prm.values():
            x.requires_grad_(True)
        sfc = make(ccfg, ctab, num_steps=nc, device=where)
        val = torch.sum(sfc(prm, cst._replace(ends=e0)).ends ** 2) * 1e-3
        val.backward()
        cgrads[str(where)] = ([val.detach().cpu()]
                              + [prm[k].grad.cpu() for k in sorted(prm)]
                              + [e0.grad.cpu()])
    names = ["value"] + sorted(prm) + ["initial ends"]
    return {n: nerr(g, c) for n, g, c in
            zip(names, cgrads[str(dev)], cgrads["cpu"])}


def general_path(dev, card, cli_vs_cpu, run_cli, variant, peak_from,
                 kernel_rates):
    """Phase 14, the general engine (models/transport.py, ops/sweep.py,
    ops/scan.py, parallel/sharded.py: plain PyTorch, no kernel of its own)
    on the card. Raises on a failed check; returns the phase's line.

    * The CLI's default engine (general, float64) on the three shipped
      decks and single_group.prm at BE and CN, its 8 CSVs within
      GENERAL_TOL of the same CLI on the CPU; on each, the CLI's --engine
      pallas (B1, B2) within DRIFT_TOL and run_problem(engine="df") (B6,
      B7) within DF_CLI_TOL of the card's general run (both counted: each
      of the four kernels must launch).
    * The bench workload (GENERAL_BENCH) at float64 and float32 from a
      seeded state off equilibrium (general_rank_state), timed with CUDA
      events, with peak memory; the float64 state held to DFCudaEngine's
      from the same state after the same steps (DF_CLI_TOL); one float64
      sub-step of each kind and one half's scan timed alone.
    * One make_diff_solve value and gradient in kappa at the adjoint bench
      (GENERAL_ADJ, remat) from a seeded state, timed against the forward
      solve, with peak memory, held to make_diff_solve_cuda's on the same
      state (ADJ_TOL, ADJ_GRAD_TOL); at a cut N (GENERAL_ADJ_CPU) its value
      and gradients in kappa, rho, psi_source and the initial state held
      to the same call on the CPU (GENERAL_GRAD_TOL).
    * solve_sharded on two ranks sharing the card (gloo) against one rank
      (GENERAL_TOL)."""
    import numpy as np
    import torch

    from radiative_transfer_tpu_torch import adjoint as adj
    from radiative_transfer_tpu_torch import load_config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.ops.scan import affine_scan
    from radiative_transfer_tpu_torch.parallel import distributed

    def csv_err(got_dir, ref_dir):
        phi = np.abs(np.loadtxt(os.path.join(ref_dir, "phi.csv"))).max()
        worst = 0.0
        for name in ("phi", "phi_plus", "psi", "x", "F", "e_ave",
                     "left_ends", "right_ends"):
            got = np.loadtxt(os.path.join(got_dir, f"{name}.csv"), ndmin=2)
            ref = np.loadtxt(os.path.join(ref_dir, f"{name}.csv"), ndmin=2)
            scale = phi if name == "F" else np.abs(ref).max()
            worst = max(worst, float(np.abs(got - ref).max() / scale))
        return worst

    fields = ("psi", "phi", "phi_plus", "left_ends", "right_ends")
    kernels = ("bdf2_launch", "multistep_launch", "df_bdf2_launch",
               "df_multistep_launch")
    cs.reset_launch_counts()
    cd.reset_launch_counts()
    lines = []
    gray = os.path.join(ROOT, "prm", "single_group.prm")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = [(os.path.join(ROOT, "prm", "llnl_slab_test.prm"), 2, "llnl"),
                (gray, 200, "gray"),
                (os.path.join(ROOT, "prm", "multi_group_equilibrium.prm"),
                 200, "mg"),
                (variant(tmp, 1), 200, "gray-BE"),
                (variant(tmp, 2), 200, "gray-CN")]
        for deck, steps, tag in runs:
            summary, _ = cli_vs_cpu(tmp, deck, steps, f"general-{tag}", [],
                                    tol=GENERAL_TOL)
            gen_dir = os.path.join(tmp, f"general-{tag}_cuda")
            pal_dir, _ = run_cli(tmp, deck, steps, "cuda", f"pallas-{tag}",
                                 ["--engine", "pallas", "--dtype",
                                  "float32"])
            pal = csv_err(pal_dir, gen_dir)
            cfg = load_config(deck, max_timesteps=steps)
            gen = transport.run_problem(cfg, device=dev)
            df = transport.run_problem(cfg, engine="df", device=dev)
            # F cancels near equilibrium: phi bounds it.
            dfe = max([nerr(getattr(df, k), getattr(gen, k)) for k in fields]
                      + [float((df.F - gen.F).abs().max()
                               / gen.phi.abs().max())])
            if not pal <= DRIFT_TOL:
                raise AssertionError(f"phase 14 {tag}: --engine pallas vs "
                                     f"general {pal:.3e} > {DRIFT_TOL}")
            if not dfe <= DF_CLI_TOL:
                raise AssertionError(f"phase 14 {tag}: df vs general "
                                     f"{dfe:.3e} > {DF_CLI_TOL}")
            lines.append(f"{summary}; pallas vs general {pal:.1e}, df vs "
                         f"general {dfe:.1e}")
    counts = {name: getattr(cd if name.startswith("df_") else cs,
                            name).launches for name in kernels}
    if not all(counts.values()):
        raise AssertionError(f"phase 14: kernels not launched: {counts}")

    # The bench workload, float64 and float32, from a seeded state (at
    # psi = B the state would not move): 1 step, then 8 timed.
    Mb, Nb, nb = GENERAL_BENCH
    bcfg = gray_cfg(Mb, Nb, 3)
    btab, _, _ = transport.build_tables(bcfg)
    bst = general_rank_state(bcfg, btab)
    ups = 4 * Mb * Nb * nb
    rates = {}
    ends = {}
    for dname, dtype in (("float64", torch.float64),
                         ("float32", torch.float32)):
        pk = peak_from()
        st = transport.solve(bcfg, btab, bst, 1, dtype, dev)
        secs, st = cuda_seconds(lambda: transport.solve(
            bcfg, btab, st, nb, dtype, dev))
        peak = pk()
        if not bool(torch.isfinite(st.ends).all()):
            raise AssertionError(f"phase 14 bench {dname}: not finite")
        rates[dname] = {"seconds": secs, "updates_per_s": ups / secs,
                        "peak_gib": peak}
        ends[dname] = st.ends
        del st
    dfe_ = cd.DFCudaEngine(bcfg, btab, device=dev)
    df_ends = dfe_.ends(dfe_.solve(dfe_.from_ends(*bst), num_steps=nb + 1))
    bench_moved = nerr(ends["float64"], bst.ends.to(dev))
    bench_df = nerr(ends["float64"], df_ends)
    if not bench_df <= DF_CLI_TOL:
        raise AssertionError(f"phase 14 bench: general vs DFCudaEngine "
                             f"{bench_df:.3e} > {DF_CLI_TOL}")
    bench_f32 = nerr(ends["float32"], ends["float64"])
    # Where a float64 step's time goes: one sub-step of each kind on the
    # final state, and the scan of one direction half's (a, b) alone.
    t64 = transport.device_tables(btab, torch.float64, dev)
    e = ends["float64"]
    split = {name: cuda_seconds(lambda: transport.substep(
        kind, bcfg, t64, e, e, e, bcfg.dt / 2.0))[0] * 1e3
        for name, kind in (("BE", 1), ("CN", 2), ("BDF", 3))}
    half = e[:Mb // 2, :, :, 0]
    split["scan of one half"] = cuda_seconds(
        lambda: affine_scan(half * 0.5, half))[0] * 1e3
    del dfe_, df_ends, ends, e, half, bst

    # One value and gradient at the adjoint bench's shape from a seeded
    # state (at psi = B, dL/dkappa is roundoff), timed against the forward
    # and held to the kernel adjoint from the same state.
    Ma, Na, na = GENERAL_ADJ
    acfg = gray_cfg(Ma, Na, 3, na)
    atab, _, _ = transport.build_tables(acfg)
    ast = general_rank_state(acfg, atab)
    f_secs, _ = cuda_seconds(lambda: transport.solve(
        acfg, atab, ast, na, device=dev).ends)
    kap = torch.ones(1, dtype=torch.float64, requires_grad=True)

    def value_and_grad(make, steps):
        sfg = make(acfg, atab, num_steps=steps, device=dev)
        kap.grad = None
        val = torch.sum(sfg({"kappa": kap}, ast).ends ** 2) * 1e-3
        val.backward()
        return val.detach(), float(kap.grad[0])

    value_and_grad(adj.make_diff_solve, 1)             # warm-up
    pk = peak_from()
    g_secs, (gval, ggrad) = cuda_seconds(
        lambda: value_and_grad(adj.make_diff_solve, na))
    g_peak = pk()
    kval, kgrad = value_and_grad(ca.make_diff_solve_cuda, na)
    v_err = abs(float(kval) - float(gval)) / abs(float(gval))
    k_err = abs(kgrad - ggrad) / abs(ggrad)
    if not (v_err <= ADJ_TOL and k_err <= ADJ_GRAD_TOL):
        raise AssertionError(f"phase 14 adjoint bench: kernel vs general "
                             f"value {v_err:.3e} > {ADJ_TOL} or dL/dkappa "
                             f"{k_err:.3e} > {ADJ_GRAD_TOL}")

    # make_diff_solve on the card against the CPU at a cut N, every
    # parameter kind and the initial state.
    cpu_errs = grads_card_vs_cpu(adj.make_diff_solve, dev)
    Mc, Nc, nc = GENERAL_ADJ_CPU
    if not max(cpu_errs.values()) <= GENERAL_GRAD_TOL:
        raise AssertionError(f"phase 14 make_diff_solve card vs CPU: "
                             f"{cpu_errs} > {GENERAL_GRAD_TOL}")

    # Two ranks sharing the card (gloo) against one rank.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out_path = os.path.join(tmp, "general.npz")
        t0 = time.perf_counter()
        runs = distributed.launch_local(
            [os.path.abspath(__file__), "--general-worker", out_path], 2,
            cwd=ROOT, timeout=600)
        two_wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"phase 14 two ranks rc {r.returncode}:"
                                     "\n" + r.stdout[-2000:]
                                     + r.stderr[-4000:])
        ranks = dict(np.load(out_path))
    two = []
    for tag, cfg, shape, steps in general_rank_cases():
        tables, _, _ = transport.build_tables(cfg)
        want = transport.solve(cfg, tables, general_rank_state(cfg, tables),
                               steps, device=dev)
        err = max(nerr(torch.as_tensor(g, device=dev), w)
                  for g, w in zip(ranks[tag], want))
        if not err <= GENERAL_TOL:
            raise AssertionError(f"phase 14 {tag} {shape} ranks vs one "
                                 f"rank {err:.3e} > {GENERAL_TOL}")
        two.append(f"{tag} N={cfg.N} {shape} {steps} steps vs one rank "
                   f"{err:.1e} (ranks' solve "
                   f"{float(ranks[tag + '/seconds']):.3f} s)")

    return (f"phase 14 general f64 path: ok; CLI default engine (general, "
            f"float64) vs CPU and the kernels vs it on the card: "
            + "; ".join(lines) + f"; launches there {json.dumps(counts)}; "
            f"bench (gray S_{Mb}, N=2^{Nb.bit_length() - 1}, BDF2, {nb} steps "
            f"after 1, CUDA events): " + json.dumps(rates)
            + f"; from a seeded state (moved {bench_moved:.2e} in "
            f"{nb + 1} steps): float64 vs DFCudaEngine {bench_df:.2e}, "
            f"float32 vs float64 {bench_f32:.2e}; float64 split (ms, CUDA events, one "
            "call each after the timed steps; a BDF2 step is BE, CN, BE, "
            "BDF): " + json.dumps(split) + "; kernel engines' bench rates "
            "(phases 5, 7): " + json.dumps(kernel_rates) + f"; adjoint bench (gray "
            f"S_{Ma}, N=2^{Na.bit_length() - 1}, {na} BDF2 steps, remat): "
            f"forward {f_secs:.4f} s, value and grad {g_secs:.4f} s "
            f"(grad/forward {g_secs / f_secs:.3f}), peak {g_peak:.3f} GiB; "
            f"from a seeded state vs make_diff_solve_cuda: value "
            f"{v_err:.2e}, dL/dkappa {k_err:.2e} (kernel {kgrad:.6e}, "
            f"general {ggrad:.6e}, L {float(gval):.6e}); make_diff_solve "
            f"card vs CPU (gray S_{Mc}, N={Nc}, {nc} steps, seeded state): "
            + json.dumps({k: float(f"{v:.2e}") for k, v in cpu_errs.items()})
            + "; two ranks sharing the card (gloo, "
            f"{two_wall:.1f} s wall with start-up): " + "; ".join(two)
            + f"; card: {card}")


def a8_deck_paths(tmp: str) -> dict:
    """Where a8_decks writes each of phase 15's decks."""
    return {k: os.path.join(tmp, f"a8_{k}.prm")
            for k in ("mv", "mv_cn", "thick", "thick_cn")}


def a8_decks(tmp: str) -> dict:
    """phase 15's decks, written to tmp: single_group.prm with a boundary
    source of 2.0 against B = 4.0931, so that the state moves ("mv"), and
    its thick tiny-batch variant N = 2048, X = 20.48, which the halo
    engines' creep bound admits ("thick"); each at BDF2 and at CN
    ("_cn")."""
    base = open(os.path.join(ROOT, "prm", "single_group.prm")).read()
    edits = {"mv": [("psi_source=4.0931 4.0931", "psi_source=2.0 2.0")]}
    edits["thick"] = edits["mv"] + [("N=100", "N=2048"), ("X=1.", "X=20.48")]
    paths = a8_deck_paths(tmp)
    for name, subs in edits.items():
        for suffix, ts in (("", []), ("_cn", [("ts_method=3",
                                               "ts_method=2")])):
            text = base
            for old, new in subs + ts:
                if old not in text:
                    raise RuntimeError(f"single_group.prm no longer says "
                                       f"{old}")
                text = text.replace(old, new)
            with open(paths[name + suffix], "w") as fh:
                fh.write(text)
    return paths


def a8_cli(argv):
    """The port's CLI in this process; its stdout lines, or RuntimeError
    with its tail where it exits nonzero."""
    from radiative_transfer_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exit {rc}:\n"
                           + buf.getvalue()[-3000:])
    return buf.getvalue().splitlines()


def a8_kill_resume(tmp, decks, tag, deck, args, device="cuda"):
    """One route straight for A8_STEPS[0] steps, killed at A8_STEPS[1]
    with a checkpoint every A8_STEPS[2], then resumed to A8_STEPS[0]:
    writes tmp/<tag>_{straight,killed,resumed} and tmp/<tag>_ck. Returns
    the resumed run's stdout lines."""
    total, killed, every = A8_STEPS
    base = [decks[deck], *args, "--device", device]
    ck = ["--checkpoint-dir", os.path.join(tmp, f"{tag}_ck"),
          "--checkpoint-every", str(every)]
    a8_cli(base + ["--steps", str(total), "--outdir",
                   os.path.join(tmp, f"{tag}_straight")])
    a8_cli(base + ck + ["--steps", str(killed), "--outdir",
                        os.path.join(tmp, f"{tag}_killed")])
    out = a8_cli(base + ck + ["--steps", str(total), "--outdir",
                              os.path.join(tmp, f"{tag}_resumed")])
    from radiative_transfer_tpu_torch.parallel import distributed

    if (distributed.process_index() == 0
            and f"resumed from step {killed}" not in out):
        raise AssertionError(f"phase 15 {tag}: the resumed run did not say "
                             f"'resumed from step {killed}'")
    return out


def a8_csv_err(got_dir, ref_dir):
    """(max normalised error over the 8 CSVs, F against max|phi|; whether
    every file is byte-equal: the CSVs print float64 at %.17g)."""
    import numpy as np

    phi = np.abs(np.loadtxt(os.path.join(ref_dir, "phi.csv"))).max()
    worst, same = 0.0, True
    for name in ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
                 "right_ends"):
        gp, rp = (os.path.join(d, f"{name}.csv") for d in (got_dir, ref_dir))
        got, ref = np.loadtxt(gp, ndmin=2), np.loadtxt(rp, ndmin=2)
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{gp}: shape {got.shape} vs {ref.shape} "
                                 "or not finite")
        scale = phi if name == "F" else np.abs(ref).max()
        worst = max(worst, float(np.abs(got - ref).max()
                                 / max(scale, 1e-300)))
        same = same and open(gp, "rb").read() == open(rp, "rb").read()
    return worst, same


def a8_counts():
    """Every phase-15 kernel wrapper's launch count in this process."""
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_fused as cf
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs

    return {name: getattr(cf if name == "fused_step_launch" else
                          cd if name.startswith("df_") else cs,
                          name).launches for name in PATH_A8}


def a8_worker(tmp: str) -> int:
    """One rank of phase 15's two-rank run (started with
    parallel.distributed.launch_local): every route of A8_MESH_ROUTES
    killed and resumed through the CLI on --mesh 1x2; each rank saves its
    launch counts to tmp/a8_counts_<rank>.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke a8 worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch.parallel import distributed

    decks = a8_deck_paths(tmp)
    for tag, deck, args, _ in A8_MESH_ROUTES:
        a8_kill_resume(tmp, decks, tag, deck, [*args, "--mesh", "1x2"])
    with open(os.path.join(tmp, f"a8_counts_{distributed.process_index()}"
                                ".json"), "w") as fh:
        json.dump(a8_counts(), fh)
    distributed.shutdown()
    return 0


def utilities_path(dev, card, peak_from):
    """Phase 15, A8's utilities (utils/checkpoint.py, utils/debug.py,
    utils/profiling.py and the CLI flags on them) on the card. Raises on a
    failed check; returns the phase's line.

    * The main path: CudaSweepEngine (B1, K = 4) at the bench workload
      cut to A8_BENCH_N cells from a seeded state (general_rank_state),
      straight for
      A8_BENCH_STEPS[0] steps against a run killed at A8_BENCH_STEPS[1]
      with a checkpoint every A8_BENCH_STEPS[2] (chunks that do not divide
      K) and resumed, through solve_with_checkpoints_engine: ends, prev
      and half bit-equal; each save's and load's seconds, the file's
      bytes, the device's peak memory above the start and the process's
      peak resident memory.
    * Every route of A8_ROUTES through the CLI, and of A8_MESH_ROUTES on
      two ranks sharing the card (--a8-worker children): the resumed run's
      CSVs against the straight run's within the route's bar (on the mesh
      the general engine bit-equal to one rank too), bit-equality
      printed.
    * A checkpoint the general route wrote on the card, resumed on the
      CPU: within GENERAL_TOL of the card's straight run.
    * --balance-every 2 on pallas and df (a line every 2 steps); --check
      --check-positivity on a healthy run, and --check on a run resuming
      from a checkpoint poisoned with a NaN (aborts naming the check, no
      CSV written; completes without --check); --metrics-json (the JAX
      CLI's keys, a positive rate); --trace (a Chrome trace holding
      bdf2_kernel's launches).
    * B1, B2, B4-B8 and B13-B15 each launched within the phase."""
    import glob
    import resource
    import shutil

    import torch

    from radiative_transfer_tpu_torch import load_config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_fused as cf
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.utils import checkpoint as ckpt
    from radiative_transfer_tpu_torch.utils import profiling
    from radiative_transfer_tpu_torch.utils.debug import NumericCheckError

    t_phase = time.perf_counter()
    for mod in (cs, cd, cf):
        mod.reset_launch_counts()

    # -- the main path (the bench cut to A8_BENCH_N cells) -------------------
    total, killed, every = A8_BENCH_STEPS
    cfg = gray_cfg(32, A8_BENCH_N, 3, steps=total)
    tables, _, _ = transport.build_tables(cfg)
    eng = cs.CudaSweepEngine(cfg, tables, device=dev)
    K = min(eng.max_steps_per_launch(), total)
    seeded = eng.from_ends(*general_rank_state(cfg, tables))
    pk = peak_from()
    want = planes_of(eng, eng.solve(seeded, num_steps=total))
    # The killed run starts from the same seeded state (at psi = B the
    # bench does not move).
    eng.init_state = lambda: seeded
    seconds = {"save": [], "load": []}
    real = {"save": ckpt.save_checkpoint, "load": ckpt.load_checkpoint}

    def timed(key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = real[key](*args, **kw)
            seconds[key].append(time.perf_counter() - t0)
            return out
        return call

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckdir = os.path.join(tmp, "bench_ck")
        ckpt.save_checkpoint, ckpt.load_checkpoint = (timed("save"),
                                                      timed("load"))
        try:
            ckpt.solve_with_checkpoints_engine(eng, cfg, ckdir, every,
                                               num_steps=killed)
            st, resumed = ckpt.solve_with_checkpoints_engine(
                eng, cfg, ckdir, every, num_steps=total)
        finally:
            ckpt.save_checkpoint = real["save"]
            ckpt.load_checkpoint = real["load"]
        file_bytes = os.path.getsize(ckpt.checkpoint_path(ckdir, total))
    got = planes_of(eng, st)
    dev_peak = pk()
    bench_s = time.perf_counter() - t0
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    bench_err = max(nerr(a, b) for a, b in zip(got, want))
    bench_bit = all(torch.equal(a, b) for a, b in zip(got, want))
    if resumed != killed or not bench_bit:
        raise AssertionError(f"phase 15 bench: resumed from {resumed} (not "
                             f"{killed}) or resumed vs straight "
                             f"{bench_err:.3e}, not bit-equal")
    del eng, seeded, want, got, st
    bench_line = (
        f"main path (gray S_{cfg.M}, N=2^"
        f"{cfg.N.bit_length() - 1}, BDF2, CudaSweepEngine B1 K={K}, from a "
        f"seeded state): {total} steps straight vs killed at {killed} (a "
        f"checkpoint every {every}: launches of K "
        + ", ".join(str(min(K, n)) for n in (every, killed - every,
                                             total - killed) if n)
        + f") and resumed from {resumed}: ends/prev/half bit-equal; saves "
        + ", ".join(f"{x:.2f}" for x in seconds["save"]) + " s, load "
        + ", ".join(f"{x:.2f}" for x in seconds["load"])
        + f" s, a checkpoint {file_bytes} bytes, device peak {dev_peak:.3f} "
        f"GiB above the start, process peak resident {host_peak:.2f} GiB, "
        f"{bench_s:.1f} s")
    total, killed, every = A8_STEPS

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # -- every other route, one device and two ranks -------------------
        decks = a8_decks(tmp)
        t0 = time.perf_counter()
        for tag, deck, args, _ in A8_ROUTES:
            a8_kill_resume(tmp, decks, tag, deck, args)
        routes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = distributed.launch_local(
            [os.path.abspath(__file__), "--a8-worker", tmp], 2, cwd=ROOT,
            timeout=600)
        two_wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"phase 15 two ranks rc {r.returncode}:"
                                     "\n" + r.stdout[-2000:]
                                     + r.stderr[-4000:])
        results, not_bit = [], []
        for tag, _, _, bar in A8_ROUTES + A8_MESH_ROUTES:
            err, same = a8_csv_err(os.path.join(tmp, f"{tag}_resumed"),
                                   os.path.join(tmp, f"{tag}_straight"))
            if not (same if bar == 0 else err <= bar):
                raise AssertionError(f"phase 15 {tag}: resumed vs straight "
                                     f"{err:.3e}, byte-equal {same} (bar "
                                     f"{bar or 'bit-equality'})")
            results.append(f"{tag} {'bit-equal' if same else f'{err:.2e}'}")
            if not same:
                not_bit.append(tag)
        err, same = a8_csv_err(os.path.join(tmp, "mesh-general_resumed"),
                               os.path.join(tmp, "general_straight"))
        if not same:
            raise AssertionError(f"phase 15: the general engine resumed on "
                                 f"two ranks vs one rank straight {err:.3e}, "
                                 "not bit-equal")

        # -- the card's general checkpoint, resumed on the CPU -------------
        cpu_ck = os.path.join(tmp, "general_cpu_ck")
        shutil.copytree(os.path.join(tmp, "general_ck"), cpu_ck)
        os.remove(ckpt.checkpoint_path(cpu_ck, total))
        a8_cli([decks["mv"], "--engine", "general", "--device", "cpu",
                "--steps", str(total), "--checkpoint-dir", cpu_ck,
                "--checkpoint-every", str(every), "--outdir",
                os.path.join(tmp, "general_cpu")])
        cpu_err, _ = a8_csv_err(os.path.join(tmp, "general_cpu"),
                                os.path.join(tmp, "general_straight"))
        if not cpu_err <= GENERAL_TOL:
            raise AssertionError(f"phase 15: the card's checkpoint resumed "
                                 f"on the CPU {cpu_err:.3e} > {GENERAL_TOL}")

        # -- the other flags ------------------------------------------------
        pallas = ["--engine", "pallas", "--dtype", "float32"]
        bal_re = re.compile(r"step\s+\d+: balance max=")
        balance = []
        for tag, args in (("pallas", pallas), ("df", ["--engine", "df"])):
            out = a8_cli([decks["mv"], *args, "--steps", str(total),
                          "--balance-every", "2", "--outdir",
                          os.path.join(tmp, f"balance_{tag}")])
            lines = sum(1 for ln in out if bal_re.match(ln))
            if lines != total // 2:
                raise AssertionError(f"phase 15 --balance-every 2 {tag}: "
                                     f"{lines} lines, not {total // 2}")
            balance.append(f"{tag} {lines} lines")
        a8_cli([decks["mv"], *pallas, "--steps", str(total), "--check",
                "--check-positivity", "--outdir",
                os.path.join(tmp, "check_ok")])
        pcfg = load_config(decks["mv"])
        ptab, _, _ = transport.build_tables(pcfg)
        st0 = transport.initial_state(pcfg, ptab)
        ends = st0.ends.clone()
        ends[0, 0, 2, 0] = float("nan")
        pdir, pout = (os.path.join(tmp, n) for n in ("poisoned_ck",
                                                     "poisoned"))
        ckpt.save_checkpoint(pdir, st0._replace(ends=ends), every, pcfg)
        argv = [decks["mv"], *pallas, "--steps", str(killed),
                "--checkpoint-dir", pdir, "--checkpoint-every", str(every),
                "--outdir", pout, "--check"]
        try:
            a8_cli(argv)
            raise AssertionError("phase 15: --check did not abort on the "
                                 "poisoned checkpoint")
        except NumericCheckError as e:
            abort = str(e)
        if ("'finite-intensity'" not in abort
                or not abort.endswith(f"at step {every}")
                or glob.glob(os.path.join(pout, "*.csv"))):
            raise AssertionError(f"phase 15 --check: {abort!r}, CSVs "
                                 f"{glob.glob(os.path.join(pout, '*.csv'))}")
        a8_cli(argv[:-1])   # the same run completes without --check
        mpath, tdir = (os.path.join(tmp, n) for n in ("metrics.json",
                                                      "trace"))
        a8_cli([decks["mv"], *pallas, "--steps", str(total),
                "--metrics-json", mpath, "--trace", tdir, "--outdir",
                os.path.join(tmp, "metrics")])
        with open(mpath) as fh:
            metrics = json.load(fh)
        if set(metrics) != METRICS_KEYS or not metrics["updates_per_s"] > 0:
            raise AssertionError(f"phase 15 --metrics-json: {metrics}")
        with open(profiling.trace_path(tdir)) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = [n for n in kernels if "bdf2_kernel" in n]
        if not named:
            raise AssertionError(
                f"phase 15 --trace: no bdf2_kernel among {len(kernels)} "
                f"kernel events (categories: "
                f"{sorted({str(e.get('cat')) for e in events})})")
        trace_bytes = os.path.getsize(profiling.trace_path(tdir))

        counts = a8_counts()
        for rank in range(2):
            with open(os.path.join(tmp, f"a8_counts_{rank}.json")) as fh:
                for name, n in json.load(fh).items():
                    counts[name] += n
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"phase 15: kernels not launched: {missing} "
                             f"({counts})")
    return (f"phase 15 A8 utilities: ok in {time.perf_counter() - t_phase:.1f}"
            f" s; {bench_line}; kill and resume through "
            f"the CLI ({total} straight vs killed at {killed} every {every} "
            f"and resumed; {routes_s:.1f} s one device, two ranks sharing the "
            f"card {two_wall:.1f} s wall with start-up): " + ", ".join(results)
            + f"; not bit-equal: {not_bit or 'none'}; mesh-general resumed "
            f"bit-equal to general straight on one rank; the card's general "
            f"checkpoint at step {killed} resumed on the CPU vs the card "
            f"{cpu_err:.1e}; --balance-every 2: " + ", ".join(balance)
            + f"; --check --check-positivity healthy ok, poisoned checkpoint "
            f"aborted ({abort!r}), no CSV, completes without --check; "
            f"--metrics-json keys ok, {metrics['updates_per_s']:.4g} "
            f"updates/s; --trace {trace_bytes} bytes, {len(kernels)} kernel "
            f"events, {len(named)} named {named[0]!r}; launches "
            f"{json.dumps(counts)}; card: {card}")


def ens_params(tables, K: int, seed: int) -> dict:
    """K opacity members: the deck's kappa x U(0.5, 2), seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kappa = np.asarray(tables.kappa)
    return {"kappa": kappa * rng.uniform(0.5, 2.0, (K,) + kappa.shape)}


def ens_rank_cases():
    """phase 16's two-rank cases: (gray_s8 cut to ENS_VMAP's N, K members)
    for solve_ensemble on a one-axis mesh, (gray_s8, ENS_K members) for the
    stacked auto engine on a 2x1 mesh; each from general_rank_state."""
    K, Nv = ENS_VMAP
    M, N, steps = ENS_S8
    return ((gray_cfg(M, Nv, 3, steps), K), (gray_cfg(M, N, 3, steps), ENS_K))


def ensemble_worker(out_path: str) -> int:
    """One rank of phase 16's two-rank run (started with
    parallel.distributed.launch_local): solve_ensemble on a one-axis mesh
    of the two ranks (each solves half the members) and the stacked
    members through make_multichip_engine's auto on a 2x1 mesh (each rank
    half the rows); rank 0 saves both gathered ensembles and the engine
    auto picked."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke ensemble worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch import ensemble as ens
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.parallel import make_multichip_engine
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod

    distributed.initialize(device_type="cuda")
    dev = distributed.local_device("cuda")
    torch.cuda.set_device(dev)
    (vcfg, vk), (scfg, sk) = ens_rank_cases()
    out = {}
    t0 = time.perf_counter()
    vtab, _, _ = transport.build_tables(vcfg)
    got = ens.solve_ensemble(vcfg, vtab, ens_params(vtab, vk, 16),
                             state=general_rank_state(vcfg, vtab),
                             mesh=mesh_mod.Mesh({"ens": 2}), device=dev)
    out["vmap"] = np.stack([x.cpu().numpy() for x in got])
    out["vmap/seconds"] = np.array(time.perf_counter() - t0)
    stab, _, _ = transport.build_tables(scfg)
    params = ens_params(stab, sk, 8)
    g = mesh_mod.make_mesh_2d(2, 1)
    t0 = time.perf_counter()
    got = ens.solve_ensemble_stacked(scfg, stab, params,
                                     state=general_rank_state(scfg, stab),
                                     mesh=g, engine="auto", device=dev)
    out["stacked"] = np.stack([x.cpu().numpy() for x in got])
    out["stacked/seconds"] = np.array(time.perf_counter() - t0)
    cfg_s, tab_s, _ = ens.stack_ensemble(scfg, stab, params)
    out["stacked/engine"] = np.array(type(make_multichip_engine(
        cfg_s, tab_s, g, engine="auto", device=dev)).__name__)
    if distributed.process_index() == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
    return 0


def ensemble_path(dev, card, peak_from, kernel_rates):
    """Phase 16, ensembles (ensemble.py, A10) and the fast engine
    (ops/fast_sweep.FastEngine, adjoint.make_diff_solve_fast: A7's first
    half, plain PyTorch) on the card. Raises on a failed check; returns
    the phase's line.

    * Stacked ensembles: gray_s8 (ENS_S8) with ENS_K seeded opacity
      members from a seeded shared state, through
      ensemble.solve_ensemble_stacked on auto (CudaSweepEngine at the
      stacked Bh: B1 at BDF2, B2 at CN) and df (DFCudaEngine: B6, B7), each
      member against its own solve on the same engine choice alone (auto's
      HaloCudaEngine, B4/B5; df's DFHaloCudaEngine, B14/B15): bit-equal,
      or within STEP_TOL (DF_TOL in hi + lo) with the reason printed; the
      stacked engine's 64 steps and each solo solve timed with CUDA events
      (the median of 3 windows: aggregate and solo updates/s).
    * The CLI's --ensemble-kappa (ENS_CLI) on the card against the same
      CLI on the CPU, every member's 8 CSVs within ENS_CLI_TOL.
    * FastEngine at the bench (GENERAL_BENCH) at float64 and float32 from
      a seeded state, against the general engine at float64 (GENERAL_TOL;
      float32 DRIFT_TOL), 8 steps after 1 timed with CUDA events, with
      peak memory, beside the general engine's rate and the kernel
      engines' (phases 5, 7).
    * make_diff_solve_fast's value and dL/dkappa at the adjoint bench
      (GENERAL_ADJ, remat) from a seeded state against make_diff_solve's
      (GENERAL_GRAD_TOL), timed against FastEngine's forward, with peak
      memory; at a cut N (GENERAL_ADJ_CPU) its value and gradients in
      kappa, rho, psi_source and the initial ends against the same call on
      the CPU (GENERAL_GRAD_TOL).
    * solve_ensemble (vmap of the general solver) at ENS_VMAP against its
      member loop (GENERAL_TOL).
    * Two ranks sharing the card (gloo, --ensemble-worker children):
      solve_ensemble on a one-axis mesh against one rank (GENERAL_TOL),
      the stacked auto members on a 2x1 mesh against one rank (TOL,
      bit-equality printed).
    * B1, B2, B4-B7, B14 and B15 each launched within the phase."""
    import numpy as np
    import torch

    from radiative_transfer_tpu_torch import adjoint as adj
    from radiative_transfer_tpu_torch import ensemble as ens
    from radiative_transfer_tpu_torch import load_config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.ops import fast_sweep as fs
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.parallel import make_multichip_engine

    def counts():
        return {name: getattr(cd if name.startswith("df_") else cs,
                              name).launches for name in PATH_ENS}

    t_phase = time.perf_counter()
    cs.reset_launch_counts()
    cd.reset_launch_counts()

    # -- stacked ensembles on gray_s8 -----------------------------------------
    M8, N8, n8 = ENS_S8
    stacked, rates = [], {}
    for ts, kname in ((3, "BDF2"), (2, "CN")):
        cfg = gray_cfg(M8, N8, ts, n8)
        tables, _, _ = transport.build_tables(cfg)
        seeded = general_rank_state(cfg, tables)
        params = ens_params(tables, ENS_K, 8)
        ups = cfg.M * cfg.N * n8 * (4 if ts == 3 else 1)    # a member's
        for engine, bar in (("auto", STEP_TOL), ("df", DF_TOL)):
            got = ens.solve_ensemble_stacked(cfg, tables, params,
                                             num_steps=n8, state=seeded,
                                             engine=engine, device=dev)
            # The stacked engine's own 64 steps, timed after a warm-up.
            cfg_s, tab_s, K = ens.stack_ensemble(cfg, tables, params)
            eng = make_multichip_engine(cfg_s, tab_s, None, engine=engine,
                                        device=dev)
            st0 = eng.from_ends(*(torch.tile(x.to(dev), (1, K, 1, 1))
                                  for x in seeded))
            eng.solve(st0, num_steps=1)
            secs, _ = median_seconds(lambda: eng.solve(st0, num_steps=n8))
            solo_rates, errs, not_bit, solo_name = [], [], [], None
            for k in range(K):
                tab_k = ens._host_member_tables(
                    cfg, tables, {"kappa": params["kappa"][k]})
                e_k = make_multichip_engine(cfg, tab_k, None, engine=engine,
                                            device=dev)
                solo_name = type(e_k).__name__
                s0 = e_k.from_ends(*seeded)
                secs_k, st_k = median_seconds(
                    lambda: e_k.solve(s0, num_steps=n8))
                solo_rates.append(ups / secs_k)
                want = planes_of(e_k, st_k)
                have = (got.ends[k], got.prev_ends[k], got.half_ends[k])
                err = max(nerr(a, b) for a, b in zip(have, want))
                errs.append(err)
                if not all(torch.equal(a, b) for a, b in zip(have, want)):
                    not_bit.append(k)
                if not err <= bar:
                    raise AssertionError(
                        f"phase 16 stacked {engine} {kname} member {k}: "
                        f"vs its own {solo_name} solve {err:.3e} > {bar}")
            agg = K * ups / secs
            rates[f"{engine} {kname}"] = {
                "stacked": type(eng).__name__, "aggregate_updates_per_s":
                agg, "solo": solo_name, "solo_updates_per_s": solo_rates}
            reason = ("" if not not_bit else
                      f" (members {not_bit} not bit-equal: the stacked "
                      f"{type(eng).__name__} at Bh {eng.Bh} and each "
                      f"member's {solo_name} at Bh {eng.Bh // K} split the "
                      "rows' tiles over blocks differently; held at "
                      f"{bar})")
            stacked.append(
                f"{engine} {kname}: stacked {type(eng).__name__} (Bh "
                f"{eng.Bh}) {agg:.6g} updates/s aggregate vs {K} solo "
                f"{solo_name} {min(solo_rates):.6g}-{max(solo_rates):.6g} "
                f"(sum of solo times {K * ups / sum(ups / r for r in solo_rates):.6g}"
                f"); members vs own solves max {max(errs):.1e}, "
                f"{'bit-equal' if not not_bit else 'not bit-equal'}"
                + reason)
            del eng, st0, got

    # -- the CLI's --ensemble-kappa, card against CPU --------------------------
    cli_lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        decks = dict(a8_decks(tmp),
                     llnl=os.path.join(ROOT, "prm", "llnl_slab_test.prm"))
        for tag, deck, K, steps, engines in ENS_CLI:
            dcfg = load_config(decks[deck])
            dtab, _, _ = transport.build_tables(dcfg)
            kpath = os.path.join(tmp, f"kappas_{tag}.txt")
            np.savetxt(kpath, ens_params(dtab, K, len(tag))["kappa"])
            worst = {}
            for engine in engines:
                outdirs, prof = {}, ""
                for device in ("cuda", "cpu"):
                    outdirs[device] = os.path.join(
                        tmp, f"ens-{tag}-{engine}-{device}")
                    out = a8_cli([decks[deck], "--engine", engine,
                                  "--ensemble-kappa", kpath, "--steps",
                                  str(steps), "--device", device, "--outdir",
                                  outdirs[device], "--profile"])
                    if device == "cuda":
                        prof = [ln for ln in out if ln.startswith("wall:")]
                err = max(a8_csv_err(
                    os.path.join(outdirs["cuda"], f"member_{k:03d}"),
                    os.path.join(outdirs["cpu"], f"member_{k:03d}"))[0]
                    for k in range(K))
                if not err <= ENS_CLI_TOL[engine]:
                    raise AssertionError(
                        f"phase 16 --ensemble-kappa {tag} {engine}: card "
                        f"vs CPU {err:.3e} > {ENS_CLI_TOL[engine]}")
                worst[engine] = f"{err:.1e} [{prof[0] if prof else ''}]"
            cli_lines.append(f"{tag} K={K} {steps} steps: " + ", ".join(
                f"{e} {v}" for e, v in worst.items()))

    # -- FastEngine at the bench, float64 and float32 --------------------------
    Mb, Nb, nb = GENERAL_BENCH
    bcfg = gray_cfg(Mb, Nb, 3)
    btab, _, _ = transport.build_tables(bcfg)
    bst = general_rank_state(bcfg, btab)
    ups = 4 * Mb * Nb * nb
    st = transport.solve(bcfg, btab, bst, 1, device=dev)
    g_secs, st = cuda_seconds(lambda: transport.solve(bcfg, btab, st, nb,
                                                      device=dev))
    truth = [x.clone() for x in st]
    del st
    fast = {"general float64 updates_per_s": ups / g_secs}
    for dname, dtype, bar in (("float64", torch.float64, GENERAL_TOL),
                              ("float32", torch.float32, DRIFT_TOL)):
        pk = peak_from()
        feng = fs.FastEngine(bcfg, btab, dtype=dtype, device=dev)
        fst = feng.solve(feng.from_ends(*bst), num_steps=1)
        secs, fst = cuda_seconds(lambda: feng.solve(fst, num_steps=nb))
        peak = pk()
        err = max(nerr(a, b) for a, b in zip(planes_of(feng, fst), truth))
        if not err <= bar:
            raise AssertionError(f"phase 16 FastEngine {dname} vs the "
                                 f"general engine {err:.3e} > {bar}")
        fast[f"FastEngine {dname}"] = {
            "updates_per_s": ups / secs, "seconds": secs, "peak_gib": peak,
            "vs general float64": float(f"{err:.2e}"),
            "chunk x nc": f"{feng.chunk} x {feng.nc}"}
        del feng, fst
    del truth, bst

    # -- make_diff_solve_fast at the adjoint bench, and against the CPU ------
    Ma, Na, na = GENERAL_ADJ
    acfg = gray_cfg(Ma, Na, 3, na)
    atab, _, _ = transport.build_tables(acfg)
    ast = general_rank_state(acfg, atab)
    aeng = fs.FastEngine(acfg, atab, dtype=torch.float64, device=dev)
    f_secs, _ = cuda_seconds(lambda: aeng.ends(aeng.solve(
        aeng.from_ends(*ast), num_steps=na)))
    del aeng
    kap = torch.ones(1, dtype=torch.float64, requires_grad=True)

    def value_and_grad(make, steps):
        sfg = make(acfg, atab, num_steps=steps, device=dev)
        kap.grad = None
        val = torch.sum(sfg({"kappa": kap}, ast).ends ** 2) * 1e-3
        val.backward()
        return float(val.detach()), float(kap.grad[0])

    value_and_grad(adj.make_diff_solve_fast, 1)        # warm-up
    pk = peak_from()
    fg_secs, (fval, fgrad) = cuda_seconds(
        lambda: value_and_grad(adj.make_diff_solve_fast, na))
    fg_peak = pk()
    gg_secs, (gval, ggrad) = cuda_seconds(
        lambda: value_and_grad(adj.make_diff_solve, na))
    v_err = abs(fval - gval) / abs(gval)
    k_err = abs(fgrad - ggrad) / abs(ggrad)
    if not (v_err <= GENERAL_GRAD_TOL and k_err <= GENERAL_GRAD_TOL):
        raise AssertionError(f"phase 16 adjoint bench: make_diff_solve_fast "
                             f"vs make_diff_solve value {v_err:.3e}, "
                             f"dL/dkappa {k_err:.3e} > {GENERAL_GRAD_TOL}")
    cpu_errs = grads_card_vs_cpu(adj.make_diff_solve_fast, dev)
    Mc, Nc, nc = GENERAL_ADJ_CPU
    if not max(cpu_errs.values()) <= GENERAL_GRAD_TOL:
        raise AssertionError(f"phase 16 make_diff_solve_fast card vs CPU: "
                             f"{cpu_errs} > {GENERAL_GRAD_TOL}")

    # -- solve_ensemble (vmap) against its member loop --------------------------
    (vcfg, vk), (scfg, sk) = ens_rank_cases()
    vtab, _, _ = transport.build_tables(vcfg)
    vst = general_rank_state(vcfg, vtab)
    vparams = ens_params(vtab, vk, 16)
    v_secs, vgot = cuda_seconds(lambda: ens.solve_ensemble(
        vcfg, vtab, vparams, state=vst, device=dev))
    sf = adj.make_diff_solve(vcfg, vtab, device=dev)
    l_secs, loop = cuda_seconds(lambda: [
        sf({"kappa": vparams["kappa"][k]}, vst) for k in range(vk)])
    v_err = max(nerr(vgot[i][k], loop[k][i]) for k in range(vk)
                for i in range(3))
    if not v_err <= GENERAL_TOL:
        raise AssertionError(f"phase 16 solve_ensemble vs its member loop "
                             f"{v_err:.3e} > {GENERAL_TOL}")
    stab, _, _ = transport.build_tables(scfg)
    sone = ens.solve_ensemble_stacked(scfg, stab, ens_params(stab, sk, 8),
                                      state=general_rank_state(scfg, stab),
                                      engine="auto", device=dev)
    launches = counts()
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"phase 16: kernels not launched: {missing} "
                             f"({launches})")

    # -- two ranks sharing the card (gloo) against one rank -----------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out_path = os.path.join(tmp, "ensemble.npz")
        t0 = time.perf_counter()
        runs = distributed.launch_local(
            [os.path.abspath(__file__), "--ensemble-worker", out_path], 2,
            cwd=ROOT, timeout=600)
        two_wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"phase 16 two ranks rc {r.returncode}:"
                                     "\n" + r.stdout[-2000:]
                                     + r.stderr[-4000:])
        ranks = dict(np.load(out_path))
    r_vmap = max(nerr(torch.as_tensor(g), w.cpu())
                 for g, w in zip(ranks["vmap"], vgot))
    r_stk = max(nerr(torch.as_tensor(g), w.cpu())
                for g, w in zip(ranks["stacked"], sone))
    r_bit = all(torch.equal(torch.as_tensor(g), w.cpu())
                for g, w in zip(ranks["stacked"], sone))
    if not (r_vmap <= GENERAL_TOL and r_stk <= TOL):
        raise AssertionError(f"phase 16 two ranks vs one: solve_ensemble "
                             f"{r_vmap:.3e} > {GENERAL_TOL} or stacked auto "
                             f"{r_stk:.3e} > {TOL}")

    return (f"phase 16 ensembles and the fast engine: ok in "
            f"{time.perf_counter() - t_phase:.1f} s; stacked gray_s8 (S_{M8}, "
            f"N=2^{N8.bit_length() - 1}, {n8} steps, K={ENS_K} opacity "
            f"members from a seeded state, CUDA events): "
            + "; ".join(stacked) + " " + json.dumps(rates)
            + "; --ensemble-kappa card vs CPU (max over members and CSVs): "
            + "; ".join(cli_lines)
            + f"; FastEngine at the bench (gray S_{Mb}, N=2^"
            f"{Nb.bit_length() - 1}, BDF2, {nb} steps after 1, seeded): "
            + json.dumps(fast) + "; kernel engines' bench rates (phases 5, "
            "7): " + json.dumps(kernel_rates)
            + f"; make_diff_solve_fast at the adjoint bench (gray S_{Ma}, "
            f"N=2^{Na.bit_length() - 1}, {na} BDF2 steps, remat, seeded): "
            f"FastEngine forward {f_secs:.4f} s, value and grad "
            f"{fg_secs:.4f} s (grad/forward {fg_secs / f_secs:.3f}), peak "
            f"{fg_peak:.3f} GiB; make_diff_solve's value and grad "
            f"{gg_secs:.4f} s; fast vs general value {v_err:.2e}, dL/dkappa "
            f"{k_err:.2e} (fast {fgrad:.6e}, general {ggrad:.6e}); "
            f"make_diff_solve_fast card vs CPU (gray S_{Mc}, N={Nc}, {nc} "
            "steps, seeded): "
            + json.dumps({k: float(f"{v:.2e}") for k, v in cpu_errs.items()})
            + f"; solve_ensemble K={vk} gray_s8 cut to N=2^"
            f"{vcfg.N.bit_length() - 1} ({vcfg.max_timesteps} steps) "
            f"{v_secs:.3f} s vs its member loop {l_secs:.3f} s, "
            f"{v_err:.1e}; two ranks sharing the card (gloo, {two_wall:.1f} s "
            f"wall with start-up): solve_ensemble on a 2-rank mesh vs one "
            f"rank {r_vmap:.1e} ({float(ranks['vmap/seconds']):.3f} s), "
            f"stacked auto on 2x1 ({ranks['stacked/engine']}) vs one rank "
            f"{r_stk:.1e} ({'bit-equal' if r_bit else 'not bit-equal'}; "
            f"{float(ranks['stacked/seconds']):.3f} s); launches "
            f"{json.dumps(launches)}; card: {card}")


def sf_meshes(shards: int):
    """The (group, spatial) meshes ShardedFastEngine runs at on `shards`
    ranks: 1 x shards and 2 x shards/2."""
    return ((1, shards), (2, shards // 2))


def fast_mesh_worker(out_path: str, shards: int, cli_dir: str) -> int:
    """One rank of a ShardedFastEngine run (started with
    parallel.distributed.launch_local): at every mesh of sf_meshes, the
    bench (GENERAL_BENCH's shape, float64) from general_rank_state, one
    step then SF_STEPS timed; rank 0 saves the gathered (ends, prev, half)
    and every rank its seconds and peak memory. With a `cli_dir` (not
    "-"; phase 17, two ranks) also the CLI on --mesh 1x2: --engine fast on
    a8_decks' moving single_group.prm straight, killed and resumed, and
    with --balance-every 2, and --engine auto at float64 on the LLNL deck
    (each rank's stdout to cli_dir/<tag>_rank<r>.txt)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke fast mesh worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod
    from radiative_transfer_tpu_torch.parallel.sharded_fast import (
        ShardedFastEngine)

    distributed.initialize(device_type="cuda")
    dev = distributed.local_device("cuda")
    torch.cuda.set_device(dev)
    rank = distributed.process_index()
    Mb, Nb, _ = GENERAL_BENCH
    cfg = gray_cfg(Mb, Nb, 3)
    tables, _, _ = transport.build_tables(cfg)
    seeded = general_rank_state(cfg, tables)
    out = {}
    for ng, nx in sf_meshes(shards):
        m = (mesh_mod.make_mesh_2d(ng, nx) if ng > 1
             else mesh_mod.make_mesh_1d(nx))
        tag = f"{ng}x{nx}"
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        eng = ShardedFastEngine(cfg, tables, m, dtype=torch.float64,
                                device=dev)
        st = eng.solve(eng.from_ends(*seeded), num_steps=1)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        st = eng.solve(st, num_steps=SF_STEPS)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        planes = planes_of(eng, st)
        out[tag] = np.stack([p.cpu().numpy() for p in planes])
        out[tag + "/chunk"] = np.array([eng.chunk, eng.nc_l, eng.Bh_l])
        # Every rank's (seconds, peak GiB), in rank order.
        stats = torch.tensor([[secs, peak]], dtype=torch.float64, device=dev)
        for axis, n in (("x", nx), ("g", ng)):
            if n > 1:
                stats = torch.cat(tuple(m.all_gather(stats, axis)))
        out[tag + "/ranks"] = stats.cpu().numpy()
        del eng, st, planes
    if cli_dir != "-":
        decks = a8_deck_paths(cli_dir)
        base = [decks["mv"], "--engine", "fast", "--mesh", "1x2"]
        ck = ["--checkpoint-dir", os.path.join(cli_dir, "fast_ck"),
              "--checkpoint-every", str(A8_STEPS[2])]
        total, killed, _ = A8_STEPS
        runs = {"straight": base + ["--steps", str(total)],
                "killed": base + ck + ["--steps", str(killed)],
                "resumed": base + ck + ["--steps", str(total)],
                "balance": base + ["--steps", "4", "--balance-every", "2"],
                "auto": [os.path.join(ROOT, "prm", "llnl_slab_test.prm"),
                         "--engine", "auto", "--mesh", "1x2"]}
        for tag, argv in runs.items():
            lines = a8_cli(argv + ["--outdir",
                                   os.path.join(cli_dir, f"fast_{tag}")])
            with open(os.path.join(cli_dir, f"fast_{tag}_rank{rank}.txt"),
                      "w") as fh:
                fh.write("\n".join(lines))
    if rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
    return 0


def run_fast_mesh(shards: int, cli_dir: str = "-"):
    """Start `shards` ranks of fast_mesh_worker; returns (rank 0's results,
    the backend line rank 0 printed, wall seconds with start-up)."""
    import numpy as np

    from radiative_transfer_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out_path = os.path.join(tmp, "fast_mesh.npz")
        t0 = time.perf_counter()
        runs = distributed.launch_local(
            [os.path.abspath(__file__), "--fast-mesh-worker", out_path,
             str(shards), cli_dir], shards, cwd=ROOT, timeout=600)
        wall = time.perf_counter() - t0
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"{shards}-rank fast mesh run rc "
                                     f"{r.returncode}:\n" + r.stdout[-2000:]
                                     + r.stderr[-4000:])
        backend = [ln for ln in runs[0].stdout.splitlines()
                   if ln.startswith("distributed:")]
        return dict(np.load(out_path)), (backend or [""])[0], wall


def fast_mesh_vs_one(ranks, shards: int, dev):
    """Each mesh of a fast_mesh_worker run against FastEngine on one device
    from the same seeded state (GENERAL_TOL). Returns ({mesh: reading},
    FastEngine's seconds for SF_STEPS steps, its peak GiB); raises on a
    failed check."""
    import torch

    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import fast_sweep as fs

    Mb, Nb, _ = GENERAL_BENCH
    cfg = gray_cfg(Mb, Nb, 3)
    tables, _, _ = transport.build_tables(cfg)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = fs.FastEngine(cfg, tables, dtype=torch.float64, device=dev)
    st = eng.solve(eng.from_ends(*general_rank_state(cfg, tables)),
                   num_steps=1)
    secs, st = cuda_seconds(lambda: eng.solve(st, num_steps=SF_STEPS))
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    want = planes_of(eng, st)
    del eng, st
    ups = 4 * Mb * Nb * SF_STEPS
    out = {}
    for ng, nx in sf_meshes(shards):
        tag = f"{ng}x{nx}"
        err = max(nerr(torch.as_tensor(g, device=w.device), w)
                  for g, w in zip(ranks[tag], want))
        if not err <= GENERAL_TOL:
            raise AssertionError(f"ShardedFastEngine {tag} on {shards} ranks "
                                 f"vs FastEngine {err:.3e} > {GENERAL_TOL}")
        rank_s = [float(x) for x in ranks[tag + "/ranks"][:, 0]]
        out[tag] = {"vs FastEngine": float(f"{err:.2e}"),
                    "updates_per_s": ups / max(rank_s),
                    "seconds per rank": rank_s,
                    "peak GiB per rank": [float(x) for x in
                                          ranks[tag + "/ranks"][:, 1]],
                    "chunk, nc_l, Bh_l": [int(x) for x in
                                          ranks[tag + "/chunk"]]}
    out["FastEngine one device"] = {"updates_per_s": ups / secs,
                                    "seconds": secs, "peak GiB": peak}
    return out


def steady_fast_path(dev, card, peak_from):
    """Phase 17, steady state (steady.py) and the sharded fast engine
    (parallel/sharded_fast.py): A7's second half, plain PyTorch, no kernel
    of its own. Raises on a failed check; returns the phase's line.

    * solve_steady at the bench (STEADY_BENCH, uncut) at float64 and
      float32: finite, its seconds (CUDA events, after one call) and peak
      memory, and a fixed point of the dt-free BE sub-step: one more
      sub-step from its ends moves them by at most the solve's tol; at
      STEADY_CPU_N against the same call on the CPU (GENERAL_TOL; float32
      DRIFT_TOL).
    * solve_steady_cycle on the gray S_32 rows of STEADY_CYCLE: its
      matvecs, seconds and fixed-point residual (< 1e-10), and its ends
      against solve_steady's (at BE and CN the two are one fixed point:
      GENERAL_TOL; at BDF2 the cycle's bias, docs/QUIRKS.md #16,
      recorded).
    * The CLI's --steady and --steady --steady-method cycle on every
      shipped deck (STEADY_DECKS) against the CLI on the CPU
      (GENERAL_TOL), with the sweeps or matvecs and seconds; the card's
      --steady on single_group.prm against a BE march (dt = 1) on
      --engine df run to its own convergence (STEADY_MARCH; DF_CLI_TOL).
    * ShardedFastEngine at the bench on two ranks sharing the card (gloo,
      --fast-mesh-worker children) at 1x2 and 2x1 against FastEngine on
      one device (GENERAL_TOL): updates/s and peak memory per rank.
    * The CLI on the fast mesh in the same ranks: --engine fast --mesh 1x2
      killed and resumed (byte-equal CSVs) and --balance-every 2 on
      a8_decks' moving single_group.prm, and --engine auto at float64 on
      --mesh 1x2 with the LLNL deck at its shipped dt, which takes JAX's
      fallback to ShardedFastEngine (within GENERAL_TOL of the
      single-device --engine fast CLI)."""
    import numpy as np
    import scipy
    import torch

    from radiative_transfer_tpu_torch import load_config, steady
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import fast_sweep as fs

    t_phase = time.perf_counter()
    # -- solve_steady at the bench, float64 and float32 ------------------------
    Mb, Nb = STEADY_BENCH
    bcfg = gray_cfg(Mb, Nb, 3)
    btab, _, _ = transport.build_tables(bcfg)
    bench = {}
    for dname, dtype in (("float64", torch.float64),
                         ("float32", torch.float32)):
        tol = 50.0 * float(torch.finfo(dtype).eps)
        steady.solve_steady(bcfg, btab, dtype=dtype, device=dev)
        pk = peak_from()
        secs, sr = cuda_seconds(lambda: steady.solve_steady(
            bcfg, btab, dtype=dtype, device=dev))
        peak = pk()
        if not bool(torch.isfinite(sr.ends).all()):
            raise AssertionError(f"phase 17 solve_steady bench {dname}: not "
                                 "finite")
        eng = fs.FastEngine(bcfg, btab, dtype=dtype, device=dev)
        kc = steady._on_device(steady.build_steady_coeffs(bcfg, btab, dtype),
                               eng)
        st = eng.from_ends(sr.ends, sr.ends, sr.ends)
        n0, n1 = eng.substep(fs.BE, st, kc=kc)
        moved = float(torch.maximum((n0 - st.e0).abs().max(),
                                    (n1 - st.e1).abs().max())
                      / torch.maximum(n0.abs().max(), n1.abs().max()))
        if not moved <= tol:
            raise AssertionError(f"phase 17 solve_steady bench {dname}: one "
                                 f"more sub-step moves it {moved:.3e} > "
                                 f"{tol:.3e}")
        del eng, kc, st, n0, n1
        ccfg = gray_cfg(Mb, STEADY_CPU_N, 3)
        ctab, _, _ = transport.build_tables(ccfg)
        card_ends = steady.solve_steady(ccfg, ctab, dtype=dtype,
                                        device=dev).ends
        cpu_ends = steady.solve_steady(ccfg, ctab, dtype=dtype,
                                       device="cpu").ends
        c_err = nerr(card_ends.cpu(), cpu_ends)
        # float32: two float32 evaluations of one 2^14-cell scan, the f32
        # drift bar of the other card-vs-CPU comparisons.
        bar = GENERAL_TOL if dtype == torch.float64 else DRIFT_TOL
        if not c_err <= bar:
            raise AssertionError(f"phase 17 solve_steady {dname} at N="
                                 f"{STEADY_CPU_N}: card vs CPU {c_err:.3e} > "
                                 f"{bar}")
        bench[dname] = {"seconds": secs, "sweeps": sr.iterations,
                        "residual": sr.residual, "peak_gib": peak,
                        "one more sub-step moves": float(f"{moved:.2e}"),
                        f"card vs CPU at N={STEADY_CPU_N}":
                        float(f"{c_err:.2e}")}
        del sr

    # -- solve_steady_cycle on gray S_32 rows -----------------------------------
    cycles = []
    for yn, ts in STEADY_CYCLE:
        ycfg = gray_cfg(Mb, yn, ts)
        ytab, _, _ = transport.build_tables(ycfg)
        t0 = time.perf_counter()
        ysr = steady.solve_steady_cycle(ycfg, ytab, device=dev)
        y_secs = time.perf_counter() - t0
        y_err = nerr(ysr.ends, steady.solve_steady(ycfg, ytab,
                                                   device=dev).ends)
        if not (ysr.residual < 1e-10 and bool(torch.isfinite(ysr.ends).all())
                and (ts == 3 or y_err <= GENERAL_TOL)):
            raise AssertionError(f"phase 17 solve_steady_cycle ts_method {ts}"
                                 f" at N={yn}: residual {ysr.residual:.3e}, "
                                 f"vs solve_steady {y_err:.3e}")
        cycles.append(f"N=2^{yn.bit_length() - 1} ts_method {ts}: "
                      f"{ysr.iterations} matvecs, {y_secs:.2f} s, residual "
                      f"{ysr.residual:.2e}, vs solve_steady {y_err:.1e}"
                      + (" (the BDF2 cycle's bias)" if ts == 3 else ""))
        del ysr

    # -- the CLI's --steady on every shipped deck, card vs CPU ----------------
    def steady_line(lines):
        hit = [ln for ln in lines if ln.startswith("steady solve (")]
        if len(hit) != 1:
            raise AssertionError(f"phase 17: no steady line in {lines[-5:]}")
        return hit[0].split(": ", 1)[1]

    cli = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for deck in STEADY_DECKS:
            path = os.path.join(ROOT, "prm", deck)
            for method in ("direct", "cycle"):
                reading = {}
                for device in ("cuda", "cpu"):
                    out = os.path.join(tmp, f"{deck}-{method}-{device}")
                    t0 = time.perf_counter()
                    lines = a8_cli([path, "--steady", "--steady-method",
                                    method, "--device", device, "--outdir",
                                    out])
                    reading[device] = (f"{steady_line(lines)} in "
                                       f"{time.perf_counter() - t0:.2f} s")
                err, _ = a8_csv_err(os.path.join(tmp, f"{deck}-{method}-cuda"),
                                    os.path.join(tmp, f"{deck}-{method}-cpu"))
                if not err <= GENERAL_TOL:
                    raise AssertionError(f"phase 17 --steady {method} {deck}: "
                                         f"card vs CPU {err:.3e} > "
                                         f"{GENERAL_TOL}")
                cli[f"{deck} {method}"] = (f"card {reading['cuda']}, CPU "
                                           f"{reading['cpu']}, {err:.1e}")
        # The card's --steady on single_group.prm against a BE march (dt =
        # 1) on --engine df, run until it no longer moves.
        be = os.path.join(tmp, "single_group_be.prm")
        text = open(os.path.join(ROOT, "prm", "single_group.prm")).read()
        for old, new in (("ts_method=3", "ts_method=1"),
                         ("dt=0.00001", "dt=1.0")):
            if old not in text:
                raise RuntimeError(f"single_group.prm no longer says {old}")
            text = text.replace(old, new)
        with open(be, "w") as fh:
            fh.write(text)
        for n in STEADY_MARCH:
            a8_cli([be, "--engine", "df", "--steps", str(n), "--device",
                    "cuda", "--outdir", os.path.join(tmp, f"df_be_{n}")])
        conv, _ = a8_csv_err(*(os.path.join(tmp, f"df_be_{n}")
                               for n in reversed(STEADY_MARCH)))
        march, _ = a8_csv_err(
            os.path.join(tmp, "single_group.prm-direct-cuda"),
            os.path.join(tmp, f"df_be_{STEADY_MARCH[1]}"))
        if not (conv <= GENERAL_TOL and march <= DF_CLI_TOL):
            raise AssertionError(
                f"phase 17: df BE march {STEADY_MARCH[0]} vs "
                f"{STEADY_MARCH[1]} steps {conv:.3e} > {GENERAL_TOL}, or "
                f"--steady vs the march {march:.3e} > {DF_CLI_TOL}")

        # -- ShardedFastEngine and its CLI on two ranks sharing the card -------
        a8_decks(tmp)
        ranks, backend, two_wall = run_fast_mesh(2, tmp)
        sf = fast_mesh_vs_one(ranks, 2, dev)
        res, same = a8_csv_err(os.path.join(tmp, "fast_resumed"),
                               os.path.join(tmp, "fast_straight"))
        outs = {tag: [open(os.path.join(tmp, f"fast_{tag}_rank{r}.txt")
                           ).read() for r in (0, 1)]
                for tag in ("resumed", "balance", "auto")}
        if not (same and f"resumed from step {A8_STEPS[1]}"
                in outs["resumed"][0]):
            raise AssertionError(f"phase 17 --engine fast --mesh 1x2: "
                                 f"resumed vs straight {res:.3e}, not "
                                 "byte-equal or not resumed")
        if outs["balance"][0].count(": balance max=") != 2:
            raise AssertionError("phase 17 --balance-every 2 on the fast "
                                 "mesh: not two balance lines")
        if not ("falling back to the sharded XLA f64 engine"
                in outs["auto"][0] and "auto engine: ShardedFastEngine"
                in outs["auto"][0]):
            raise AssertionError("phase 17 auto f64 --mesh 1x2 on the LLNL "
                                 "deck: no ShardedFastEngine fallback")
        a8_cli([os.path.join(ROOT, "prm", "llnl_slab_test.prm"), "--engine",
                "fast", "--device", "cuda", "--outdir",
                os.path.join(tmp, "fast_llnl_one")])
        auto_err, _ = a8_csv_err(os.path.join(tmp, "fast_auto"),
                                 os.path.join(tmp, "fast_llnl_one"))
        if not auto_err <= GENERAL_TOL:
            raise AssertionError(f"phase 17 auto f64 --mesh 1x2 LLNL vs the "
                                 f"single-device fast CLI {auto_err:.3e} > "
                                 f"{GENERAL_TOL}")
        fallback = [ln for ln in outs["auto"][0].splitlines()
                    if ln.startswith("auto engine:")]

    return (f"phase 17 steady state and the sharded fast engine: ok in "
            f"{time.perf_counter() - t_phase:.1f} s; scipy {scipy.__version__}"
            f"; solve_steady at the bench (gray S_{Mb}, N=2^"
            f"{Nb.bit_length() - 1}, CUDA events after one call): "
            + json.dumps(bench) + f"; solve_steady_cycle at gray S_{Mb}: "
            + "; ".join(cycles) + "; --steady card vs "
            "CPU: " + json.dumps(cli) + f"; --steady single_group.prm vs a df "
            f"BE march (dt 1, {STEADY_MARCH[1]} steps; {STEADY_MARCH[0]} vs "
            f"{STEADY_MARCH[1]}: {conv:.1e}): {march:.1e}; ShardedFastEngine "
            f"at the bench (f64, {SF_STEPS} steps after 1, seeded) on two "
            f"ranks sharing the card ({backend}; {two_wall:.1f} s wall with "
            "start-up): " + json.dumps(sf) + "; --engine fast --mesh 1x2 "
            f"killed at {A8_STEPS[1]} and resumed to {A8_STEPS[0]}: "
            "byte-equal; --balance-every 2: two balance lines; auto f64 "
            f"--mesh 1x2 LLNL: {' / '.join(fallback)}, vs the single-device "
            f"fast CLI {auto_err:.1e}; card: {card}")


def host_cpu() -> str:
    """The host CPU as lscpu gives it: its model name, CPU family and
    model number (a virtual machine may name its model "unknown")."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    name, family, model = (fields.get(k, "?").strip() for k in
                           ("Model name", "CPU family", "Model"))
    return f"{name} (lscpu: CPU family {family}, model {model})"


@contextlib.contextmanager
def python_writers(io_mod):
    """utils/io.py's writers on their Python path inside the block."""
    native_of = io_mod._native
    io_mod._native = lambda: None
    try:
        yield
    finally:
        io_mod._native = native_of


def native_io_path(dev, card, build_line):
    """Phase 18, the native I/O (native.py, csrc/rtio.cc: A14) and the
    plot reader (plot.py: A13): host code, no kernel of its own. Raises on
    a failed check; returns the phase's line.

    * native.available() on this machine: no C++ compiler is a failure.
      `build_line` is phase 2's line on librtio.so's build (its first use).
    * The CLI once on prm/single_group.prm with --engine pallas on the
      card (NATIVE_STEPS steps), with every count zeroed just before it and
      read just after: the deck read and all 8 CSVs written through the
      library (parse_deck 1, write_matrix 3, write_psi 1, write_vector 4),
      B1 launched. The same SolveResult written again through the Python
      writers: byte-equal.
    * A float32 psi of NATIVE_PSI values, made on the card from a seed,
      written through both writers (host seconds, the copy off the card
      included): byte-equal.
    * plot.read_solution on the CLI's CSVs against the result (rtol
      1e-12); plot_solution's 5 PNGs where matplotlib is installed, else a
      line that says it is absent and plot_solution did not run."""
    import filecmp
    import importlib.util

    import numpy as np
    import torch

    from radiative_transfer_tpu_torch import cli, native, plot
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.utils import io as io_mod

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 18: native.available() is False: no C++ "
                             "compiler (g++ or c++) on PATH")
    names = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
             "right_ends")
    with tempfile.TemporaryDirectory() as tmp:
        # -- the CLI through the library; its SolveResult kept ---------------
        kept = {}
        write_csvs = io_mod.write_solution_csvs

        def keep(outdir, result, x, e_ave):
            kept.update(result=result, x=x, e_ave=e_ave)
            return write_csvs(outdir, result, x, e_ave)

        outdir = os.path.join(tmp, "cli")
        buf = io.StringIO()
        io_mod.write_solution_csvs = keep
        native.reset_call_counts()
        cs.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main([os.path.join(ROOT, "prm", "single_group.prm"),
                               "--outdir", outdir, "--engine", "pallas",
                               "--steps", str(NATIVE_STEPS), "--device",
                               "cuda"])
        finally:
            io_mod.write_solution_csvs = write_csvs
        calls = native.call_counts()
        b1 = cs.bdf2_launch.launches
        if rc != 0:
            raise AssertionError(f"phase 18: cli exit {rc}:\n"
                                 + buf.getvalue()[-3000:])
        want = {"parse_deck": 1, "read_table": 0, "write_matrix": 3,
                "write_vector": 4, "write_psi": 1}
        if calls != want or b1 == 0:
            raise AssertionError(f"phase 18: the CLI's calls into librtio.so "
                                 f"{calls} (want {want}), B1 launches {b1}")
        pydir = os.path.join(tmp, "python")
        with python_writers(io_mod):
            io_mod.write_solution_csvs(pydir, kept["result"], kept["x"],
                                       kept["e_ave"])
        if native.call_counts() != want:
            raise AssertionError("phase 18: the Python writers called "
                                 "librtio.so")
        differ = [n for n in names
                  if not filecmp.cmp(os.path.join(outdir, n + ".csv"),
                                     os.path.join(pydir, n + ".csv"),
                                     shallow=False)]
        if differ:
            raise AssertionError(f"phase 18: native vs Python CSVs differ: "
                                 f"{differ}")
        # -- the CSVs read back ------------------------------------------------
        sol = plot.read_solution(outdir)
        res = kept["result"]
        ref = {n: (np.asarray(kept[n]) if n in ("x", "e_ave")
                   else getattr(res, n).double().cpu().numpy())
               for n in names}
        for n in names:
            np.testing.assert_allclose(
                sol[n], ref[n].reshape(sol[n].shape), rtol=1e-12, atol=0,
                err_msg=f"phase 18: plot.read_solution {n}")
        if importlib.util.find_spec("matplotlib") is None:
            plotted = ("matplotlib is not installed here, so plot_solution "
                       "was not run")
        else:
            made = plot.plot_solution(sol, os.path.join(tmp, "figs"))
            if len(made) != 5 or not all(os.path.getsize(f) for f in made):
                raise AssertionError(f"phase 18: plot_solution made {made}")
            plotted = "plot_solution: 5 PNGs"
        # -- psi at NATIVE_PSI through both writers ---------------------------
        gen = torch.Generator(device=dev).manual_seed(18)
        psi = torch.rand(NATIVE_PSI, generator=gen, device=dev) * 8.0
        torch.cuda.synchronize()
        seconds = {}
        for tag in ("native", "python"):
            path = os.path.join(tmp, f"psi_{tag}.csv")
            with (python_writers(io_mod) if tag == "python"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                io_mod.write_psi(path, psi)
                seconds[tag] = time.perf_counter() - t0
        psi_bytes = os.path.getsize(os.path.join(tmp, "psi_native.csv"))
        if native.write_psi.calls != want["write_psi"] + 1:
            raise AssertionError("phase 18: psi did not go through librtio.so")
        if not filecmp.cmp(os.path.join(tmp, "psi_native.csv"),
                           os.path.join(tmp, "psi_python.csv"),
                           shallow=False):
            raise AssertionError("phase 18: psi native vs Python differ")
    M, G, N = NATIVE_PSI
    return (f"phase 18 native I/O and the plot reader: ok in "
            f"{time.perf_counter() - t_phase:.1f} s; {build_line}; the CLI "
            f"--engine pallas on single_group.prm ({NATIVE_STEPS} steps, B1 "
            f"{b1} launches): calls into librtio.so {json.dumps(calls)}, the "
            "8 CSVs byte-equal to the Python writers'; plot.read_solution vs "
            f"the result within 1e-12; {plotted}; psi float32 ({M}, {G}, "
            f"2^{N.bit_length() - 1}) = {M * G * N} values, {psi_bytes} bytes"
            f": native {seconds['native']:.3f} s, Python "
            f"{seconds['python']:.3f} s ("
            f"{seconds['python'] / seconds['native']:.2f}x), byte-equal "
            f"(host seconds; host CPU: {host_cpu()}, {os.cpu_count()} "
            f"logical CPUs); card: {card}")


def run_multichip(ranks: int, env=None):
    """The multichip example on `ranks` ranks (parallel/distributed
    .launch_local: torchrun's environment on this host); each rank's
    (launches, figures) and the wall seconds, start-up included."""
    from radiative_transfer_tpu_torch.parallel.distributed import launch_local

    t0 = time.perf_counter()
    procs = launch_local(["-c", MULTICHIP_RANK.format(root=ROOT)], ranks,
                         env=env, timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    out = []
    for rank, r in enumerate(procs):
        if r.returncode != 0 or "f32 multi-chip engine matches" not in r.stdout:
            raise AssertionError(f"multichip rank {rank} rc {r.returncode}:\n"
                                 + r.stdout[-2000:] + r.stderr[-3000:])
        tagged = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
                  for line in r.stdout.splitlines()
                  if line.startswith(("LAUNCHES ", "FIGURES "))}
        out.append((tagged["LAUNCHES"], tagged["FIGURES"]))
    return out, wall


def remat_worker(out_path: str, remat: bool) -> int:
    """One arm of phase 19's remat peaks in a process of its own (started
    with --remat-worker OUT 1|0, remat on or off, while phase 19 runs the
    examples): remat_peak on the card, written to OUT as JSON. A process's
    peak device memory is its own, whatever else shares the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke remat worker: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    def peak_from():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return lambda: (torch.cuda.max_memory_allocated() - base) / 2**30

    peak, seconds, grad = remat_peak(dev, peak_from, remat)
    with open(out_path, "w") as f:
        json.dump({"peak": peak, "seconds": seconds, "grad": grad.tolist()},
                  f)
    return 0


def remat_peak(dev, peak_from, remat: bool):
    """torch.func.vmap(torch.func.grad(...)) over make_diff_solve at
    REMAT_PEAK, with `remat` on or off: (peak GiB, seconds, the members'
    gradients)."""
    import numpy as np
    import torch

    from radiative_transfer_tpu_torch import adjoint
    from radiative_transfer_tpu_torch.models import transport

    K, M, N, steps = REMAT_PEAK
    # Off equilibrium (a source of 2 against B = 4.0931): at psi = B the
    # kappa gradient cancels to roundoff.
    cfg = gray_cfg(M, N, 3, steps).replace(
        psi_source=tuple((2.0,) for _ in range(M)))
    tables, _, _ = transport.build_tables(cfg)
    wt = torch.as_tensor(np.asarray(tables.wt), device=dev)
    gen = np.random.default_rng(19)
    kappas = torch.as_tensor(gen.uniform(0.5, 2.0, (K, 1)), device=dev)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=steps,
                                       remat=remat, device=dev)

    def loss(kappa):
        f = solve_fn({"kappa": kappa})
        phi = transport.compute_phi(transport.psi_from_ends(f.ends), wt)
        return torch.sum(phi ** 2)

    torch.cuda.synchronize()
    peak = peak_from()
    t0 = time.perf_counter()
    g = torch.func.vmap(torch.func.grad(loss))(kappas)
    torch.cuda.synchronize()
    return peak(), time.perf_counter() - t0, g.cpu().numpy()


def k_above_64(dev):
    """make_diff_solve_cuda at steps_per_launch 65 and 100 against its K =
    4 solve on the card (130 BDF2 steps of the gray slab off equilibrium,
    S_8 at 2^14 cells): {K: (value gap, gradient gap, B11 launches)}, each
    gap relative to the K = 4 figure's own magnitude."""
    import numpy as np
    import torch

    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca

    n = 130
    cfg = gray_cfg(8, 1 << 14, 3, n).replace(
        psi_source=tuple((2.0,) for _ in range(8)))
    tables, _, _ = transport.build_tables(cfg)

    def value_and_grad(K):
        sf = ca.make_diff_solve_cuda(cfg, tables, num_steps=n,
                                     steps_per_launch=K, device=dev)
        p = {"kappa": torch.ones(1, dtype=torch.float64, requires_grad=True),
             "psi_source": torch.full((8, 1), 2.0, dtype=torch.float64,
                                      requires_grad=True)}
        ca.reset_launch_counts()
        val = torch.sum(sf(p).ends ** 2) * 1e-2
        val.backward()
        return (float(val.detach()), np.concatenate(
            [p[k].grad.numpy().ravel() for k in ("kappa", "psi_source")]),
            ca.fwd_record_k_launch.launches)

    v4, g4, _ = value_and_grad(4)
    out = {}
    for K in (65, 100):
        v, g, launches = value_and_grad(K)
        out[K] = (abs(v - v4) / abs(v4),
                  float(np.abs(g - g4).max() / np.abs(g4).max()), launches)
    return out


def examples_path(dev, card):
    """Phase 19, the worked examples (ROADMAP A16) on the card, and the
    remat peak under vmap(grad) (module doc). Raises on a failed check;
    returns the phase's line."""
    import importlib

    import numpy as np
    import torch

    from radiative_transfer_tpu_torch.examples import _common

    t_phase = time.perf_counter()
    figures, launches, seconds = {}, {}, {}
    # multichip's ranks (child processes) run while this process runs the
    # other examples: its wall seconds and theirs overlap.
    multichip = {}

    def run_ranks():
        try:
            multichip["out"] = run_multichip(EXAMPLE_RANKS)
        except BaseException as e:   # re-raised below, in this thread
            multichip["error"] = e

    ranks_thread = threading.Thread(target=run_ranks)
    ranks_thread.start()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # The remat peaks (host-bound: ~20 s with remat, ~45 s without)
        # likewise, one child process an arm.
        peaks_out = {remat: os.path.join(tmp, f"remat{int(remat)}.json")
                     for remat in (True, False)}
        peaks_proc = {remat: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--remat-worker", out, str(int(remat))], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for remat, out in peaks_out.items()}
        try:
            for name, argv in EXAMPLES:
                module = importlib.import_module(
                    f"radiative_transfer_tpu_torch.examples.{name}")
                if argv is None:                     # its positional outdir
                    argv = [os.path.join(tmp, name)]
                buf = io.StringIO()
                torch.cuda.synchronize()
                _common.reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    res = module.main(argv + ["--device", "cuda"])
                torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t0
                launches[name] = _common.launch_counts()
                print(f"phase 19 {name}: {seconds[name]:.2f} s", flush=True)
                if res["rc"] != 0:
                    raise AssertionError(f"phase 19 {name}: rc {res['rc']}:\n"
                                         + buf.getvalue()[-3000:])
                figures[name] = {k: v for k, v in res.items()
                                 if isinstance(v, (int, float, str, bool))
                                 or v is None}
            # The K-fused adjoint above 64 steps a launch, while the children
            # finish.
            above = k_above_64(dev)
            remat = {}
            for arm, proc in peaks_proc.items():
                log = proc.communicate(timeout=900)[0]
                if proc.returncode != 0:
                    raise AssertionError(f"phase 19 remat worker ({arm}) rc "
                                         f"{proc.returncode}:\n{log[-3000:]}")
                with open(peaks_out[arm]) as f:
                    remat[arm] = json.load(f)
        finally:                    # no child outlives a failed check
            for proc in peaks_proc.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    ex = figures
    eq = ex["gray_equilibrium"]
    if not eq["max_element"] < 1e-6:
        raise AssertionError(f"phase 19 gray_equilibrium: {eq}")
    if not ({"bdf2_launch", "halo_bdf2_launch"} & set(
            launches["llnl_production"])) or ex["llnl_production"][
            "resumed"] != 20:
        raise AssertionError(f"phase 19 llnl_production: "
                             f"{ex['llnl_production']}, launches "
                             f"{launches['llnl_production']}")
    rp = ex["reference_precision"]
    if not (rp["drift_f32"] <= 3e-5 and rp["drift_df"] <= 1e-11
            and rp["drift_df_halo"] is not None
            and rp["drift_df_halo"] <= 1e-11):
        raise AssertionError(f"phase 19 reference_precision: drifts {rp}")
    need = {"bdf2_launch", "df_bdf2_launch", "df_halo_bdf2_launch",
            "fwd_record_k_launch", "bwd_k_launch"}
    missing = need - set(launches["reference_precision"])
    if missing:
        raise AssertionError(f"phase 19 reference_precision: kernels not "
                             f"launched: {sorted(missing)}")
    if not ex["inverse_opacity"]["worst"] < 0.05:
        raise AssertionError(f"phase 19 inverse_opacity: not the JAX "
                             f"example's PASS: {ex['inverse_opacity']}")
    un = ex["uncertainty"]
    if not abs(un["ratio"] - 1.0) < un["tol"]:
        raise AssertionError(f"phase 19 uncertainty: not the JAX example's "
                             f"PASS: {un}")
    # -- multichip on ranks sharing the card ----------------------------------
    ranks_thread.join()
    if "error" in multichip:
        raise multichip["error"]
    ranks, wall = multichip["out"]
    seconds["multichip"] = wall
    figures["multichip"] = ranks[0][1]
    launches["multichip"] = [r[0] for r in ranks]
    # -- the K-fused adjoint above 64 steps a launch -------------------------
    for K, (vgap, ggap, n11) in above.items():
        if not (vgap < 1e-4 and ggap < 1e-4
                and n11 == len(range(0, K, 64)) * (130 // K)):
            raise AssertionError(f"phase 19 steps_per_launch={K}: value "
                                 f"{vgap:.2e}, gradient {ggap:.2e} from K = "
                                 f"4, B11 launches {n11}")
    # -- the remat peak under vmap(grad) (the child's figures) ----------------
    peaks = {arm: r["peak"] for arm, r in remat.items()}
    remat_s = {arm: r["seconds"] for arm, r in remat.items()}
    g_on, g_off = (np.asarray(remat[arm]["grad"]) for arm in (True, False))
    gap = float(np.abs(g_on - g_off).max() / np.abs(g_off).max())
    if not peaks[True] < peaks[False] or not gap < 1e-12:
        raise AssertionError(f"phase 19 vmap(grad) peaks {peaks} GiB, "
                             f"gradient gap {gap:.3e}")
    K, M, N, steps = REMAT_PEAK
    rows = []
    for name in [n for n, _ in EXAMPLES] + ["multichip"]:
        cut = (f" (cut: {EXAMPLE_CUTS[name]})" if name in EXAMPLE_CUTS
               else "")
        rows.append(f"{name}{cut} {seconds[name]:.2f} s "
                    f"{json.dumps(figures[name])} launches "
                    f"{json.dumps(launches[name])}")
    return (f"phase 19 the worked examples: ok in "
            f"{time.perf_counter() - t_phase:.1f} s (wall seconds throughout: "
            "multichip's ranks and the peaks' child share the card and the "
            "host with the examples); " + "; ".join(rows)
            + f"; reference_precision recovered kappa {rp['kappa']:.4f} "
            f"(target {rp['kappa_target']:.4f}); vmap(grad) over "
            f"make_diff_solve, {K} opacity members, gray S_{M} at 2^"
            f"{N.bit_length() - 1} cells, {steps} BDF2 steps: peak "
            f"{peaks[True]:.3f} GiB with remat ({remat_s[True]:.2f} s), "
            f"{peaks[False]:.3f} GiB without ({remat_s[False]:.2f} s), "
            f"gradients {gap:.1e} apart; make_diff_solve_cuda over 130 "
            "BDF2 steps (gray S_8, 2^14 cells) at steps_per_launch 65 and "
            "100 against K = 4 (value gap, gradient gap, B11 launches): "
            + json.dumps(above) + f"; card: {card}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """'<kernel>[<kind>]: <registers> regs, <spill stores> B spilled' for
    each kernel in nvcc's -Xptxas -v output."""
    out, name, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(
                r"((?:df_|sharded_)?(?:halo_)?(?:bdf2|multistep|substep)"
                r"|fwd_record_k|fwd_record|bwd_k|bwd)_kernel"
                r"(?:ILi(\d)E)?", m.group(1))
            name = (f"{k.group(1)}_kernel"
                    + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spilled")
    return out


def build_times(log: str):
    """'<source or link>: <seconds> s' for each compiler command of the
    build log (each command's line is followed by '# <seconds> s')."""
    out, what = [], "?"
    for line in log.splitlines():
        m = re.match(r"# ([\d.]+) s$", line)
        if m:
            out.append(f"{what} {m.group(1)} s")
        elif "nvcc" in line.split(" ", 1)[0]:
            what = ("link" if "-shared" in line.split()
                    else os.path.basename(line.split()[-1]))
    return out


def nerr(got, ref) -> float:
    """max|got - ref| / max|ref|, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def df_err(got, ref) -> float:
    """nerr of hi + lo summed in float64, worst over the (hi, lo) plane
    pairs of two double-float launches' outputs."""
    return max(nerr(got[i].double() + got[i + 1].double(),
                    ref[i].double() + ref[i + 1].double())
               for i in range(0, len(ref), 2))


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` and do `flops` f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from radiative_transfer_tpu_torch import adjoint as adj
    from radiative_transfer_tpu_torch import cli, load_config, native
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import _cuda_build
    from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_fused as cf
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.ops import fast_sweep as fs
    from radiative_transfer_tpu_torch.ops.fast_sweep import (BDF, BE, CN,
                                                             FlatState)

    dev = torch.device("cuda")
    card = card_line()
    t_start = time.perf_counter()
    t_last = [t_start]

    def phase_seconds(n):
        """Print phase n's seconds (phases 1 and 2 together) and the run's
        so far."""
        now = time.perf_counter()
        print(f"phase {n} seconds: {now - t_last[0]:.1f} (run "
              f"{now - t_start:.1f})", flush=True)
        t_last[0] = now

    # -- 1. environment --------------------------------------------------------
    print(f"phase 1 environment: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}", flush=True)
    print(card, flush=True)

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda_build.build()
    _cuda_build.load()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    print(f"phase 2 build: {build_s:.1f} s ("
          + ", ".join(build_times(log)) + "); ptxas: "
          + "; ".join(ptxas_report(log)), flush=True)
    # The host I/O library, at its first use (every CLI run below reads its
    # deck and writes its CSVs through it).
    t0 = time.perf_counter()
    if not native.ensure_built():
        raise AssertionError("phase 2: librtio.so not built: no C++ "
                             "compiler (g++ or c++) on PATH")
    rtio_line = (f"librtio.so built at first use in phase 2 in "
                 f"{time.perf_counter() - t0:.2f} s by "
                 f"{shutil.which('g++') or shutil.which('c++')}")
    print(f"phase 2 {rtio_line}", flush=True)
    phase_seconds(2)

    def engine(cfg, **kw):
        tables, _, _ = transport.build_tables(cfg)
        return cs.CudaSweepEngine(cfg, tables, device=dev, **kw)

    def rand_state(eng, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        base = eng.init_state().e0
        return FlatState(*[
            (base * (0.5 + torch.rand(base.shape, generator=g, device=dev)))
            .contiguous() for _ in range(6)])

    def bdf2_plain(eng, st, K, f64=False):
        """The plain B1 launch, as the engine's FlatState (evaluated in
        float64 where f64)."""
        d = (lambda t: t.double()) if f64 else (lambda t: t)
        e0, e1, h0, h1, p0, p1 = cs.bdf2_launch_ref(
            d(eng.coef[BE]), d(eng.coef[CN]), d(eng.coef[BDF]), d(eng.bc),
            eng.flip, d(st.e0), d(st.e1), K=K, s_be=eng.kcs[BE].s,
            s_cn=eng.kcs[CN].s, s_bdf=eng.kcs[BDF].s,
            reflective=eng.reflective,
            symmetric_half=eng.cfg.bdf2_symmetric_half, blk=eng.block,
            npass_be=eng.scan_npass[BE], npass_cn=eng.scan_npass[CN],
            npass_bdf=eng.scan_npass[BDF])
        return FlatState(e0, e1, p0, p1, h0, h1)

    def multistep_plain(eng, st, K, f64=False):
        kind = BE if eng.cfg.ts_method == 1 else CN
        d = (lambda t: t.double()) if f64 else (lambda t: t)
        return cs.multistep_launch_ref(
            kind, d(eng.coef[kind]), d(eng.bc), eng.flip, d(st.e0),
            d(st.e1), K=K, s=eng.kcs[kind].s, reflective=eng.reflective,
            blk=eng.block, npass=eng.scan_npass[kind])

    def substep_planes(kind, st):
        return {BE: (st.e0, st.e1), CN: (st.e0, st.e1, st.p1),
                BDF: tuple(st)}[kind]

    def substep_plain(eng, kind, st, f64=False):
        d = (lambda t: t.double()) if f64 else (lambda t: t)
        return cs.substep_launch_ref(
            kind, d(eng.coef[kind]), d(eng.bc), eng.flip,
            [d(x) for x in substep_planes(kind, st)], s=eng.kcs[kind].s,
            reflective=eng.reflective, blk=eng.block,
            npass=eng.scan_npass[kind])

    def df_engine(cfg, **kw):
        tables, _, _ = transport.build_tables(cfg)
        return cd.DFCudaEngine(cfg, tables, device=dev, **kw)

    def df_rand(eng, seed):
        """(e0 hi, e0 lo, e1 hi, e1 lo): hi planes around the engine's
        initial state, lo parts within half an ulp of them."""
        g = torch.Generator(device=dev).manual_seed(seed)
        base = eng.init_state().hi.e0
        his = [(base * (0.5 + torch.rand(base.shape, generator=g,
                                         device=dev))).contiguous()
               for _ in range(2)]
        los = [(h * (torch.rand(h.shape, generator=g, device=dev) - 0.5)
                * 2.0 ** -24).contiguous() for h in his]
        return his[0], los[0], his[1], los[1]

    def df_launch(eng, ins, K, plain=False):
        """One B6 or B7 launch of the engine's kind, or its plain version."""
        kw = dict(K=K, reflective=eng.reflective,
                  use_corr=bool(eng.cfg.use_correction), blk=eng.block)
        if eng.cfg.ts_method == 3:
            fn = cd.df_bdf2_launch_ref if plain else cd.df_bdf2_launch
            return fn(*(eng.coef[k] for k in (BE, CN, BDF)),
                      *(eng.dcoef[k] for k in (BE, CN, BDF)), eng.bc,
                      eng.bcl, eng.flip, *ins,
                      symmetric_half=eng.cfg.bdf2_symmetric_half,
                      npass=eng.scan_npass, npass_c=eng.corr_npass, **kw)
        kind = eng.cfg.ts_method
        fn = cd.df_multistep_launch_ref if plain else cd.df_multistep_launch
        return fn(kind, eng.coef[kind], eng.dcoef[kind], eng.bc, eng.bcl,
                  eng.flip, *ins, npass=eng.scan_npass[kind],
                  npass_c=eng.corr_npass[kind], **kw)

    # -- 3. kernel parity --------------------------------------------------------
    deck = os.path.join(ROOT, "prm", "multi_group_equilibrium.prm")

    def mg(ts_method, reflective, symmetric=False):
        # M=8 x G=4 (Bh=16); N=12800 is 3 full 4096-cell kernel tiles and
        # a ragged 512-cell one (plain versions: 25 blocks of 512).
        return engine(load_config(
            deck, M=8, G=4, N=12800, ts_method=ts_method,
            bc_left_indicator=2 if reflective else 1,
            bdf2_symmetric_half=symmetric))

    checks = []

    def check(name, label, got, ref):
        errs = [nerr(g, r) for g, r in zip(got, ref)]
        checks.append(f"{label}={max(errs):.1e}")
        if not max(errs) <= TOL:
            raise AssertionError(f"{name} {label}: normalised error "
                                 f"{max(errs):.3e} > {TOL}")

    def check_f64(name, label, got, ref, ref64):
        """A kernel against its plain version where float32 rounding of the
        function itself exceeds TOL (the llnl-shipped shard: 8192-cell
        chains with a near 1 in its thin groups): both against the plain
        version evaluated in float64 on the same inputs, the kernel held
        to the float32 plain version's own distance from it plus TOL,
        which is TOL against the plain version wherever that one is
        accurate (the triangle inequality)."""
        err_k = max(nerr(g, r) for g, r in zip(got, ref64))
        err_p = max(nerr(g, r) for g, r in zip(ref, ref64))
        err_kp = max(nerr(g, r) for g, r in zip(got, ref))
        checks.append(f"{label}={err_kp:.1e} (vs float64: kernel "
                      f"{err_k:.1e}, plain {err_p:.1e})")
        if not err_k <= err_p + TOL:
            raise AssertionError(f"{name} {label}: normalised error from "
                                 f"the float64 plain version {err_k:.3e} > "
                                 f"the float32 plain version's {err_p:.3e}"
                                 f" + {TOL}")

    def f64(xs):
        return [x.double() for x in xs]

    # B3's look-back (one block a tile of cs.substep_geometry, both halves in
    # one launch) on its own shapes, each launched REPEAT times against one
    # plain launch, the worst held: the tiles' maps compose in an order that
    # depends on timing. The mg deck (Bh = 16) at BE, CN and BDF, reflective
    # and source left: a row below one tile, 6 whole tiles and a ragged
    # quarter tile, 6 whole tiles, 40 tiles and a ragged half (beyond one
    # warp's look-back window), at TOL; a 169984-cell row by check_f64 (the
    # float32 plain version lies up to ~4e-5 from float64 there); the llnl
    # deck's Bh = 124, N = 50 rows at TOL; the bench shape (gray S_32,
    # N = 2^20, reflective: the rows phase 5's step() calls launch B3 on) at
    # TOL, or by check_f64 where the float32 plain version itself lies above
    # TOL from float64 (f64_rule None decides so for each kind).
    b3_tile = cs.substep_geometry(1 << 20)[0] * 8

    def b3_hold(e, label, f64_rule=False):
        for kind, kname in ((BE, "BE"), (CN, "CN"), (BDF, "BDF")):
            st = rand_state(e, 40 + kind)
            ref = substep_plain(e, kind, st)
            ref64 = substep_plain(e, kind, st, f64=True)
            rule64 = (max(nerr(r, r64) for r, r64 in zip(ref, ref64)) > TOL
                      if f64_rule is None else f64_rule)
            hold = ref64 if rule64 else ref
            worst, worst_err = None, -1.0
            for _ in range(REPEAT):
                got = e.substep(kind, st)
                err = max(nerr(g, r) for g, r in zip(got, hold))
                if err > worst_err:
                    worst, worst_err = got, err
            tag = (f"B3-{kname}-{label}-N{e.cfg.N}-"
                   f"T{cs.substep_geometry(e.cfg.N)[1]}")
            if rule64:
                check_f64("substep_launch", tag, worst, ref, ref64)
            else:
                check("substep_launch", tag, worst, ref)

    for refl in (True, False):
        for label, Nx, f64_rule in (
                ("below-one-tile", b3_tile // 2, False),
                ("ragged", 6 * b3_tile + b3_tile // 4, False),
                ("whole-tiles", 6 * b3_tile, False),
                ("40-tiles", 40 * b3_tile + b3_tile // 2, False),
                ("long", 41 * 4096 + 2048, True)):
            b3_hold(engine(load_config(deck, M=8, G=4, N=Nx, ts_method=3,
                                       bc_left_indicator=2 if refl else 1)),
                    f"{label}-{'refl' if refl else 'src'}", f64_rule)
    b3_hold(engine(load_config(os.path.join(ROOT, "prm",
                                            "llnl_slab_test.prm"))),
            "llnl-Bh124")
    b3_hold(engine(gray_cfg(32, 1 << 20, 3)), "bench", None)
    # step() at BE and CN (B3) against B2 at K = 1 on the same state, on the
    # mg deck (both boundaries) and at the bench: both scan exactly, over
    # other tiles in another order, so STEP_TOL, not bits.
    for ts_method in (1, 2):
        for refl in (True, False, None):
            e = (engine(gray_cfg(32, 1 << 20, ts_method)) if refl is None
                 else mg(ts_method, refl))
            st = rand_state(e, 30 + ts_method)
            err = max(max(nerr(a, b) for a, b in zip(e.step(st),
                                                     e.multi_step(st, 1)))
                      for _ in range(REPEAT))
            label = (f"step-vs-B2-K1-{'BE' if ts_method == 1 else 'CN'}-"
                     + ("bench" if refl is None else
                        f"mg-{'refl' if refl else 'src'}"))
            checks.append(f"{label}={err:.1e}")
            if not err <= STEP_TOL:
                raise AssertionError(f"{label}: step() against "
                                     f"multi_step(st, 1) {err:.3e} > "
                                     f"{STEP_TOL}")
    for ts_method, K, refl in ((1, 1, True), (1, 5, False), (2, 1, False),
                               (2, 5, True)):
        e = mg(ts_method, refl)
        st = rand_state(e, 10 + K)
        check("multistep_launch",
              f"B2-{'BE' if ts_method == 1 else 'CN'}-K{K}-"
              f"{'refl' if refl else 'src'}",
              e.multi_step(st, K)[:4], multistep_plain(e, st, K))
    b1_cases = [(mg(3, True), 1, "refl-asym"), (mg(3, True), 4, "refl-asym"),
                (mg(3, False), 4, "src-asym"),
                (mg(3, True, symmetric=True), 4, "refl-sym"),
                (mg(3, False, symmetric=True), 1, "src-sym"),
                (engine(load_config(os.path.join(ROOT, "prm",
                                                 "llnl_slab_test.prm"))),
                 2, "llnl-Bh124-N50")]
    for e, K, label in b1_cases:
        st = rand_state(e, 20 + K)
        check("bdf2_launch", f"B1-K{K}-{label}", e.multi_step(st, K),
              bdf2_plain(e, st, K))
    # B1's and B2's cluster wavefronts on their own shapes, each launched
    # REPEAT times against one plain launch, the largest error held: a race
    # between the cluster's blocks shows intermittently. N_wave is 41 whole
    # 4096-cell tiles and a ragged 2048-cell one (T >= 2C for every C the
    # geometry picks; plain versions: 83 blocks of 2048); N = 1000 is a row
    # below one tile (128 threads, one ragged 1024-cell tile); 9 tiles and a
    # ragged 512 at K = 1 (B2: 1 slot, C = 1, the block sends to itself).
    # Held by check_f64: on 170k-cell rows (a up to 0.998) the float32 plain
    # version itself lies up to ~4e-5 from its float64 evaluation (measured
    # on an H100; the kernel, scanning exactly, lies closer).
    N_wave = 41 * 4096 + 2048
    wave_cases = [(3, 4, True, False, N_wave), (3, 1, False, True, N_wave),
                  (3, 8, False, False, N_wave), (3, 3, True, True, 1000),
                  (1, 5, True, False, N_wave), (2, 16, False, False, N_wave),
                  (2, 1, True, False, 9 * 4096 + 512),
                  (1, 1, False, False, 1000), (2, 3, True, False, 1000)]
    for ts_method, K, refl, sym, Nw in wave_cases:
        e = engine(load_config(deck, M=8, G=4, N=Nw, ts_method=ts_method,
                               bc_left_indicator=2 if refl else 1,
                               bdf2_symmetric_half=sym))
        threads, C, T = cs.sweep_geometry(Nw, K, e.Bh if refl else 2 * e.Bh,
                                          4 if ts_method == 3 else 1)
        st = rand_state(e, 80 + K)
        name, plain = (("bdf2_launch", bdf2_plain) if ts_method == 3 else
                       ("multistep_launch", multistep_plain))
        ref, ref64 = plain(e, st, K), plain(e, st, K, f64=True)
        worst, worst_err = None, -1.0
        for _ in range(REPEAT):
            got = e.multi_step(st, K)
            err = max(nerr(g, r) for g, r in zip(got, ref64))
            if err > worst_err:
                worst, worst_err = got, err
        tag = (f"{ {1: 'B2-BE', 2: 'B2-CN', 3: 'B1'}[ts_method]}-wave-K{K}-"
               f"{'refl' if refl else 'src'}-{'sym' if sym else 'asym'}-"
               f"N{Nw}-C{C}T{T}")
        check_f64(name, tag, worst, ref, ref64)

    def packed_f32(Mr, Gr, X, blk, seed):
        """The mg deck's packed-rows f32 inputs at M = Mr, G = Gr, N = X:
        (rows, coef, npass at plain blocks of blk cells, x0, x1, seeds(C):
        C columns of the row's scale times [0.5, 6.5))."""
        e = engine(load_config(deck, M=Mr, G=Gr, N=X, ts_method=3))
        rows = 2 * e.Bh
        coef = {k: c.reshape(rows, -1) for k, c in e.coef.items()}
        npass = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), blk, 1e-10)
                 for k in e.kcs}
        x0, x1 = (p.reshape(rows, -1) for p in rand_state(e, seed)[:2])
        g = torch.Generator(device=dev).manual_seed(seed)

        def seeds(C):
            return (x0[:, :1] * (0.5 + 6 * torch.rand(
                (rows, C), generator=g, device=dev))).contiguous()

        return rows, coef, npass, x0, x1, seeds

    # B4/B5 on packed rows (2*Bh, 12800). Blocks of 1280 cells: reset 3
    # restarts the chains at cell 3840, inside the first 4096-cell kernel
    # tile, and leaves a 8960-cell segment (2 tiles and a ragged 768).
    hblk = 1280
    for M, G in ((2, 1), (4, 2)):
        e = engine(load_config(deck, M=M, G=G, N=12800, ts_method=3))
        rows = 2 * e.Bh
        coef = {k: c.reshape(rows, -1) for k, c in e.coef.items()}
        npass = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), hblk, 1e-10)
                 for k in e.kcs}
        g = torch.Generator(device=dev).manual_seed(rows)
        st = rand_state(e, 30 + rows)
        x0, x1 = (p.reshape(rows, -1) for p in st[:2])

        def seeds(C):
            # The row's scale times a fill multiplier s in [0.5, 6.5).
            return (x0[:, :1] * (0.5 + 6 * torch.rand(
                (rows, C), generator=g, device=dev))).contiguous()

        for reset in (0, 3):
            for K, sym in ((1, False), (3, False), (3, True), (8, False)):
                sd = seeds(4 * K)
                kw = dict(K=K, symmetric_half=sym, blk=hblk,
                          npass_be=npass[BE], npass_cn=npass[CN],
                          npass_bdf=npass[BDF])
                args = (coef[BE], coef[CN], coef[BDF], sd, reset, x0, x1)
                check("halo_bdf2_launch",
                      f"B4-rows{rows}-r{reset}-K{K}-"
                      f"{'sym' if sym else 'asym'}",
                      cs.halo_bdf2_launch(*args, **kw),
                      cs.halo_bdf2_launch_ref(*args, **kw))
            for kind, label in ((BE, "BE"), (CN, "CN")):
                for K in (1, 3, 8, 16):
                    args = (kind, coef[kind], seeds(K), reset, x0, x1)
                    kw = dict(K=K, blk=hblk, npass=npass[kind])
                    check("halo_multistep_launch",
                          f"B5-{label}-rows{rows}-r{reset}-K{K}",
                          cs.halo_multistep_launch(*args, **kw),
                          cs.halo_multistep_launch_ref(*args, **kw))

    # B5's wavefront (B2's body on one cluster a packed row, the seeded
    # chain's first tile taking its mail before it reseeds) on its own
    # shapes, each launched REPEAT times against one plain launch, the
    # launches bit-identical (a race between the cluster's blocks shows
    # intermittently) and within TOL of the plain version, or by check_f64
    # where that one lies above TOL from its float64 evaluation. Packed rows
    # 2 and 32 of the mg deck, 4096-cell tiles: reset 3 or 5 blocks of 1280
    # (a halo chain of one or two tiles ending in a ragged one that sends, a
    # seeded chain with a ragged last tile); reset 0 (one chain from the
    # seeds; at K = 1 a one-block cluster that mails itself); a one-tile
    # halo chain shorter than C; a halo chain of 5 tiles at C = 3 (T_h >=
    # C); a seeded chain of C + 1 tiles, its last ragged, behind a one-tile
    # halo chain; BE and CN at K 1, 3 and 16. gray_s8's CN main launch
    # follows in phase 6.
    def b5_hold(label, args, kw, rows, X, reset_cell):
        threads, C, tm, th = cs.halo_multistep_geometry(X, kw["K"],
                                                        reset_cell, rows)
        tag = (f"B5-{label}-{'BE' if args[0] == BE else 'CN'}-rows{rows}-"
               f"X{X}-reset{reset_cell}-K{kw['K']}-C{C}-tiles{th}+{tm}")
        outs = [cs.halo_multistep_launch(*args, **kw) for _ in range(REPEAT)]
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"halo_multistep_launch {tag}: {REPEAT} "
                                 f"launches on the same inputs are not "
                                 f"bit-identical")
        ref = cs.halo_multistep_launch_ref(*args, **kw)
        err = max(nerr(g, r) for g, r in zip(outs[0], ref))
        if err <= TOL:
            b5_waves.append(f"{tag}={err:.1e}")
            return
        ref64 = cs.halo_multistep_launch_ref(
            *(a.double() if torch.is_tensor(a) else a for a in args), **kw)
        check_f64("halo_multistep_launch", tag, outs[0], ref, ref64)
        b5_waves.append(checks.pop())

    b5_waves = []
    c5 = {Kx: cs.halo_multistep_geometry(1 << 20, Kx, 2048, 2)[1]
          for Kx in (3, 16)}
    for label, kind, Mr, Gr, X, blk, reset, Kw in (
            ("ragged-halo", BE, 2, 1, 12800, 1280, 3, 3),
            ("ragged-halo", CN, 8, 4, 12800, 1280, 5, 16),
            ("ragged-halo", BE, 8, 4, 12800, 1280, 3, 1),
            ("reset0", CN, 2, 1, 12800, 1280, 0, 1),
            ("reset0", BE, 8, 4, 12800, 1280, 0, 16),
            ("halo-one-tile", CN, 2, 1, 12800, 1280, 1, 16),
            ("halo-ge-C", CN, 2, 1, 16 * 4096 + 1024, 1024, 18, 3),
            ("halo-ge-C", BE, 2, 1, 16 * 4096 + 1024, 1024, 18, 3),
            ("seeded-C+1", CN, 2, 1, 2048 + c5[3] * 4096 + 2048, 2048, 1, 3),
            ("seeded-C+1", BE, 2, 1, 2048 + c5[16] * 4096 + 2048, 2048, 1,
             16)):
        rows, coef, npass, x0w, x1w, seeds = packed_f32(
            Mr, Gr, X, blk, 330 + len(b5_waves))
        b5_hold(label, (kind, coef[kind], seeds(Kw), reset, x0w, x1w),
                dict(K=Kw, blk=blk, npass=npass[kind]), rows, X, reset * blk)

    # B6/B7, compared in hi + lo. N = 12800 is 6 full 2048-cell df tiles and
    # a ragged 512 (plain versions: 25 blocks of 512); N = 100 is one ragged
    # tile (plain: one whole-N block).
    def dmg(ts_method, reflective, symmetric=False, N=12800):
        return df_engine(load_config(
            deck, M=8, G=4, N=N, ts_method=ts_method,
            bc_left_indicator=2 if reflective else 1,
            bdf2_symmetric_half=symmetric))

    def df_check(name, label, got, ref):
        err = df_err(got, ref)
        checks.append(f"{label}={err:.1e}")
        if not err <= DF_TOL:
            raise AssertionError(f"{name} {label}: hi+lo normalised error "
                                 f"{err:.3e} > {DF_TOL}")

    b6_cases = [(dmg(3, True), 1, "refl-asym"), (dmg(3, True), 3, "refl-asym"),
                (dmg(3, False, symmetric=True), 3, "src-sym"),
                (dmg(3, True, symmetric=True), None, "refl-sym"),
                (dmg(3, False), None, "src-asym"),
                (dmg(3, True, N=100), 2, "refl-asym-N100")]
    for e, K, label in b6_cases:
        K = K or e.max_steps_per_launch()
        ins = df_rand(e, 40 + K)
        df_check("df_bdf2_launch", f"B6-K{K}-{label}", df_launch(e, ins, K),
                 df_launch(e, ins, K, plain=True))
    # The wavefront's shapes (tiles of b6_tile cells, C blocks a row as
    # df_bdf2_geometry picks them for the launch's rows), each launched
    # REPEAT times against one plain launch, the largest error held: a race
    # between the cluster's blocks shows intermittently. One tile (C = 1);
    # 3 tiles (C = T); T = C + 1 at K = 1 and at K = 2; 19 tiles, a ragged
    # last one (T not a multiple of C), at K = 3 and the engine's K.
    b6_tile = cd.df_bdf2_geometry(1 << 20, 1, 1)[0] * 4

    def c_of(K, reflective):
        return cd.df_bdf2_geometry(1 << 20, K, 16 if reflective else 32)[1]

    wave_cases = [(b6_tile, 2, True, False, True, "one-tile"),
                  (3 * b6_tile, 3, False, True, True, "C=T"),
                  ((c_of(1, True) + 1) * b6_tile, 1, True, False, False,
                   "T=C+1"),
                  ((c_of(2, False) + 1) * b6_tile, 2, False, False, True,
                   "T=C+1"),
                  (18 * b6_tile + b6_tile // 2, 3, True, True, False,
                   "ragged"),
                  (18 * b6_tile + b6_tile // 2, None, False, False, True,
                   "ragged")]
    for Nw, K, refl, sym, corr, label in wave_cases:
        e = df_engine(load_config(
            deck, M=8, G=4, N=Nw, ts_method=3,
            bc_left_indicator=2 if refl else 1, bdf2_symmetric_half=sym,
            use_correction=corr))
        K = K or e.max_steps_per_launch()
        threads, C, T = cd.df_bdf2_geometry(Nw, K, e.Bh if refl else 2 * e.Bh)
        ins = df_rand(e, 70 + K)
        ref = df_launch(e, ins, K, plain=True)
        err = max(df_err(df_launch(e, ins, K), ref) for _ in range(REPEAT))
        tag = (f"B6-{label}-K{K}-{'refl' if refl else 'src'}-"
               f"{'sym' if sym else 'asym'}-corr{int(corr)}-N{Nw}-C{C}T{T}")
        checks.append(f"{tag}={err:.1e}")
        if not err <= DF_TOL:
            raise AssertionError(f"df_bdf2_launch {tag}: hi+lo normalised "
                                 f"error {err:.3e} > {DF_TOL} (worst of "
                                 f"{REPEAT} launches)")
    for ts_method, label in ((1, "BE"), (2, "CN")):
        for K, refl in ((1, True), (1, False), (8, False)):
            e = dmg(ts_method, refl)
            ins = df_rand(e, 50 + K)
            df_check("df_multistep_launch",
                     f"B7-{label}-K{K}-{'refl' if refl else 'src'}",
                     df_launch(e, ins, K), df_launch(e, ins, K, plain=True))
    def df_truth(e, ins, K):
        """B7's function on `ins` in float64, apart from the double-float
        arithmetic: B2's plain version on the float64 coefficients
        (fast_sweep.kind_coeffs at float64), the hi + lo planes and
        boundary value, its block scans exact (the CPU tests hold the two
        together, tests/test_torch_stepwave.py (d)). Returns (e0, e1, p0,
        p1)."""
        kind = e.cfg.ts_method
        kc = fs.kind_coeffs(e.cfg, e.tables, np.float64)[kind]
        coef = torch.as_tensor(np.concatenate(
            [np.asarray(c)[0] for c in (kc.w, kc.T0, kc.q, kc.inv_det, kc.a,
                                        kc.Sbase, kc.c1, kc.c0, kc.k_ee,
                                        kc.k_p)], axis=-1), device=dev)
        x0, x1 = (ins[i].double() + ins[i + 1].double() for i in (0, 2))
        return cs.multistep_launch_ref(
            kind, coef, e.bc.double() + e.bcl.double(), e.flip, x0, x1, K=K,
            s=kc.s, reflective=e.reflective, blk=e.block,
            npass=int(np.ceil(np.log2(e.block))))

    def truth_err(got, truth):
        """nerr of a double-float launch's hi + lo planes against float64
        planes, worst over the pairs."""
        return max(nerr(got[2 * i].double() + got[2 * i + 1].double(), t)
                   for i, t in enumerate(truth))

    def b7_witness(e, ins, K):
        """B7's launch as B15 runs the same tiles, slots and arithmetic:
        each half's rows as packed rows of one chain (reset 0) seeded with
        the slots' inflow, the boundary's (hi, lo) value or, for the mu>0
        half of a reflective slab, the mu<0 launch's record through flip.
        Returns the 8 planes."""
        kind, Bh, N_ = e.cfg.ts_method, e.Bh, e.cfg.N
        kw = dict(K=K, use_corr=bool(e.cfg.use_correction), blk=e.block,
                  npass=e.scan_npass[kind], npass_c=e.corr_npass[kind])

        def rows_of(t, h):
            t = t if h is None else t[h]
            return t.reshape(-1, t.shape[-1]).contiguous()

        def run(h, sh, sl):
            return cd.df_halo_multistep_launch(
                kind, rows_of(e.coef[kind], h), rows_of(e.dcoef[kind], h),
                sh.contiguous(), sl.contiguous(), 0,
                *(rows_of(p, h) for p in ins), **kw)

        if not e.reflective:
            o = run(None, e.bc.reshape(-1, 1).expand(-1, K),
                    e.bcl.reshape(-1, 1).expand(-1, K))
            return [p.reshape(2, Bh, N_) for p in o[:8]]
        a = run(0, e.bc[0].expand(-1, K), e.bcl[0].expand(-1, K))
        flip = e.flip.long()
        b = run(1, a[8][flip], a[9][flip])
        return [torch.stack([x, y]) for x, y in zip(a[:8], b[:8])]

    # B7's wavefront (B15's body under OneChain, one slot a step) on its own
    # shapes, each launched REPEAT times against one plain launch, the
    # launches bit-identical and bit-equal to b7_witness (B15 on the same
    # tiles). The worst launch is held as check_f64 holds B1 and B2 on long
    # rows: both it and the plain version against B7's function evaluated
    # in float64 (df_truth), the kernel within the plain version's own
    # distance plus DF_TOL (which is DF_TOL against the plain version
    # wherever that one is accurate). The kernels scan in the g = 1 - a
    # form, the plain versions in JAX's (csrc/df_sweep.cu KindCoef): on
    # long rows of thin groups at BE the plain version lies above DF_TOL
    # from float64 by the float32 multiplier's bias, the kernel not. A row
    # of one 2048-cell tile; T = C + 1 tiles (C the blocks a row that
    # df_multistep_geometry picks for the launch's rows) at K = 8 and at
    # K = 1 (C = 1, the block mails itself); 19 tiles with a ragged last at
    # K = 3 (as B6's); 83 tiles (169984 cells) at K = 16; BE and CN,
    # reflective and source left (the mu>0 half of a reflective slab from
    # the mu<0 record through flip), use_correction on and off.
    b7_waves = []
    for kind, Nkey, K, refl, corr in (
            (BE, "one-tile", 3, True, True), (CN, "one-tile", 8, False, False),
            (CN, "T=C+1", 8, True, True), (BE, "T=C+1", 8, False, False),
            (CN, "T=C+1", 1, True, False), (CN, "ragged", 3, True, False),
            (BE, "ragged", 3, False, True), (BE, "ragged", 3, True, True),
            (BE, "long", 16, False, True)):
        rows7 = 16 if refl else 32
        Nw = {"one-tile": b6_tile, "ragged": 18 * b6_tile + b6_tile // 2,
              "long": 83 * b6_tile,
              "T=C+1": (cd.df_multistep_geometry(1 << 20, K, rows7)[1] + 1)
              * b6_tile}[Nkey]
        e = df_engine(load_config(
            deck, M=8, G=4, N=Nw, ts_method=kind,
            bc_left_indicator=2 if refl else 1, use_correction=corr))
        threads, C, T = cd.df_multistep_geometry(Nw, K, rows7)
        ins = df_rand(e, 75 + K)
        ref = df_launch(e, ins, K, plain=True)
        outs = [df_launch(e, ins, K) for _ in range(REPEAT)]
        err = max(df_err(o, ref) for o in outs)
        truth = df_truth(e, ins, K)
        err_k = max(truth_err(o, truth) for o in outs)
        err_p = truth_err(ref, truth)
        tag = (f"B7-{Nkey}-{'BE' if kind == BE else 'CN'}-K{K}-"
               f"{'refl' if refl else 'src'}-corr{int(corr)}-N{Nw}-C{C}T{T}")
        b7_waves.append(f"{tag}={err:.1e} (vs float64: kernel {err_k:.1e}, "
                        f"plain {err_p:.1e})")
        if not err_k <= err_p + DF_TOL:
            raise AssertionError(
                f"df_multistep_launch {tag}: hi+lo normalised error from the "
                f"float64 evaluation {err_k:.3e} (worst of {REPEAT} "
                f"launches) > the plain version's {err_p:.3e} + {DF_TOL}; "
                f"from the plain version {err:.3e}")
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"df_multistep_launch {tag}: {REPEAT} "
                                 f"launches on the same inputs are not "
                                 f"bit-identical")
        if not all(torch.equal(a, b)
                   for a, b in zip(outs[0], b7_witness(e, ins, K))):
            raise AssertionError(f"df_multistep_launch {tag}: not bit-equal "
                                 f"to B15 on the same tiles")
    torch.cuda.synchronize()
    print(f"phase 3 kernel parity: ok, max normalised error "
          + ", ".join(checks) + f"; B5 wavefront shapes (worst of {REPEAT} "
          f"launches, bit-identical): " + ", ".join(b5_waves)
          + f"; B7 wavefront shapes (worst of {REPEAT} launches, "
          f"bit-identical, bit-equal to B15 on the same tiles): "
          + ", ".join(b7_waves), flush=True)
    phase_seconds(3)

    # -- 4. main path ------------------------------------------------------------
    names = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
             "right_ends")

    def run_cli(tmp, deck_path, steps, device, tag, engine_args):
        outdir = os.path.join(tmp, f"{tag}_{device}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([deck_path, "--outdir", outdir, *engine_args,
                           "--steps", str(steps), "--device", device,
                           "--profile"])
        if rc != 0:
            raise RuntimeError(f"cli {tag} {device} exit {rc}:\n"
                               + buf.getvalue()[-3000:])
        return outdir, buf.getvalue().splitlines()

    def cli_vs_cpu(tmp, deck_path, steps, tag, engine_args, tol=DRIFT_TOL):
        """The CLI on the card against its CPU run: 8 finite CSVs within
        `tol`. Returns (summary, the card run's stdout lines)."""
        gpu_dir, out = run_cli(tmp, deck_path, steps, "cuda", tag,
                               engine_args)
        cpu_dir, _ = run_cli(tmp, deck_path, steps, "cpu", tag, engine_args)
        phi = np.loadtxt(os.path.join(cpu_dir, "phi.csv"), ndmin=2)
        worst_csv = 0.0
        for name in names:
            got = np.loadtxt(os.path.join(gpu_dir, f"{name}.csv"), ndmin=2)
            ref = np.loadtxt(os.path.join(cpu_dir, f"{name}.csv"), ndmin=2)
            if got.shape != ref.shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"{tag} {name}.csv: shape {got.shape} "
                                     f"vs {ref.shape} or not finite")
            # F cancels to roundoff at equilibrium; phi bounds it.
            scale = np.abs(phi).max() if name == "F" else np.abs(ref).max()
            err = float(np.abs(got - ref).max() / max(scale, 1e-300))
            worst_csv = max(worst_csv, err)
            if not err <= tol:
                raise AssertionError(f"{tag} {name}.csv: GPU vs CPU "
                                     f"normalised error {err:.3e} > {tol}")
        profile = [ln for ln in out if ln.startswith("wall:")]
        return (f"{tag} {steps} steps 8 CSVs finite, vs CPU "
                f"{worst_csv:.1e} [{profile[0] if profile else ''}]"), out

    def wrapper(name):
        return getattr(ca if name in PATH_ADJ + PATH_ADJ_K else
                       cf if name in PATH_FUSED else
                       cd if name.startswith("df_") else cs, name)

    # Each launch's shape since its wrapper's count was last zeroed: a shim
    # around each C entry point of the loaded library that logs the
    # arguments and calls it unchanged (the counts stay the wrappers').
    shape_log = {name: [] for name in ENTRY}
    path_shapes = {}

    def log_shapes(lib):
        for name, entry in ENTRY.items():
            def shim(*args, _fn=getattr(lib, entry), _name=name):
                if wrapper(_name).launches == 0:
                    shape_log[_name].clear()
                shape_log[_name].append(
                    tuple(a for a in args if isinstance(a, (int, float))))
                return _fn(*args)
            setattr(lib, entry, shim)

    log_shapes(_cuda_build.load())

    def read_counts(path, label):
        counts = {name: wrapper(name).launches for name in path}
        missing = [name for name, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels not launched on {label}: "
                                 f"{missing} ({counts})")
        path_shapes.update({name: list(shape_log[name]) for name in path})
        return counts

    gray_deck = os.path.join(ROOT, "prm", "single_group.prm")
    llnl_deck = os.path.join(ROOT, "prm", "llnl_slab_test.prm")

    def variant(tmp, ts_method):
        """single_group.prm with ts_method (BE 1, CN 2), written to tmp."""
        text = open(gray_deck).read()
        if "ts_method=3" not in text:
            raise RuntimeError("single_group.prm no longer says ts_method=3")
        path = os.path.join(tmp, f"single_group_ts{ts_method}.prm")
        with open(path, "w") as fh:
            fh.write(text.replace("ts_method=3", f"ts_method={ts_method}"))
        return path

    pallas = ["--engine", "pallas"]
    cs.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = [(llnl_deck, 2, "llnl"), (gray_deck, 200, "gray"),
                (variant(tmp, 1), 200, "gray-BE"),
                (variant(tmp, 2), 200, "gray-CN")]
        summary = [cli_vs_cpu(tmp, deck_path, steps, tag, pallas)[0]
                   for deck_path, steps, tag in runs]
        for ts_method in (1, 2):
            e = engine(load_config(variant(tmp, ts_method)))
            st = e.init_state()
            for _ in range(5):
                st = e.step(st)
            if not bool(torch.isfinite(e.ends(st)).all()):
                raise AssertionError(f"step() ts_method={ts_method} not finite")
        torch.cuda.synchronize()
        print("phase 4 main path: ok; " + "; ".join(summary), flush=True)
        phase_seconds(4)

    # -- 5. full size ------------------------------------------------------------
    def windows_of(solve, init, warm_steps, steps=64):
        """Three CUDA-event windows of `steps` steps after a warm-up of
        `warm_steps` (two launches, so the caching allocator already
        holds every plane a window allocates). Returns (median seconds,
        the windows, the final state)."""
        st = solve(init, warm_steps)
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            st = solve(st, steps)
            stop.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(stop) / 1e3)
        planes = [p for x in st for p in (x if isinstance(x, tuple) else (x,))]
        for plane in planes:
            m = float(plane.abs().max())
            if not np.isfinite(m) or m > 1e3:
                raise AssertionError(f"full-size state diverged (max|x|={m})")
        return sorted(windows)[1], windows, st

    def fmt_windows(windows):
        return ", ".join(f"{w:.4f}" for w in windows)

    def peak_from():
        """Starts a peak-memory reading; the returned function gives the
        peak in GiB above what was allocated when it started (tensors an
        earlier phase still holds are not the run's)."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return lambda: (torch.cuda.max_memory_allocated() - base) / 2**30

    M, N, steps = 32, 1 << 20, 64
    big = engine(gray_cfg(M, N, 3))
    K = big.max_steps_per_launch()
    peak = peak_from()
    seconds, windows, st = windows_of(
        lambda s, n: big.solve(s, num_steps=n, steps_per_launch=K),
        big.init_state(), 2 * K)
    peak_gib = peak()
    rate = 4 * M * N * steps / seconds

    def timed(fn, reps):
        fn()                                           # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out

    # step() at BE and CN on the bench workload (one B3 launch a step) and
    # the CN steps K = Kcn a launch through solve() (B2), 64 steps each,
    # windowed as the bench; M * N updates a step.
    cn_eng = engine(gray_cfg(M, N, 2))
    Kcn = cn_eng.max_steps_per_launch()

    def stepping(eng_):
        def solve(s, n):
            for _ in range(n):
                s = eng_.step(s)
            return s
        return solve

    step_rates = {}
    for ts_method, tag in ((1, "BE"), (2, "CN")):
        eng_s = cn_eng if ts_method == 2 else engine(gray_cfg(M, N, 1))
        sec_s, win_s, _ = windows_of(stepping(eng_s), eng_s.init_state(), 2)
        step_rates[f"step() {tag}"] = (M * N * steps / sec_s, win_s)
    sec_s, win_s, _ = windows_of(
        lambda s, n: cn_eng.solve(s, num_steps=n, steps_per_launch=Kcn),
        cn_eng.init_state(), 2 * Kcn)
    step_rates[f"B2 CN K={Kcn}"] = (M * N * steps / sec_s, win_s)

    launches = read_counts(PATH_PLAIN, "the main path (phases 4-5)")

    plain_ms, _ = timed(lambda: bdf2_plain(big, st, K), 1)
    # B1's and B2-CN's launch shapes at the bench: a cluster of C > 1
    # blocks a row.
    wave_grids = {}
    for tag, Kx, spp in (("B1", K, 4), ("B2-CN", Kcn, 1)):
        threads, C, T = cs.sweep_geometry(N, Kx, big.Bh, spp)
        wave_grids[tag] = (f"K={Kx}: {big.Bh} rows x {C} blocks of "
                           f"{threads} threads a launch, {T} tiles a row")
        if C < 2:
            raise AssertionError(f"{tag} at the bench runs {C} block a row")
    threads, T = cs.substep_geometry(N)
    wave_grids["B3"] = (f"{2 * big.Bh} rows x {T} tiles a row, one block of "
                        f"{threads} threads a tile, one launch")
    print(f"phase 5 full size: gray S_32 N=2^20 BDF2 K={K} block "
          f"{big.block}: {steps} steps in {seconds:.4f} s (median of "
          f"{fmt_windows(windows)}) = {rate:.6g} "
          f"updates/s (row walk: {WALK_RATES['bench']:.6g}); plain version "
          f"{plain_ms:.1f} ms per K-step launch; peak device memory "
          f"{peak_gib:.3f} GiB above the phase's start; max|x| ok; grids: "
          + "; ".join(f"{k} {v}" for k, v in wave_grids.items())
          + f"; card: {card}", flush=True)
    print(f"phase 5 stepping: gray S_32 N=2^20, {steps} steps, median of 3 "
          f"windows: " + "; ".join(
              f"{k} {r:.6g} updates/s ({fmt_windows(w)} s)"
              for k, (r, w) in step_rates.items())
          + f" (row walk: step() BE {B3_WALK['step() BE']:.6g}, CN "
          f"{B3_WALK['step() CN']:.6g}); card: {card}", flush=True)
    phase_seconds(5)

    # -- 6. tiny-batch auto route ------------------------------------------------
    from radiative_transfer_tpu_torch.parallel import make_multichip_engine
    from radiative_transfer_tpu_torch.parallel.halo_cuda import HaloCudaEngine

    # B4's wavefront (one cluster a packed row, the seeded chain's first tile
    # taking its mail before it reseeds) on its own shapes, each launched
    # REPEAT times against one plain launch, the launches bit-identical (a
    # race between the cluster's blocks shows intermittently) and within
    # TOL of the plain version, or by check_f64 where that one lies above
    # TOL from its float64 evaluation. Packed rows 2 and 32 of the mg deck,
    # 4096-cell tiles: reset 3 or 5 blocks of 1280 (a halo chain of one or
    # two tiles ending in a ragged one that sends, a seeded chain with a
    # ragged last tile); reset 0 (one chain from the seeds); a halo chain of
    # 5 tiles at C = 4 (T_h >= C); a seeded chain of C + 1 tiles, its last
    # ragged, behind a one-tile halo chain (shorter than C); K 1, 2 and 8,
    # both half modes. gray_s8's main launch follows once the engine stands.

    def b4_hold(label, args, kw, rows, X, reset_cell):
        threads, C, tm, th = cs.halo_bdf2_geometry(X, kw["K"], reset_cell,
                                                   rows)
        tag = (f"B4-{label}-rows{rows}-X{X}-reset{reset_cell}-K{kw['K']}-"
               f"{'sym' if kw['symmetric_half'] else 'asym'}-C{C}-tiles"
               f"{th}+{tm}")
        outs = [cs.halo_bdf2_launch(*args, **kw) for _ in range(REPEAT)]
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"halo_bdf2_launch {tag}: {REPEAT} launches "
                                 f"on the same inputs are not bit-identical")
        ref = cs.halo_bdf2_launch_ref(*args, **kw)
        err = max(nerr(g, r) for g, r in zip(outs[0], ref))
        if err <= TOL:
            b4_waves.append(f"{tag}={err:.1e}")
            return
        ref64 = cs.halo_bdf2_launch_ref(
            *(a.double() if torch.is_tensor(a) else a for a in args), **kw)
        check_f64("halo_bdf2_launch", tag, outs[0], ref, ref64)
        b4_waves.append(checks[-1])

    b4_waves = []
    c4 = {Kx: cs.halo_bdf2_geometry(1 << 20, Kx, 2048, 2)[1] for Kx in (2, 8)}
    for label, Mr, Gr, X, blk, reset, Kw, sym in (
            ("ragged-halo", 2, 1, 12800, 1280, 3, 2, False),
            ("ragged-halo", 8, 4, 12800, 1280, 5, 1, True),
            ("reset0", 8, 4, 12800, 1280, 0, 8, False),
            ("reset0", 2, 1, 12800, 1280, 0, 1, True),
            ("halo-ge-C", 2, 1, 16 * 4096 + 1024, 1024, 18, 1, False),
            ("seeded-C+1", 2, 1, 2048 + c4[2] * 4096 + 2048, 2048, 1, 2,
             True),
            ("seeded-C+1", 2, 1, 2048 + c4[8] * 4096 + 2048, 2048, 1, 8,
             False)):
        rows, coef, npass, x0, x1, seeds = packed_f32(Mr, Gr, X, blk,
                                                      300 + len(b4_waves))
        b4_hold(label, (coef[BE], coef[CN], coef[BDF], seeds(4 * Kw), reset,
                        x0, x1),
                dict(K=Kw, symmetric_half=sym, blk=blk, npass_be=npass[BE],
                     npass_cn=npass[CN], npass_bdf=npass[BDF]), rows, X,
                reset * blk)

    cs.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cli_summary, out = cli_vs_cpu(
            tmp, os.path.join(ROOT, "prm", "single_group.prm"), 200,
            "gray-auto", ["--engine", "auto", "--dtype", "float32"])
    if "auto engine: CudaSweepEngine (single chip)" not in out:
        raise AssertionError("cli --engine auto on single_group.prm did not "
                             "pick CudaSweepEngine: " + "; ".join(out[:4]))

    Ms, Ns = 8, 1 << 18                    # suite.py gray_s8

    def auto_engine(cfg):
        tables, _, _ = transport.build_tables(cfg)
        eng = make_multichip_engine(cfg, tables, device=dev)
        if not isinstance(eng, HaloCudaEngine):
            raise AssertionError(f"auto picked {type(eng).__name__} for "
                                 f"gray_s8 ts_method={cfg.ts_method}")
        return eng

    pairs, h_equal = [], True
    for ts_method, label in ((3, "BDF2"), (1, "BE"), (2, "CN")):
        he = auto_engine(gray_cfg(Ms, Ns, ts_method))
        pe = engine(gray_cfg(Ms, Ns, ts_method))
        hs, ps = he.solve(num_steps=64), pe.solve(num_steps=64)
        errs = [nerr(he.ends_pair(a, b), pe.ends_pair(c, d)) for a, b, c, d in
                ((hs.e0, hs.e1, ps.e0, ps.e1), (hs.p0, hs.p1, ps.p0, ps.p1),
                 (hs.h0, hs.h1, ps.h0, ps.h1))]
        if not max(errs) <= DRIFT_TOL:
            raise AssertionError(f"gray_s8 {label}: HaloCudaEngine vs "
                                 f"CudaSweepEngine ends/prev/half {errs}")
        equal = all(torch.equal(a, b) for a, b in zip(hs, ps))
        h_equal &= equal
        pairs.append(f"{label} K={he.K_launch} H={he.H} block {he.block} "
                     f"ends/prev/half {max(errs):.1e}, bit-equal {equal}")

    halo = auto_engine(gray_cfg(Ms, Ns, 3))
    Kh = halo.K_launch
    peak = peak_from()
    h_seconds, h_windows, hst = windows_of(
        lambda s, n: halo.solve(s, num_steps=n), halo.init_state(), 2 * Kh)
    h_peak = peak()
    # The same gray_s8 at CN on both engines: B5 carries HaloCudaEngine there
    # (one main and one fixup launch a group of K steps), B2
    # CudaSweepEngine.
    halo_cn = auto_engine(gray_cfg(Ms, Ns, 2))
    Khc = halo_cn.K_launch
    peak = peak_from()
    hc_seconds, hc_windows, _ = windows_of(
        lambda s, n: halo_cn.solve(s, num_steps=n), halo_cn.init_state(),
        2 * Khc)
    hc_peak = peak()
    launches.update(read_counts(PATH_AUTO, "the auto route (phase 6)"))
    plain_cn = engine(gray_cfg(Ms, Ns, 2))
    Kpc = plain_cn.max_steps_per_launch()
    peak = peak_from()
    pc_seconds, pc_windows, _ = windows_of(
        lambda s, n: plain_cn.solve(s, num_steps=n, steps_per_launch=Kpc),
        plain_cn.init_state(), 2 * Kpc)
    pc_peak = peak()
    ups_cn = Ms * Ns * 64

    plain8 = engine(gray_cfg(Ms, Ns, 3))
    K8 = plain8.max_steps_per_launch()
    peak = peak_from()
    p_seconds, p_windows, _ = windows_of(
        lambda s, n: plain8.solve(s, num_steps=n, steps_per_launch=K8),
        plain8.init_state(), 2 * K8)
    p_peak = peak()

    # One main and one fixup launch of the halo engine, as it runs them.
    rows8 = halo.rows
    x0 = torch.cat([hst.e0.new_zeros((2, halo.Bh, halo.H)), hst.e0], -1)
    x1 = torch.cat([hst.e1.new_zeros((2, halo.Bh, halo.H)), hst.e1], -1)
    main_seeds = halo._main_seeds(Kh)
    main_ms, (_, rec) = timed(
        lambda: halo._launch(Kh, main_seeds, halo.hb, x0, x1), 20)
    fix_seeds = halo._fix_seeds(Kh, rec)
    f0 = hst.e0[..., :halo.H].contiguous()
    f1 = hst.e1[..., :halo.H].contiguous()
    fix_ms, _ = timed(lambda: halo._launch(Kh, fix_seeds, 0, f0, f1), 100)
    # B4 at gray_s8's main launch (the engine's K, random planes) held as its
    # own shapes above, and its grids there and at the fixup: more than one
    # block a row at the main launch.
    g6 = torch.Generator(device=dev).manual_seed(620)
    x6 = [(x.reshape(rows8, -1) * (0.5 + torch.rand(
        (rows8, x.shape[-1]), generator=g6, device=dev))).contiguous()
        for x in (x0, x1)]
    b4_hold("gray_s8-main", (halo.coef[BE], halo.coef[CN], halo.coef[BDF],
                             main_seeds, halo.hb, *x6),
            dict(K=Kh, symmetric_half=bool(halo.cfg.bdf2_symmetric_half),
                 blk=halo.block, npass_be=halo.scan_npass[BE],
                 npass_cn=halo.scan_npass[CN],
                 npass_bdf=halo.scan_npass[BDF]), rows8, halo.H + Ns, halo.H)
    b4_grids = {}
    for tag, Xg, rc_ in (("main", halo.H + Ns, halo.H), ("fixup", halo.H, 0)):
        threads, C, tm, th = cs.halo_bdf2_geometry(Xg, Kh, rc_, rows8)
        if tag == "main" and C < 2:
            raise AssertionError(f"B4 at gray_s8 {tag}: {C} block a row")
        b4_grids[tag] = (f"{rows8} rows x {C} blocks of {threads} threads, "
                         f"tiles a row {th} (halo) + {tm} (seeded)")
    # B5 at gray_s8's CN main launch (the engine's K, random planes) held as
    # its own shapes in phase 3, and its grids there and at the fixup: more
    # than one block a row at the main launch.
    g5 = torch.Generator(device=dev).manual_seed(97)
    xc = [torch.cat([p.new_zeros((2, halo_cn.Bh, halo_cn.H)), p], -1)
          .reshape(halo_cn.rows, -1)
          * (0.5 + torch.rand((halo_cn.rows, halo_cn.H + Ns), generator=g5,
                              device=dev))
          for p in halo_cn.init_state()[:2]]
    Kc5, s5 = Khc, halo_cn._main_seeds(Khc)
    b5_args = (CN, halo_cn.coef[CN], s5, halo_cn.hb, *xc)
    b5_kw = dict(K=Kc5, blk=halo_cn.block, npass=halo_cn.scan_npass[CN])
    b5_hold("gray_s8-main", b5_args, b5_kw, halo_cn.rows, halo_cn.H + Ns,
            halo_cn.H)
    b5_grids = {}
    for tag, Xg, rc_ in (("main", halo_cn.H + Ns, halo_cn.H),
                         ("fixup", halo_cn.H, 0)):
        threads, C, tm, th = cs.halo_multistep_geometry(Xg, Khc, rc_,
                                                        halo_cn.rows)
        if tag == "main" and C < 2:
            raise AssertionError(f"B5 at gray_s8 CN {tag}: {C} block a row")
        b5_grids[tag] = (f"{halo_cn.rows} rows x {C} blocks of {threads} "
                         f"threads, tiles a row {th} (halo) + {tm} (seeded)")
    ups = 4 * Ms * Ns * 64
    print(f"phase 6 auto route: ok; {cli_summary}; B4 wavefront shapes "
          f"(worst of {REPEAT} launches, bit-identical): "
          + ", ".join(b4_waves) + f"; B4 grid at gray_s8 K={Kh}: "
          + "; ".join(f"{k} {v}" for k, v in b4_grids.items())
          + f"; gray_s8 vs "
          f"CudaSweepEngine 64 steps: {'; '.join(pairs)}; gray_s8 BDF2 "
          f"(S_8, Bh=4, N=2^18) via auto = HaloCudaEngine K={Kh} H={halo.H}: "
          f"64 steps in {h_seconds:.4f} s (median of {fmt_windows(h_windows)})"
          f" = {ups / h_seconds:.6g} updates/s (B4 on the row walk: "
          f"{B4_B15_WALK['gray_s8 HaloCudaEngine']:.6g}), peak device memory "
          f"{h_peak:.3f} GiB above the run's start, main launch "
          f"{main_ms:.3f} ms (row walk "
          f"{B4_B15_WALK['halo_bdf2_launch ms']}), fixup launch "
          f"{fix_ms:.3f} ms; CudaSweepEngine K={K8}: 64 steps in "
          f"{p_seconds:.4f} s (median of {fmt_windows(p_windows)}) = "
          f"{ups / p_seconds:.6g} updates/s (row walk: "
          f"{WALK_RATES['gray_s8 CudaSweepEngine']:.6g}), peak "
          f"{p_peak:.3f} GiB; halo/plain "
          f"{p_seconds / h_seconds:.3f}x; HaloCudaEngine vs CudaSweepEngine "
          f"bit-equal at every gray_s8 kind: {h_equal}; B5 at gray_s8 CN: "
          f"{b5_waves[-1]} (worst of {REPEAT} launches, bit-identical); B5 "
          f"grid at gray_s8 CN K={Khc}: "
          + "; ".join(f"{k} {v}" for k, v in b5_grids.items())
          + f"; gray_s8 CN via auto = HaloCudaEngine K={Khc} H={halo_cn.H}: "
          f"64 steps in {hc_seconds:.4f} s (median of "
          f"{fmt_windows(hc_windows)}) = {ups_cn / hc_seconds:.6g} updates/s "
          f"(B5 on the row walk: "
          f"{B5_B7_WALK['gray_s8 CN HaloCudaEngine']:.6g}), peak "
          f"{hc_peak:.3f} GiB; CudaSweepEngine K={Kpc}: 64 steps in "
          f"{pc_seconds:.4f} s (median of {fmt_windows(pc_windows)}) = "
          f"{ups_cn / pc_seconds:.6g} updates/s, peak {pc_peak:.3f} GiB; "
          f"halo/plain at CN {pc_seconds / hc_seconds:.3f}x; card: {card}",
          flush=True)
    phase_seconds(6)

    # -- 7. f64-grade path -----------------------------------------------------
    cd.reset_launch_counts()
    df_args = ["--engine", "df"]
    auto_line = "auto engine: df (single chip, double-float kernel)"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = [(gray_deck, 200, "gray"), (variant(tmp, 1), 200, "gray-BE"),
                (variant(tmp, 2), 200, "gray-CN"),
                (deck, 200, "mg-equilibrium"),
                (llnl_deck, 2, "llnl")]
        df_summary = [cli_vs_cpu(tmp, deck_path, steps, f"df-{tag}", df_args,
                                 DF_CLI_TOL)[0]
                      for deck_path, steps, tag in runs]
        before = cd.df_bdf2_launch.launches
        auto_summary, out = cli_vs_cpu(tmp, gray_deck, 200, "df-auto", [
            "--engine", "auto"], DF_CLI_TOL)
    if auto_line not in out or cd.df_bdf2_launch.launches == before:
        raise AssertionError("cli --engine auto at float64 did not run the df "
                             "engine: " + "; ".join(out[:4]))

    # Equilibrium: the boundary source equal to the Planck value B keeps the
    # slab at rest; the net flux F stays at double-float roundoff.
    tables0, _, _ = transport.build_tables(load_config(gray_deck))
    Bv = float(tables0.B[0])
    eq_cfg = load_config(gray_deck, psi_source=((Bv,), (Bv,)))
    eq = df_engine(eq_cfg)
    eq_res = transport.result_from_ends(eq_cfg, eq.tables,
                                        eq.ends(eq.solve(num_steps=200)))
    f_over_b = float(eq_res.F.abs().max()) / Bv
    if not f_over_b < 1e-12:
        raise AssertionError(f"df equilibrium: max|F|/B = {f_over_b:.3e} "
                             ">= 1e-12 after 200 steps")

    def df_timed(cfg):
        """The engine and its 64-step windows, as in phase 5."""
        eng = df_engine(cfg)
        Kx = eng.max_steps_per_launch()
        pk = peak_from()
        secs, wins, _ = windows_of(
            lambda s, n: eng.solve(s, num_steps=n, steps_per_launch=Kx),
            eng.init_state(), 2 * Kx)
        return eng, Kx, secs, wins, pk()

    dbig, Kd, d_seconds, d_windows, d_peak = df_timed(gray_cfg(M, N, 3))
    d_rate = 4 * M * N * steps / d_seconds
    d8, Kd8, d8_seconds, d8_windows, d8_peak = df_timed(gray_cfg(Ms, Ns, 3))
    launches.update(read_counts(PATH_DF, "the f64-grade path (phase 7)"))
    # B6's launch shapes on this path: a cluster of C > 1 blocks a row.
    b6_grids = {}
    for tag, eng_, Kx in (("df bench", dbig, Kd), ("gray_s8", d8, Kd8)):
        rows_ = eng_.Bh if eng_.reflective else 2 * eng_.Bh
        threads, C, T = cd.df_bdf2_geometry(eng_.cfg.N, Kx, rows_)
        b6_grids[tag] = (f"{rows_} rows x {C} blocks of {threads} threads "
                         f"a launch, {T} tiles a row")
        if C < 2:
            raise AssertionError(f"B6 at the {tag} runs {C} block a row")
    # B7's launch shapes at CN (the engine's K) at the df bench and at
    # gray_s8: a cluster of C > 1 blocks a row.
    b7_grids = {}
    for tag, Mx, Nx in (("df bench CN", M, N), ("gray_s8 CN", Ms, Ns)):
        eng_ = df_engine(gray_cfg(Mx, Nx, 2))
        Kx = eng_.max_steps_per_launch()
        rows_ = eng_.Bh if eng_.reflective else 2 * eng_.Bh
        threads, C, T = cd.df_multistep_geometry(Nx, Kx, rows_)
        b7_grids[tag] = (f"K={Kx}: {rows_} rows x {C} blocks of {threads} "
                         f"threads a launch, {T} tiles a row")
        if C < 2:
            raise AssertionError(f"B7 at the {tag} runs {C} block a row")
    print(f"phase 7 f64-grade path: ok; {'; '.join(df_summary)}; "
          f"{auto_summary} (prints '{auto_line}'); equilibrium max|F|/B "
          f"{f_over_b:.3e} after 200 steps; bench (gray S_32, N=2^20, BDF2) "
          f"on DFCudaEngine K={Kd} block {dbig.block}: {steps} steps in "
          f"{d_seconds:.4f} s (median of {fmt_windows(d_windows)}) = "
          f"{d_rate:.6g} updates/s, peak device memory {d_peak:.3f} GiB "
          f"above the run's start; f32/df cost ratio "
          f"{d_seconds / seconds:.3f} (phase 5: {rate:.6g}); gray_s8 BDF2 "
          f"on DFCudaEngine K={Kd8}: 64 steps in {d8_seconds:.4f} s (median "
          f"of {fmt_windows(d8_windows)}) = {ups / d8_seconds:.6g} "
          f"updates/s, peak {d8_peak:.3f} GiB; row walk: df bench "
          f"{WALK_RATES['df bench']:.6g}, gray_s8 "
          f"{WALK_RATES['df gray_s8 DFCudaEngine']:.6g} updates/s; B6 grid: "
          + "; ".join(f"{k} {v}" for k, v in b6_grids.items())
          + "; B7 grid: " + "; ".join(f"{k} {v}" for k, v in b7_grids.items())
          + f"; card: {card}", flush=True)
    phase_seconds(7)

    # -- 8. f64 tiny-batch route ---------------------------------------------
    from radiative_transfer_tpu_torch.parallel.df_halo_cuda import (
        DFHaloCudaEngine)

    # B14/B15 on packed rows (2*Bh, 12800) against their plain versions, in
    # hi + lo. Blocks of 1280 cells: reset 3 restarts the chains at cell
    # 3840, inside the second 2048-cell df tile, and leaves an 8960-cell
    # segment (4 tiles and a ragged 768) whose first tile is mid-row: the
    # K = 1 cases run one sub-step a tile there, where a slot read before
    # its barrier would show.
    def packed_df(Mr, Gr, X, blk, seed=0, **over):
        """The mg deck's packed-rows double-float inputs at M = Mr, G = Gr,
        N = X: (rows, coef, dcoef, npass and npass_c at plain blocks of blk
        cells, the 4 input planes, seeds(C): (hi, lo) seeds of C columns,
        the row's scale times [0.5, 6.5), lo within an ulp)."""
        e = df_engine(load_config(deck, M=Mr, G=Gr, N=X, ts_method=3,
                                  **over))
        rows = 2 * e.Bh
        coef = {k: c.reshape(rows, -1) for k, c in e.coef.items()}
        dcoef = {k: c.reshape(rows, -1) for k, c in e.dcoef.items()}
        npass = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), blk, 1e-10)
                 for k in e.kcs}
        npass_c = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), blk,
                                     cd.CORR_SCAN_TOL) for k in e.kcs}
        g = torch.Generator(device=dev).manual_seed(100 + seed + rows)
        ins = [p.reshape(rows, -1) for p in df_rand(e, 60 + seed + rows)]

        def seeds(C):
            sh = (ins[0][:, :1] * (0.5 + 6 * torch.rand(
                (rows, C), generator=g, device=dev))).contiguous()
            return sh, (sh * (torch.rand(sh.shape, generator=g, device=dev)
                              - 0.5) * 2.0 ** -24).contiguous()

        return rows, coef, dcoef, npass, npass_c, ins, seeds

    n_checks = len(checks)
    for Mr, Gr in ((2, 1), (8, 4)):
        rows, coef, dcoef, npass, npass_c, ins, df_seeds = packed_df(
            Mr, Gr, 12800, hblk)

        # (Kr, not K: the kernel table below times B1 at phase 5's K.)
        for reset in (0, 3):
            for Kr, sym in ((1, False), (2, True)):
                args = (*(coef[k] for k in (BE, CN, BDF)),
                        *(dcoef[k] for k in (BE, CN, BDF)),
                        *df_seeds(4 * Kr), reset, *ins)
                kw = dict(K=Kr, symmetric_half=sym, use_corr=True, blk=hblk,
                          npass=npass, npass_c=npass_c)
                df_check("df_halo_bdf2_launch",
                         f"B14-rows{rows}-r{reset}-K{Kr}-"
                         f"{'sym' if sym else 'asym'}",
                         cd.df_halo_bdf2_launch(*args, **kw),
                         cd.df_halo_bdf2_launch_ref(*args, **kw))
            for kind, label in ((BE, "BE"), (CN, "CN")):
                for Kr in (1, 3):
                    args = (kind, coef[kind], dcoef[kind], *df_seeds(Kr),
                            reset, *ins)
                    kw = dict(K=Kr, use_corr=True, blk=hblk,
                              npass=npass[kind], npass_c=npass_c[kind])
                    df_check("df_halo_multistep_launch",
                             f"B15-{label}-rows{rows}-r{reset}-K{Kr}",
                             cd.df_halo_multistep_launch(*args, **kw),
                             cd.df_halo_multistep_launch_ref(*args, **kw))
    # B14's wavefront on its own shapes (one cluster a chain, C blocks a
    # chain as df_halo_bdf2_geometry picks them for the launch's clusters),
    # each launched REPEAT times against one plain launch, the worst held to
    # DF_TOL and the launches bit-identical: a race between the cluster's
    # blocks shows intermittently. Packed rows 2 and 32: reset 3 blocks of
    # 1280 (cell 3840, off the 2048-cell tile: a ragged 2-tile halo chain
    # and a 5-tile seeded chain, its last tile ragged); reset 0 (one 7-tile
    # chain); a seeded chain of C + 1 tiles behind a 768-cell halo chain (one
    # tile, fewer than C); K 1, 2 and 4 (B6's largest at the df bench), both
    # half modes, use_correction on and off. gray_s8's main launch follows
    # once the engine stands.
    def b14_hold(label, args, kw, rows, X, reset_cell):
        threads, C, tm, th = cd.df_halo_bdf2_geometry(X, kw["K"], reset_cell,
                                                      rows)
        outs = [cd.df_halo_bdf2_launch(*args, **kw) for _ in range(REPEAT)]
        ref = cd.df_halo_bdf2_launch_ref(*args, **kw)
        err = max(df_err(o, ref) for o in outs)
        tag = (f"B14-{label}-rows{rows}-X{X}-reset{reset_cell}-K{kw['K']}-"
               f"{'sym' if kw['symmetric_half'] else 'asym'}-corr"
               f"{int(kw['use_corr'])}-C{C}-tiles{tm}+{th}")
        b14_waves.append(f"{tag}={err:.1e}")
        if not err <= DF_TOL:
            raise AssertionError(f"df_halo_bdf2_launch {tag}: hi+lo "
                                 f"normalised error {err:.3e} > {DF_TOL} "
                                 f"(worst of {REPEAT} launches)")
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"df_halo_bdf2_launch {tag}: {REPEAT} "
                                 f"launches on the same inputs are not "
                                 f"bit-identical")

    b14_waves = []
    c2 = cd.df_halo_bdf2_geometry(1 << 20, 2, 768, 2)[1]
    for label, Mr, Gr, X, blk, reset, Kw, sym, corr in (
            ("ragged-halo", 2, 1, 12800, 1280, 3, 2, False, True),
            ("ragged-halo", 8, 4, 12800, 1280, 3, 1, True, False),
            ("reset0", 8, 4, 12800, 1280, 0, 2, True, True),
            ("reset0", 2, 1, 12800, 1280, 0, 4, False, False),
            ("seeded-C+1", 2, 1, 768 + (c2 + 1) * 2048, 256, 3, 2, False,
             True),
            ("ragged-halo", 2, 1, 12800, 1280, 3, 4, True, True)):
        rows, coef, dcoef, npass, npass_c, ins, seeds = packed_df(
            Mr, Gr, X, blk, 400 + len(b14_waves), use_correction=corr)
        b14_hold(label, (*(coef[k] for k in (BE, CN, BDF)),
                         *(dcoef[k] for k in (BE, CN, BDF)), *seeds(4 * Kw),
                         reset, *ins),
                 dict(K=Kw, symmetric_half=sym, use_corr=corr, blk=blk,
                      npass=npass, npass_c=npass_c), rows, X, reset * blk)
    # B15's wavefront (one cluster a packed row, the seeded chain's first
    # tile taking its mail before it reseeds) on its own shapes, each
    # launched REPEAT times against one plain launch, the worst held to
    # DF_TOL and the launches bit-identical. 2048-cell df tiles: reset 3
    # blocks of 1280 (a ragged 2-tile halo chain that sends, a 5-tile
    # seeded chain with a ragged last tile); reset 0; a halo chain of 4
    # tiles at C = 3 (T_h >= C); a seeded chain of C + 1 tiles, its last
    # ragged, behind a one-tile halo chain (shorter than C); packed rows 2
    # and 32; BE and CN at K 1, 3 and 8; use_correction on and off.
    # gray_s8's CN main launch follows once the engine stands.
    def b15_hold(label, args, kw, rows, X, reset_cell):
        threads, C, tm, th = cd.df_halo_multistep_geometry(
            X, kw["K"], reset_cell, rows)
        outs = [cd.df_halo_multistep_launch(*args, **kw)
                for _ in range(REPEAT)]
        ref = cd.df_halo_multistep_launch_ref(*args, **kw)
        err = max(df_err(o, ref) for o in outs)
        tag = (f"B15-{label}-{'BE' if args[0] == BE else 'CN'}-rows{rows}-"
               f"X{X}-reset{reset_cell}-K{kw['K']}-corr"
               f"{int(kw['use_corr'])}-C{C}-tiles{th}+{tm}")
        b15_waves.append(f"{tag}={err:.1e}")
        if not err <= DF_TOL:
            raise AssertionError(f"df_halo_multistep_launch {tag}: hi+lo "
                                 f"normalised error {err:.3e} > {DF_TOL} "
                                 f"(worst of {REPEAT} launches)")
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"df_halo_multistep_launch {tag}: {REPEAT} "
                                 f"launches on the same inputs are not "
                                 f"bit-identical")

    b15_waves = []
    c15 = cd.df_halo_multistep_geometry(1 << 20, 8, 1024, 2)[1]
    for label, kind, Mr, Gr, X, blk, reset, Kw, corr in (
            ("ragged-halo", CN, 2, 1, 12800, 1280, 3, 3, True),
            ("ragged-halo", CN, 2, 1, 12800, 1280, 3, 1, False),
            ("ragged-halo", BE, 8, 4, 12800, 1280, 3, 1, False),
            ("reset0", CN, 8, 4, 12800, 1280, 0, 8, True),
            ("reset0", BE, 2, 1, 12800, 1280, 0, 3, True),
            ("halo-ge-C", CN, 2, 1, 12800, 1280, 5, 3, False),
            ("seeded-C+1", BE, 2, 1, 1024 + c15 * 2048 + 1024, 1024, 1, 8,
             True),
            ("seeded-C+1", CN, 2, 1, 1024 + c15 * 2048 + 1024, 1024, 1, 8,
             False)):
        rows, coef, dcoef, npass, npass_c, ins, seeds = packed_df(
            Mr, Gr, X, blk, 500 + len(b15_waves), use_correction=corr)
        b15_hold(label, (kind, coef[kind], dcoef[kind], *seeds(Kw), reset,
                         *ins),
                 dict(K=Kw, use_corr=corr, blk=blk, npass=npass[kind],
                      npass_c=npass_c[kind]), rows, X, reset * blk)
    halo_checks = checks[n_checks:]

    cd.reset_launch_counts()
    halo_line = ("auto engine: packed-rows df halo at 1-device mesh (tiny "
                 "batch)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        text = open(gray_deck).read()
        for old, new in (("N=100", "N=2048"), ("X=1.", "X=20.48")):
            if old not in text:
                raise RuntimeError(f"single_group.prm no longer says {old}")
            text = text.replace(old, new)
        thick = os.path.join(tmp, "single_group_thick.prm")
        with open(thick, "w") as fh:
            fh.write(text)
        dh_cli, out = cli_vs_cpu(tmp, thick, 200, "df-auto-thick",
                                 ["--engine", "auto"], DF_CLI_TOL)
    if auto_line not in out or halo_line not in out:
        raise AssertionError("cli --engine auto at float64 on the thick "
                             "tiny-batch deck did not pick the df halo: "
                             + "; ".join(out[:4]))

    def df_auto(cfg):
        tables, _, _ = transport.build_tables(cfg)
        eng = make_multichip_engine(cfg, tables, engine="df", device=dev)
        if not isinstance(eng, DFHaloCudaEngine):
            raise AssertionError(f"engine='df' picked {type(eng).__name__} "
                                 f"for gray_s8 ts_method={cfg.ts_method}")
        return eng

    dpairs, all_equal = [], True
    for ts_method, label in ((3, "BDF2"), (1, "BE"), (2, "CN")):
        he = df_auto(gray_cfg(Ms, Ns, ts_method))
        pe = df_engine(gray_cfg(Ms, Ns, ts_method))
        hs = he.solve(num_steps=64)
        ps = pe.solve(num_steps=64,
                      steps_per_launch=pe.max_steps_per_launch())
        errs = [df_err(a, b) for a, b in (
            ((hs.hi.e0, hs.lo.e0, hs.hi.e1, hs.lo.e1),
             (ps.hi.e0, ps.lo.e0, ps.hi.e1, ps.lo.e1)),
            ((hs.hi.p0, hs.lo.p0, hs.hi.p1, hs.lo.p1),
             (ps.hi.p0, ps.lo.p0, ps.hi.p1, ps.lo.p1)),
            ((hs.hi.h0, hs.lo.h0, hs.hi.h1, hs.lo.h1),
             (ps.hi.h0, ps.lo.h0, ps.hi.h1, ps.lo.h1)))]
        if not max(errs) <= DF_TOL:
            raise AssertionError(f"gray_s8 {label}: DFHaloCudaEngine vs "
                                 f"DFCudaEngine ends/prev/half {errs}")
        equal = all(torch.equal(a, b) for a, b in zip((*hs.hi, *hs.lo),
                                                      (*ps.hi, *ps.lo)))
        all_equal &= equal
        dpairs.append(f"{label} K={he.K_launch} H={he.H} block {he.block} "
                      f"reach {he.reach} ends/prev/half {max(errs):.1e}, "
                      f"bit-equal {equal}")

    dhalo = df_auto(gray_cfg(Ms, Ns, 3))
    Kdh = dhalo.K_launch
    peak = peak_from()
    dh_seconds, dh_windows, dhst = windows_of(
        lambda s, n: dhalo.solve(s, num_steps=n), dhalo.init_state(),
        2 * Kdh)
    dh_peak = peak()
    launches.update(read_counts(PATH_DF_HALO,
                                "the f64 tiny-batch route (phase 8)"))
    _, Kp8, dp_seconds, dp_windows, dp_peak = df_timed(gray_cfg(Ms, Ns, 3))
    # The same gray_s8 at CN on both engines: B15 carries DFHaloCudaEngine
    # there (one main and one fixup launch a group of K steps), B7
    # DFCudaEngine.
    dhalo_cn = df_auto(gray_cfg(Ms, Ns, 2))
    Kdc15 = dhalo_cn.K_launch
    dhc_seconds, dhc_windows, _ = windows_of(
        lambda s, n: dhalo_cn.solve(s, num_steps=n), dhalo_cn.init_state(),
        2 * Kdc15)
    _, Kpc8, dpc_seconds, dpc_windows, _ = df_timed(gray_cfg(Ms, Ns, 2))

    def df_packed(eng, seed):
        """(e0 hi, e0 lo, e1 hi, e1 lo) packed (rows, H + N): hi planes
        around the equilibrium value, lo parts within an ulp of them."""
        g8 = torch.Generator(device=dev).manual_seed(seed)
        shape = (eng.rows, eng.H + eng.N_loc)
        his = [float(eng.tables.B[0]) * (0.5 + torch.rand(
            shape, generator=g8, device=dev)) for _ in range(2)]
        los = [h * (torch.rand(shape, generator=g8, device=dev) - 0.5)
               * 2.0 ** -24 for h in his]
        return his[0], los[0], his[1], los[1]

    # B15 at gray_s8's CN main launch (the engine's K, random planes) held
    # as its own shapes above, and its grids there and at the fixup: more
    # than one block a row at the main launch.
    b15_args = (CN, dhalo_cn.coef[CN], dhalo_cn.dcoef[CN],
                *dhalo_cn._main_seeds(Kdc15), dhalo_cn.hb,
                *df_packed(dhalo_cn, 93))
    b15_kw = dict(K=Kdc15, use_corr=bool(dhalo_cn.cfg.use_correction),
                  blk=dhalo_cn.block, npass=dhalo_cn.scan_npass[CN],
                  npass_c=dhalo_cn.corr_npass[CN])
    b15_hold("gray_s8-main", b15_args, b15_kw, dhalo_cn.rows,
             dhalo_cn.H + Ns, dhalo_cn.H)
    b15_grids = {}
    for tag, Xg, rc_ in (("main", dhalo_cn.H + Ns, dhalo_cn.H),
                         ("fixup", dhalo_cn.H, 0)):
        threads, C, tm, th = cd.df_halo_multistep_geometry(
            Xg, Kdc15, rc_, dhalo_cn.rows)
        if tag == "main" and C < 2:
            raise AssertionError(f"B15 at gray_s8 {tag}: {C} block a row")
        b15_grids[tag] = (f"{dhalo_cn.rows} rows x {C} blocks of {threads} "
                          f"threads, tiles a row {th} (halo) + {tm} "
                          f"(seeded)")

    # One main and one fixup launch of the df halo engine, as it runs them.
    dxe = [torch.cat([p.new_zeros((2, dhalo.Bh, dhalo.H)), p], -1)
           for p in (dhst.hi.e0, dhst.lo.e0, dhst.hi.e1, dhst.lo.e1)]
    dseeds = dhalo._main_seeds(Kdh)
    dmain_ms, (_, drec) = timed(
        lambda: dhalo._launch(Kdh, dseeds, dhalo.hb, dxe), 10)
    dfix_seeds = dhalo._fix_seeds(Kdh, *drec)
    dfix_in = [p[..., :dhalo.H].contiguous()
               for p in (dhst.hi.e0, dhst.lo.e0, dhst.hi.e1, dhst.lo.e1)]
    dfix_ms, _ = timed(lambda: dhalo._launch(Kdh, dfix_seeds, 0, dfix_in),
                       50)
    # B14 at gray_s8's main launch (the engine's K, random planes) held as
    # its own shapes above, and its grids there and at the fixup: more than
    # one block a chain.
    g8 = torch.Generator(device=dev).manual_seed(520)
    d8in = [(x.reshape(dhalo.rows, -1) * (0.5 + torch.rand(
        (dhalo.rows, x.shape[-1]), generator=g8, device=dev))).contiguous()
        for x in dxe]
    b14_hold("gray_s8-main", (*(dhalo.coef[k] for k in (BE, CN, BDF)),
                              *(dhalo.dcoef[k] for k in (BE, CN, BDF)),
                              *dseeds, dhalo.hb, *d8in),
             dict(K=Kdh, symmetric_half=bool(dhalo.cfg.bdf2_symmetric_half),
                  use_corr=bool(dhalo.cfg.use_correction), blk=dhalo.block,
                  npass=dhalo.scan_npass, npass_c=dhalo.corr_npass),
             dhalo.rows, dhalo.H + Ns, dhalo.H)
    b14_grids = {}
    for tag, Xg, rc_ in (("main", dhalo.H + Ns, dhalo.H),
                         ("fixup", dhalo.H, 0)):
        threads, C, tm, th = cd.df_halo_bdf2_geometry(Xg, Kdh, rc_,
                                                      dhalo.rows)
        if C < 2:
            raise AssertionError(f"B14 at gray_s8 {tag}: {C} block a chain")
        b14_grids[tag] = (f"{dhalo.rows * (2 if th else 1)} clusters x {C} "
                          f"blocks of {threads} threads, tiles a chain "
                          f"{tm}" + (f" (seeded) and {th} (halo)" if th
                                     else ""))
    print(f"phase 8 f64 tiny-batch route: ok; kernel parity max hi+lo error "
          + ", ".join(halo_checks) + f"; B14 wavefront shapes (worst of "
          f"{REPEAT} launches, bit-identical): " + ", ".join(b14_waves)
          + "; B14 grid at gray_s8 K="
          f"{Kdh}: " + "; ".join(f"{k} {v}" for k, v in b14_grids.items())
          + f"; B15 wavefront shapes (worst of {REPEAT} launches, "
          f"bit-identical): " + ", ".join(b15_waves)
          + f"; B15 grid at gray_s8 CN K={Kdc15}: "
          + "; ".join(f"{k} {v}" for k, v in b15_grids.items())
          + f"; {dh_cli} (prints '{halo_line}'); "
          f"gray_s8 DFHaloCudaEngine vs DFCudaEngine 64 steps: "
          f"{'; '.join(dpairs)}; gray_s8 BDF2 via engine='df' = "
          f"DFHaloCudaEngine K={Kdh} H={dhalo.H}: 64 steps in "
          f"{dh_seconds:.4f} s (median of {fmt_windows(dh_windows)}) = "
          f"{ups / dh_seconds:.6g} updates/s, peak device memory "
          f"{dh_peak:.3f} GiB above the run's start, main launch "
          f"{dmain_ms:.3f} ms, fixup launch {dfix_ms:.3f} ms; DFCudaEngine "
          f"K={Kp8}: 64 steps in {dp_seconds:.4f} s (median of "
          f"{fmt_windows(dp_windows)}) = {ups / dp_seconds:.6g} updates/s, "
          f"peak {dp_peak:.3f} GiB; halo/plain "
          f"{dp_seconds / dh_seconds:.3f}x (row walk: DFHaloCudaEngine "
          f"{WALK_RATES['df gray_s8 DFHaloCudaEngine']:.6g}, DFCudaEngine "
          f"{WALK_RATES['df gray_s8 DFCudaEngine']:.6g} updates/s; B14 on "
          f"the row walk: DFHaloCudaEngine "
          f"{B11_B14_WALK['df gray_s8 DFHaloCudaEngine']:.6g} updates/s, "
          f"main launch {B11_B14_WALK['df_halo_bdf2_launch ms']} ms); "
          f"gray_s8 CN via engine='df' = DFHaloCudaEngine K={Kdc15} "
          f"H={dhalo_cn.H}: 64 steps in {dhc_seconds:.4f} s (median of "
          f"{fmt_windows(dhc_windows)}) = {ups_cn / dhc_seconds:.6g} "
          f"updates/s; DFCudaEngine K={Kpc8}: 64 steps in "
          f"{dpc_seconds:.4f} s (median of {fmt_windows(dpc_windows)}) = "
          f"{ups_cn / dpc_seconds:.6g} updates/s (B7 on the row walk: "
          f"{B5_B7_WALK['df gray_s8 CN DFCudaEngine']:.6g}); halo/plain at CN "
          f"{dpc_seconds / dhc_seconds:.3f}x (B15's main launch on the row "
          f"walk: {B4_B15_WALK['df_halo_multistep_launch ms']} ms); "
          f"DFHaloCudaEngine vs DFCudaEngine bit-equal at every gray_s8 "
          f"kind: {all_equal}; card: {card}", flush=True)
    phase_seconds(8)

    # -- 9. the adjoint path -------------------------------------------------
    def adj_coefs(eng):
        z = torch.zeros((2, eng.Bh, cs._NCOEF), device=dev)
        return [eng.coef.get(k, z) for k in (BE, CN, BDF)]

    def adj_err(got, ref):
        """Normalised error of a B10 output tuple, the packs scaled to the
        planes' bar (planes and cbc TOL, packs ADJ_PACK_TOL)."""
        errs = [nerr(g, r) if float(r.abs().max()) > 0 else
                float(g.abs().max()) for g, r in zip(got, ref)]
        return max(max(errs[:3]), max(errs[3:]) * TOL / ADJ_PACK_TOL)

    def linear_coefs(co):
        """The packs with Sb = c0 = 0: with bc = 0 a step (or K steps) is
        then a linear map A of its input state."""
        col = [c.clone() for c in co]
        for c in col:
            c[..., cs._SB] = 0.0
            c[..., cs._C0] = 0.0
        return col

    def transposition(label, d, Ad, Atc, readings):
        """<c, A d> = <A^T c, d> with c = A d, which makes the left side
        |A d|^2, free of cancellation; within 1e-5."""
        lhs = sum(float((a.double() ** 2).sum()) for a in Ad)
        rhs = sum(float((c.double() * x.double()).sum())
                  for c, x in zip(Atc, d))
        rel = abs(lhs - rhs) / abs(lhs)
        readings.append(f"{label}={rel:.1e}")
        if not rel <= 1e-5:
            raise AssertionError(f"transposition {label}: <c, A d> = {lhs} "
                                 f"against <A^T c, d> = {rhs} ({rel:.3e})")

    def b9_vs_b1(label, e, co, geo, e0, e1, fk, fr, readings):
        """B9's step against B1's (B2's for BE/CN) at K = 1: the same
        tiles' arithmetic, the carries composed across tiles in another
        order (B9's look-back), so rounding apart. Held to 1e-6 where that
        holds, else as check_f64 holds a kernel (B9 against the plain
        version evaluated in float64, within the float32 plain version's
        distance plus TOL)."""
        one = e.multi_step(FlatState(e0, e1, e0, e1, e0, e1), 1)
        ref1 = ((one.e0, one.e1, one.h0, one.h1) if e.cfg.ts_method == 3
                else (one.e0, one.e1))
        err1 = max(nerr(g, r) for g, r in zip(fk, ref1))
        same = all(torch.equal(g, r) for g, r in zip(fk, ref1))
        if err1 <= 1e-6:
            readings.append(f"{label}={err1:.1e}"
                            f"{' bit-equal' if same else ''}")
            return
        fr64 = ca.fwd_record_launch_ref(*f64(co), e.bc.double(), e.flip,
                                        *f64((e0, e1)), **geo)
        err_k = max(nerr(g, r) for g, r in zip(fk[:4], fr64[:4]))
        err_p = max(nerr(g, r) for g, r in zip(fr[:4], fr64[:4]))
        readings.append(f"{label}={err1:.1e} (above 1e-6; vs float64: B9 "
                        f"{err_k:.1e}, plain {err_p:.1e})")
        if not err_k <= err_p + TOL:
            raise AssertionError(f"B9 {label} against B1/B2 at K = 1: "
                                 f"{err1:.3e} > 1e-6, and from the float64 "
                                 f"plain version {err_k:.3e} > {err_p:.3e} "
                                 f"+ {TOL}")

    def b9_records(fr, N, blk):
        """The plain version's records (per block of blk cells) at the
        kernel's record tiles (record_tiles(N), 4096 cells when several),
        or None where a record tile does not start on a plain block."""
        nt = ca.record_tiles(N)
        if nt > 1 and 4096 % blk:
            return None
        return [r[..., [t * 4096 // blk for t in range(nt)]] for r in fr]

    n_checks = len(checks)
    adj_cases = [(3, True, False, 12800), (3, False, True, 12800),
                 (3, False, False, 12800), (3, True, True, 100),
                 (1, True, False, 12800), (1, False, False, 5000),
                 (2, False, False, 12800), (2, True, False, 12800)]
    b1_parity, b10_transposed = [], []
    for ts_method, refl, sym, Nx in adj_cases:
        # M = 8 x G = 4 (Bh = 16); N = 12800 is 3 full 4096-cell record
        # tiles and a ragged 512 (25 B9 look-back tiles of 512), 13 B10
        # sub-tiles of 1024 (plain versions: 25 blocks of 512); N = 5000
        # and 100 end mid-tile.
        e = engine(load_config(deck, M=8, G=4, N=Nx, ts_method=ts_method,
                               bc_left_indicator=2 if refl else 1,
                               bdf2_symmetric_half=sym))
        geo, co = ca.step_geometry(e), adj_coefs(e)
        kname = {1: "BE", 2: "CN", 3: "BDF2"}[ts_method]
        label = (f"{kname}-{'refl' if refl else 'src'}-"
                 f"{'sym' if sym else 'asym'}-N{Nx}")
        g9 = torch.Generator(device=dev).manual_seed(
            200 + 10 * ts_method + Nx)
        base = e.init_state().e0
        e0, e1 = [(base * (0.5 + torch.rand(base.shape, generator=g9,
                                            device=dev))).contiguous()
                  for _ in range(2)]
        fk = ca.fwd_record_launch(*co, e.bc, e.flip, e0, e1, **geo)
        fr = ca.fwd_record_launch_ref(*co, e.bc, e.flip, e0, e1, **geo)
        check("fwd_record_launch", f"B9-{label}", fk[:4], fr[:4])
        b9_vs_b1(label, e, co, geo, e0, e1, fk, fr, b1_parity)
        cots = [(torch.rand(base.shape, generator=g9, device=dev) - 0.5)
                .contiguous() for _ in range(4)]
        if ts_method != 3:
            cots[2] = cots[3] = torch.zeros_like(cots[0])
        bk = ca.bwd_launch(*co, e.flip, e0, e1, *cots, *fk[4:], **geo)
        br = ca.bwd_launch_ref(*co, e.flip, e0, e1, *cots, *fr[4:], **geo)
        err = adj_err(bk, br)
        checks.append(f"B10-{label}={err:.1e}")
        if not err <= TOL:
            raise AssertionError(f"bwd_launch B10-{label}: normalised error "
                                 f"{err:.3e} > {TOL} (packs {ADJ_PACK_TOL})")
        col = linear_coefs(co)
        d = [(torch.rand(base.shape, generator=g9, device=dev) - 0.5)
             .contiguous() for _ in range(2)]
        out = ca.fwd_record_launch(*col, torch.zeros_like(e.bc), e.flip, *d,
                                   **geo)
        Ad = list(out[:4]) if ts_method == 3 else [
            out[0], out[1], torch.zeros_like(d[0]), torch.zeros_like(d[0])]
        tb = ca.bwd_launch(*col, e.flip, *d, *Ad, *out[4:], **geo)
        transposition(label, d, Ad, tb[:2], b10_transposed)
    adj_checks = checks[n_checks:]

    def bwd_wave_check(tag, e, K, readings):
        """B10 (K None) or B12 (K steps) on engine e's shape, launched
        REPEAT times against one plain launch, the largest error held (a
        race between the cluster's blocks shows intermittently), and the
        REPEAT launches bit-identical, packs included (the cluster adds its
        blocks' partials in rank order). Held as check_f64 holds phase 3's
        wavefront shapes: over 16 steps of a 52736-cell row the float32
        plain version itself lies above TOL from its float64 evaluation,
        so the kernel and the plain version are both measured against the
        plain version evaluated in float64 on the same inputs (records from
        the float64 forward) and the kernel held to the float32 plain
        version's distance plus TOL (packs ADJ_PACK_TOL), which is TOL
        against the plain version wherever that one is accurate."""
        geo, co = ca.step_geometry(e), adj_coefs(e)
        base = e.init_state().e0
        Nx, ts = base.shape[-1], e.cfg.ts_method
        g = torch.Generator(device=dev).manual_seed(400 + len(readings))

        def rnd(centred=False):
            r = torch.rand(base.shape, generator=g, device=dev)
            return (r - 0.5 if centred else base * (0.5 + r)).contiguous()

        e0, e1 = rnd(), rnd()
        _, C, subs = ca.bwd_geometry(Nx, K or 1, e.Bh if e.reflective
                                     else 2 * e.Bh, 4 if ts == 3 else 1)
        if K is None:
            name = "bwd_launch"
            fk = ca.fwd_record_launch(*co, e.bc, e.flip, e0, e1, **geo)
            fr = ca.fwd_record_launch_ref(*co, e.bc, e.flip, e0, e1, **geo)
            cots = [rnd(centred=True) for _ in range(4)]
            if ts != 3:
                cots[2] = cots[3] = torch.zeros_like(cots[0])
            outs = [ca.bwd_launch(*co, e.flip, e0, e1, *cots, *fk[4:], **geo)
                    for _ in range(REPEAT)]
            ref = ca.bwd_launch_ref(*co, e.flip, e0, e1, *cots, *fr[4:],
                                    **geo)
            fr64 = ca.fwd_record_launch_ref(*f64(co), e.bc.double(), e.flip,
                                            *f64((e0, e1)), **geo)
            ref64 = ca.bwd_launch_ref(*f64(co), e.flip, *f64((e0, e1)),
                                      *f64(cots), *fr64[4:], **geo)
        else:
            name = "bwd_k_launch"
            fk = ca.fwd_record_k_launch(*co, e.bc, e.flip, e0, e1, K=K,
                                        **geo)
            fr = ca.fwd_record_k_launch_ref(*co, e.bc, e.flip, e0, e1, K=K,
                                            **geo)
            cots = [rnd(centred=True) for _ in range(6)]
            outs = [ca.bwd_k_launch(*co, e.flip, e0, e1, *fk[9:], *cots,
                                    *fk[6:9], K=K, **geo)
                    for _ in range(REPEAT)]
            ref = ca.bwd_k_launch_ref(*co, e.flip, e0, e1, *fr[9:], *cots,
                                      *fr[6:9], K=K, **geo)
            fr64 = ca.fwd_record_k_launch_ref(*f64(co), e.bc.double(),
                                              e.flip, *f64((e0, e1)), K=K,
                                              **geo)
            ref64 = ca.bwd_k_launch_ref(*f64(co), e.flip, *f64((e0, e1)),
                                        *fr64[9:], *f64(cots), *fr64[6:9],
                                        K=K, **geo)
        err_k = max(adj_err(o, ref64) for o in outs)
        err_p = adj_err(ref, ref64)
        err_kp = max(adj_err(o, ref) for o in outs)
        label = f"{tag}-N{Nx}-Bh{e.Bh}-C{C}G{subs}"
        readings.append(f"{label}={err_kp:.1e} (vs float64: kernel "
                        f"{err_k:.1e}, plain {err_p:.1e})")
        if not err_k <= err_p + TOL:
            raise AssertionError(f"{name} {label}: normalised error from "
                                 f"the float64 plain version {err_k:.3e} > "
                                 f"the float32 plain version's {err_p:.3e} "
                                 f"+ {TOL} (packs {ADJ_PACK_TOL}; worst of "
                                 f"{REPEAT} launches)")
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"{name} {label}: {REPEAT} launches on the "
                                 f"same inputs are not bit-identical")
        return C

    def wave_engine(ts_method, refl, sym, Nx, Mx=8):
        """The mg deck at G = 4 and M = Mx (Bh = 16 at M = 8, 4 at 2)."""
        return engine(load_config(deck, M=Mx, G=4, N=Nx, ts_method=ts_method,
                                  bc_left_indicator=2 if refl else 1,
                                  bdf2_symmetric_half=sym))

    def c_plus_one(K, spp, refl):
        """N of C + 1 whole 1024-cell sub-tiles at Bh = 16: C the blocks a
        row the geometry picks for the launch's rows on long rows."""
        return (ca.bwd_geometry(1 << 20, K, 16 if refl else 32, spp)[1]
                + 1) * 1024

    # B10's wavefront on its own shapes: one record tile of 3 sub-tiles
    # (fewer than the 4 blocks a row BDF2 allows); C + 1 sub-tiles; 51
    # whole sub-tiles and a ragged 512-cell one (N = 52736); BE and CN (one
    # slot: C = 1, the block mails itself); both boundaries, both half
    # modes.
    b10_wave = []
    for ts_method, refl, sym, Nx, what in (
            (3, True, False, 300, "one-record-tile"),
            (3, False, True, c_plus_one(1, 4, False), "C+1"),
            (3, True, True, c_plus_one(1, 4, True), "C+1"),
            (3, True, True, 52736, "ragged"),
            (3, False, False, 52736, "ragged"),
            (1, True, False, 52736, "ragged"),
            (2, False, False, 5120, "five-sub-tiles")):
        kname = {1: "BE", 2: "CN", 3: "BDF2"}[ts_method]
        bwd_wave_check(f"B10-{kname}-{what}-{'refl' if refl else 'src'}-"
                       f"{'sym' if sym else 'asym'}",
                       wave_engine(ts_method, refl, sym, Nx), None, b10_wave)

    # B9's look-back on its own shapes, each launched REPEAT times against
    # one plain launch, the worst held by check_f64 (the planes and the
    # records at the kernel's record tiles; the look-back composes the
    # tiles' maps in an order that depends on timing, so launches need not
    # agree to the bit), and B10 run from the worst launch's records against
    # B10's plain version from the plain records, held as bwd_wave_check
    # holds B10. b9_tile is the look-back tile at long rows: a row below one
    # tile (N = 100), one tile, T = 2, a ragged last tile (N = 52736), 2^18
    # cells (T above 32: a look-back crosses more than one warp's window of
    # predecessors), Bh = 1; both boundaries, both half modes.
    b9_tile = ca.fwd_geometry(1 << 17)[0] * 8
    b9_lb = []
    for ts_method, refl, sym, Nx, Mx, Gx, what in (
            (3, True, False, 100, 8, 4, "below-one-tile"),
            (3, False, True, b9_tile, 8, 4, "one-tile"),
            (3, True, True, 2 * b9_tile, 8, 4, "T2"),
            (3, False, False, 52736, 8, 4, "ragged"),
            (3, True, False, 1 << 18, 2, 4, "T>32"),
            (3, True, True, 52736, 2, 1, "Bh1"),
            (1, True, False, 52736, 8, 4, "ragged"),
            (1, False, False, 2 * b9_tile, 2, 1, "Bh1-T2"),
            (2, False, False, 1 << 18, 2, 4, "T>32"),
            (2, True, False, 100, 8, 4, "below-one-tile"),
            (2, True, False, b9_tile, 2, 1, "Bh1-one-tile")):
        # Plain blocks that start every record tile: its records are held.
        blk9 = 4096 if Nx % 4096 == 0 else 512 if Nx % 512 == 0 else None
        e = engine(load_config(deck, M=Mx, G=Gx, N=Nx, ts_method=ts_method,
                               bc_left_indicator=2 if refl else 1,
                               bdf2_symmetric_half=sym), block=blk9)
        geo, co = ca.step_geometry(e), adj_coefs(e)
        g9 = torch.Generator(device=dev).manual_seed(500 + len(b9_lb))
        base = e.init_state().e0

        def rnd9(centred=False):
            r = torch.rand(base.shape, generator=g9, device=dev)
            return (r - 0.5 if centred else base * (0.5 + r)).contiguous()

        e0, e1 = rnd9(), rnd9()
        outs = [ca.fwd_record_launch(*co, e.bc, e.flip, e0, e1, **geo)
                for _ in range(REPEAT)]
        fr = ca.fwd_record_launch_ref(*co, e.bc, e.flip, e0, e1, **geo)
        fr64 = ca.fwd_record_launch_ref(*f64(co), e.bc.double(), e.flip,
                                        *f64((e0, e1)), **geo)
        recs = b9_records(fr[4:], Nx, geo["blk"])
        recs64 = b9_records(fr64[4:], Nx, geo["blk"])
        ref, ref64 = list(fr[:4]), list(fr64[:4])
        if recs is not None:
            ref, ref64 = ref + recs, ref64 + recs64

        def held9(o):
            return list(o[:4]) + (list(o[4:]) if recs is not None else [])

        worst = max(outs, key=lambda o: max(
            nerr(g, r) for g, r in zip(held9(o), ref64)))
        threads, T9, _ = ca.fwd_geometry(Nx)
        kname = {1: "BE", 2: "CN", 3: "BDF2"}[ts_method]
        label = (f"B9-{kname}-{what}-{'refl' if refl else 'src'}-"
                 f"{'sym' if sym else 'asym'}-N{Nx}-Bh{e.Bh}-T{T9}")
        n_before = len(checks)
        check_f64("fwd_record_launch", label, held9(worst), ref, ref64)
        reading = checks.pop(n_before)
        cots = [rnd9(centred=True) for _ in range(4)]
        if ts_method != 3:
            cots[2] = cots[3] = torch.zeros_like(cots[0])
        bk = ca.bwd_launch(*co, e.flip, e0, e1, *cots, *worst[4:], **geo)
        br = ca.bwd_launch_ref(*co, e.flip, e0, e1, *cots, *fr[4:], **geo)
        br64 = ca.bwd_launch_ref(*f64(co), e.flip, *f64((e0, e1)),
                                 *f64(cots), *fr64[4:], **geo)
        err_k, err_p = adj_err(bk, br64), adj_err(br, br64)
        b9_lb.append(f"{reading}{'' if recs is not None else ' (records '
                                 'not on plain blocks)'}, B10 from its "
                     f"records {adj_err(bk, br):.1e} (vs float64: "
                     f"{err_k:.1e}, plain {err_p:.1e})")
        if not err_k <= err_p + TOL:
            raise AssertionError(f"bwd_launch from {label}'s records: "
                                 f"normalised error from the float64 plain "
                                 f"version {err_k:.3e} > the float32 plain "
                                 f"version's {err_p:.3e} + {TOL} (packs "
                                 f"{ADJ_PACK_TOL})")

    # make_diff_solve_cuda on the card against the same call on the CPU.
    def gray_src(Mx, Nx, steps, refl=False, src=2.0):
        """The gray workload off equilibrium (an O(1) kappa sensitivity)."""
        cfg = gray_cfg(Mx, Nx, 3, steps)
        return cfg.replace(bc_left_indicator=2 if refl else 1,
                           psi_source=tuple((src,) for _ in range(Mx)))

    small = gray_src(4, 4096, 8)
    small_tab, _, _ = transport.build_tables(small)

    def card_vs_cpu(steps_per_launch):
        """make_diff_solve_cuda on the card against the same call on the
        CPU (gray off-equilibrium, M = 4, N = 4096, 8 steps): errors of the
        value, the kappa and the psi_source gradients, held to 1e-5, 2e-3
        and 1e-4."""
        grads = {}
        for where in ("cuda", "cpu"):
            sf = ca.make_diff_solve_cuda(small, small_tab, num_steps=8,
                                         steps_per_launch=steps_per_launch,
                                         device=where)
            prm = {"kappa": torch.ones(1, dtype=torch.float64,
                                       requires_grad=True),
                   "psi_source": torch.full((4, 1), 2.0, dtype=torch.float64,
                                            requires_grad=True)}
            val = torch.sum(sf(prm).ends ** 2) * 1e-3
            val.backward()
            grads[where] = (float(val.detach()), prm["kappa"].grad,
                            prm["psi_source"].grad)
        errs = (abs(grads["cuda"][0] - grads["cpu"][0])
                / abs(grads["cpu"][0]),
                nerr(grads["cuda"][1], grads["cpu"][1]),
                nerr(grads["cuda"][2], grads["cpu"][2]))
        if not (errs[0] <= 1e-5 and errs[1] <= 2e-3 and errs[2] <= 1e-4):
            raise AssertionError(
                f"make_diff_solve_cuda steps_per_launch={steps_per_launch} "
                f"card vs CPU: value {errs[0]:.3e}, kappa {errs[1]:.3e}, "
                f"psi_source {errs[2]:.3e}")
        return errs

    v_err, k_err, s_err = card_vs_cpu(1)

    # The path at benchmarks/adjoint_bench.py's chip shape.
    Ma, Na, na = 32, 1 << 17, 96
    acfg = gray_cfg(Ma, Na, 3, na)
    atab, _, _ = transport.build_tables(acfg)
    fwd_eng = cs.CudaSweepEngine(acfg, atab, device=dev)
    Ka = fwd_eng.max_steps_per_launch()
    ca.reset_launch_counts()
    sfa = ca.make_diff_solve_cuda(acfg, atab, num_steps=na,
                                  steps_per_launch=1, device=dev)
    kap = torch.ones(1, dtype=torch.float64, requires_grad=True)

    def grad_step(solve):
        kap.grad = None
        val = torch.sum(solve({"kappa": kap}).ends ** 2) * 1e-3
        val.backward()
        return val.detach(), kap.grad

    def cuda_windows(fn, n=3):
        """fn once to warm up, then n CUDA-event windows of one call each:
        (median seconds, windows, the last result)."""
        out = fn()
        torch.cuda.synchronize()
        wins = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            wins.append(a.elapsed_time(b) / 1e3)
        return sorted(wins)[n // 2], wins, out

    peak = peak_from()
    g_seconds, g_windows, (gval, ggrad) = cuda_windows(
        lambda: grad_step(sfa))
    g_peak = peak()
    if not (np.isfinite(float(gval)) and np.isfinite(float(ggrad[0]))):
        raise AssertionError(f"adjoint grad step not finite: {gval}, {ggrad}")
    launches.update(read_counts(PATH_ADJ, "the adjoint path (phase 9)"))

    peak = peak_from()
    f_seconds, f_windows, _ = cuda_windows(
        lambda: fwd_eng.solve(fwd_eng.init_state(), num_steps=na,
                              steps_per_launch=Ka))
    f_peak = peak()
    # B10's launch shape at the bench: a cluster of C > 1 blocks a row; B9's
    # there: more than one tile (one block each) a row.
    b10_geo = ca.bwd_geometry(Na, 1, fwd_eng.Bh, 4)
    if b10_geo[1] < 2:
        raise AssertionError(f"B10 at the adjoint bench: {b10_geo[1]} block "
                             f"a row")
    b9_geo = ca.fwd_geometry(Na)
    if b9_geo[1] < 2:
        raise AssertionError(f"B9 at the adjoint bench: {b9_geo[1]} tile a "
                             f"row")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase 9 adjoint path: ok; kernel parity max normalised error "
          + ", ".join(adj_checks) + "; B10 wavefront shapes (worst of "
          f"{REPEAT} launches, bit-identical): " + ", ".join(b10_wave)
          + "; B9 vs B1/B2 at K = 1: "
          + ", ".join(b1_parity) + f"; B9 look-back shapes (worst of "
          f"{REPEAT} launches): " + ", ".join(b9_lb)
          + "; transposition <c,A d> vs <B10 c,d>: "
          + ", ".join(b10_transposed) + f"; make_diff_solve_cuda card vs CPU "
          f"(gray M=4 N=4096 8 steps): value {v_err:.1e}, kappa {k_err:.1e}, "
          f"psi_source {s_err:.1e}; adjoint bench (gray S_32, N=2^17, BDF2, "
          f"{na} steps): value_and_grad at K = 1 in {g_seconds:.4f} s (median "
          f"of {fmt_windows(g_windows)}), peak device memory {g_peak:.3f} GiB "
          f"above its start; forward on CudaSweepEngine K={Ka} in "
          f"{f_seconds:.4f} s (median of {fmt_windows(f_windows)}), peak "
          f"{f_peak:.3f} GiB; grad/forward {g_seconds / f_seconds:.3f} (row "
          f"walk: {WALK_GRAD_RATIOS['grad_k1_vs_fwd']}); B10 grid: "
          f"{fwd_eng.Bh} rows x {b10_geo[1]} blocks of {b10_geo[0]} threads "
          f"a launch, {b10_geo[2]} sub-tiles a row; B9 grid: "
          f"{2 * fwd_eng.Bh} rows x {b9_geo[1]} tiles of {b9_geo[0] * 8} "
          f"cells, one block of {b9_geo[0]} threads a tile, "
          f"{2 * fwd_eng.Bh * b9_geo[1]} blocks in one launch, at most "
          f"{b9_geo[2]} x {n_sm} in flight; card: {card}",
          flush=True)
    phase_seconds(9)

    # -- 10. the K-fused adjoint ---------------------------------------------
    # B11/B12 against their plain versions, B11 against B1 at the same K and
    # its records and intermediate inputs against K chained B9 launches (the
    # first bit for bit: B11 runs B1's wavefront; the second within phase
    # 9's bars: B9 composes the same tiles' carries by its look-back), and
    # the transposition check of the pair. M = 8 x G = 4 (Bh = 16); N =
    # 52736 is 13 B11 tiles (the last ragged, 3584 cells) and 52 B12
    # sub-tiles (plain versions: 103 blocks of 512); N = 12800 4 tiles and 13
    # sub-tiles (plain: 25 blocks); N = 5000 and 100 end mid-tile.
    n_checks = len(checks)
    kf_cases = [(True, False, 3, 52736), (False, True, 2, 12800),
                (True, True, 4, 12800), (False, False, 4, 5000),
                (True, False, 2, 100)]
    b1k_parity, b9k_records, k_transposition = [], [], []

    def b11_bits(label, e, co, geo, e0, e1, Kk, fk, refs=None):
        """Holds B11's outputs fk: its six planes bit-equal to B1's at the
        same K; its records and intermediate inputs against K chained B9
        launches, within TOL (B9's look-back composes its tiles' carries in
        another order than B11's wavefront: rounding apart), or, with
        `refs` (the plain K-step version in float32 and float64) on long
        rows, both as check_f64 holds a kernel: the records at the kernel's
        record tiles."""
        one = e.multi_step(FlatState(e0, e1, e0, e1, e0, e1), Kk)
        if not all(torch.equal(g, r) for g, r in zip(
                fk[:6], (one.e0, one.e1, one.h0, one.h1, one.p0, one.p1))):
            raise AssertionError(f"B11 {label}: not bit-equal to B1 at "
                                 f"K = {Kk}")
        b1k_parity.append(f"{label} bit-equal")
        ins, recs = [(e0, e1)], []
        for _ in range(Kk):
            o = ca.fwd_record_launch(*co, e.bc, e.flip, *ins[-1], **geo)
            recs.append(o[4:])
            ins.append(o[:2])
        chained = (torch.cat([r[0] for r in recs], 1),
                   torch.stack([r[1] for r in recs], 1),
                   torch.stack([r[2] for r in recs], 1),
                   *(torch.stack([x[i] for x in ins[1:Kk]]) for i in (0, 1)))
        err = max(nerr(a, b) for a, b in zip(fk[6:], chained))
        if refs is None:
            b9k_records.append(f"{label}={err:.1e}")
            if not err <= TOL:
                raise AssertionError(f"B11 {label}: records and intermediate "
                                     f"inputs {err:.3e} from {Kk} chained B9 "
                                     f"launches > {TOL}")
            return
        Nx = e0.shape[-1]
        tiled = [b9_records(r[6:9], Nx, geo["blk"]) for r in refs]
        first = 0 if tiled[0] is not None else 3    # records comparable?
        ref, ref64 = ([*(t or [])] + list(r[9:]) for t, r in zip(tiled,
                                                                 refs))
        err_p = max(nerr(a, b) for a, b in zip(ref, ref64))
        err_k = max(nerr(a, b) for x in (fk[6 + first:], chained[first:])
                    for a, b in zip(x, ref64))
        b9k_records.append(f"{label}={err:.1e} (vs float64: B11 and chained "
                           f"B9 {err_k:.1e}, plain {err_p:.1e})")
        if not err_k <= err_p + TOL:
            raise AssertionError(f"B11 {label}: records and intermediate "
                                 f"inputs, B11's or {Kk} chained B9 "
                                 f"launches', {err_k:.3e} from the float64 "
                                 f"plain version > the float32 plain "
                                 f"version's {err_p:.3e} + {TOL}")

    for refl, sym, Kk, Nx in kf_cases:
        e = engine(load_config(deck, M=8, G=4, N=Nx, ts_method=3,
                               bc_left_indicator=2 if refl else 1,
                               bdf2_symmetric_half=sym))
        geo, co = ca.step_geometry(e), adj_coefs(e)
        label = (f"K{Kk}-{'refl' if refl else 'src'}-"
                 f"{'sym' if sym else 'asym'}-N{Nx}")
        g10 = torch.Generator(device=dev).manual_seed(300 + 10 * Kk + Nx)
        base = e.init_state().e0

        def rnd(centred=False):
            r = torch.rand(base.shape, generator=g10, device=dev)
            return (r - 0.5 if centred else base * (0.5 + r)).contiguous()

        e0, e1 = rnd(), rnd()
        fk = ca.fwd_record_k_launch(*co, e.bc, e.flip, e0, e1, K=Kk, **geo)
        fr = ca.fwd_record_k_launch_ref(*co, e.bc, e.flip, e0, e1, K=Kk,
                                        **geo)
        check("fwd_record_k_launch", f"B11-{label}", fk[:6] + fk[9:],
              fr[:6] + fr[9:])
        b11_bits(label, e, co, geo, e0, e1, Kk, fk)
        cots = [rnd(centred=True) for _ in range(6)]
        bk = ca.bwd_k_launch(*co, e.flip, e0, e1, *fk[9:], *cots, *fk[6:9],
                             K=Kk, **geo)
        br = ca.bwd_k_launch_ref(*co, e.flip, e0, e1, *fr[9:], *cots,
                                 *fr[6:9], K=Kk, **geo)
        err = adj_err(bk, br)
        checks.append(f"B12-{label}={err:.1e}")
        if not err <= TOL:
            raise AssertionError(f"bwd_k_launch B12-{label}: normalised "
                                 f"error {err:.3e} > {TOL} (packs "
                                 f"{ADJ_PACK_TOL})")
        # The K-step launch maps the input state to its six output planes.
        col = linear_coefs(co)
        d = [rnd(centred=True) for _ in range(2)]
        out = ca.fwd_record_k_launch(*col, torch.zeros_like(e.bc), e.flip, *d,
                                     K=Kk, **geo)
        tb = ca.bwd_k_launch(*col, e.flip, *d, *out[9:], *out[:6], *out[6:9],
                             K=Kk, **geo)
        transposition(label, d, out[:6], tb[:2], k_transposition)
    kf_checks = checks[n_checks:]

    # B11's wavefront on its own shapes, each launched REPEAT times: the
    # launches bit-identical, the worst held as check_f64 holds phase 3's
    # wavefront shapes (over 16 steps of a 52736-cell row the float32 plain
    # version itself lies near TOL from its float64 evaluation), and each
    # held bit for bit against B1 and K chained B9 launches. T = C + 1
    # record tiles at K = 2 and 4 (C the blocks a row fwd_k_geometry picks
    # for the launch's rows on long rows); 12 whole tiles and a ragged 3584
    # (N = 52736) at K = 3; a row below one tile (N = 1000, 128 threads)
    # at K = 2; K = 16 on Bh = 4 rows, where C reaches its cap; both
    # boundaries, both half modes.
    b11_wave, b11_c16 = [], None
    for Kk, refl, sym, Nx, Mx, what in (
            (2, True, False, (ca.fwd_k_geometry(1 << 20, 2, 16)[1] + 1)
             * 4096, 8, "C+1"),
            (4, False, True, (ca.fwd_k_geometry(1 << 20, 4, 32)[1] + 1)
             * 4096, 8, "C+1"),
            (3, True, True, 52736, 8, "ragged"),
            (2, False, False, 1000, 8, "below-one-tile"),
            (16, True, False, 52736, 2, "ragged")):
        e = wave_engine(3, refl, sym, Nx, Mx)
        geo, co = ca.step_geometry(e), adj_coefs(e)
        base = e.init_state().e0
        g11 = torch.Generator(device=dev).manual_seed(600 + len(b11_wave))
        e0, e1 = [(base * (0.5 + torch.rand(base.shape, generator=g11,
                                            device=dev))).contiguous()
                  for _ in range(2)]
        _, C, T = ca.fwd_k_geometry(Nx, Kk, e.Bh if refl else 2 * e.Bh)
        label = (f"K{Kk}-{what}-{'refl' if refl else 'src'}-"
                 f"{'sym' if sym else 'asym'}-N{Nx}-Bh{e.Bh}-C{C}T{T}")
        outs = [ca.fwd_record_k_launch(*co, e.bc, e.flip, e0, e1, K=Kk,
                                       **geo) for _ in range(REPEAT)]
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(o, outs[0])):
            raise AssertionError(f"fwd_record_k_launch B11-{label}: "
                                 f"{REPEAT} launches on the same inputs are "
                                 f"not bit-identical")
        ref = ca.fwd_record_k_launch_ref(*co, e.bc, e.flip, e0, e1, K=Kk,
                                         **geo)
        ref64 = ca.fwd_record_k_launch_ref(*f64(co), e.bc.double(), e.flip,
                                           *f64((e0, e1)), K=Kk, **geo)
        n_before = len(checks)
        check_f64("fwd_record_k_launch", f"B11-wave-{label}",
                  outs[0][:6] + outs[0][9:], ref[:6] + ref[9:],
                  ref64[:6] + ref64[9:])
        b11_wave.append(checks.pop(n_before))
        b11_bits(f"wave-{label}", e, co, geo, e0, e1, Kk, outs[0],
                 (ref, ref64))
        if Kk == 16:
            b11_c16 = C

    # B12's wavefront on its own shapes: one record tile of 4 sub-tiles
    # (fewer than the 16 blocks a row K = 4 allows); C + 1 sub-tiles at K =
    # 1 and 2; N = 52736 (a ragged last sub-tile) at K = 3 and 4; and at K
    # = 16 on Bh = 4 rows, where C reaches its cap; both boundaries, both
    # half modes.
    b12_wave, b12_c16 = [], None
    for Kk, refl, sym, Nx, Mx, what in (
            (4, True, False, 3000, 8, "one-record-tile"),
            (1, False, True, c_plus_one(1, 4, False), 8, "C+1"),
            (2, True, True, c_plus_one(2, 4, True), 8, "C+1"),
            (3, False, False, 52736, 8, "ragged"),
            (4, True, False, 52736, 8, "ragged"),
            (16, True, True, 52736, 2, "ragged")):
        C = bwd_wave_check(f"B12-K{Kk}-{what}-{'refl' if refl else 'src'}-"
                           f"{'sym' if sym else 'asym'}",
                           wave_engine(3, refl, sym, Nx, Mx), Kk, b12_wave)
        if Kk == 16:
            b12_c16 = C

    # K-fused against K = 1 gradients on the card (JAX's
    # test_kfused_gradients_match_k1 at N = 4096: 9 = 2 x 4 + 1 steps,
    # reflective, correction physics, a half-ends term), and remat groups of
    # K-step launches (JAX's test_kfused_remat_group: 17 steps, groups of 2
    # launches) against none; both within 1e-4.
    kcfg = load_config(gray_deck, M=4, N=4096, X=40.96, max_timesteps=9,
                       bc_left_indicator=2, psi_source=((1.0,),) * 4, V=1.0,
                       use_correction=True)
    ktab, _, _ = transport.build_tables(kcfg)

    def kgrad(cfg_, tab_, steps, params, loss, **kw):
        sf = ca.make_diff_solve_cuda(cfg_, tab_, num_steps=steps, device=dev,
                                     **kw)
        tp = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
              for k, v in params.items()}
        loss(sf(tp)).backward()
        return {k: v.grad for k, v in tp.items()}

    kparams = {"T": np.asarray(1.0),
               "psi_source": np.asarray(kcfg.psi_source, np.float64)}

    def kloss(s):
        return torch.sum(s.ends ** 2) + torch.sum(s.half_ends)

    g_k1 = kgrad(kcfg, ktab, 9, kparams, kloss, steps_per_launch=1)
    g_k4 = kgrad(kcfg, ktab, 9, kparams, kloss, steps_per_launch=4)
    kvk1 = max(nerr(g_k4[k], g_k1[k]) for k in kparams)
    rcfg = gray_src(4, 4096, 17)
    rtab, _, _ = transport.build_tables(rcfg)

    def rloss(s):
        return torch.sum(s.ends ** 2)

    g_plain = kgrad(rcfg, rtab, 17, {"kappa": np.ones(1)}, rloss,
                    steps_per_launch=4)["kappa"]
    g_remat = kgrad(rcfg, rtab, 17, {"kappa": np.ones(1)}, rloss,
                    steps_per_launch=4, remat_group=2)["kappa"]
    remat_err = nerr(g_remat, g_plain)
    if not (kvk1 <= 1e-4 and remat_err <= 1e-4):
        raise AssertionError(f"K-fused vs K = 1 gradients {kvk1:.3e}, remat "
                             f"vs none {remat_err:.3e} (bar 1e-4)")
    kv_err, kk_err, ks_err = card_vs_cpu(None)

    # The adjoint bench again, in one call: the forward, value_and_grad at
    # K = 1 and at the K-fused default (K = 4: 24 B11 and 24 B12 launches).
    sfk = ca.make_diff_solve_cuda(acfg, atab, num_steps=na, device=dev)
    f2_seconds, _, _ = cuda_windows(
        lambda: fwd_eng.solve(fwd_eng.init_state(), num_steps=na,
                              steps_per_launch=Ka))
    g1_seconds, _, _ = cuda_windows(lambda: grad_step(sfa))
    ca.reset_launch_counts()
    peak = peak_from()
    gk_seconds, gk_windows, (kval, kgr) = cuda_windows(
        lambda: grad_step(sfk))
    gk_peak = peak()
    if not (np.isfinite(float(kval)) and np.isfinite(float(kgr[0]))):
        raise AssertionError(f"K-fused grad step not finite: {kval}, {kgr}")

    # 3 fit_params iterations at the bench shape, on the K-fused default:
    # recover the boundary source
    # (2, off equilibrium) from a start 20% above it, on the phi profile of
    # the 96-step solve. In 96 steps light crosses ~38 of the 2^17 cells,
    # so kappa barely moves phi there (its loss would sit at float32
    # roundoff); the source drives the inflow cells. The loss is scaled to
    # 1 at the start.
    fcfg = gray_src(Ma, Na, na, refl=True)
    ftab, _, _ = transport.build_tables(fcfg)
    wt_dev = torch.as_tensor(ftab.wt, device=dev)
    fsolve = ca.make_diff_solve_cuda(fcfg, ftab, device=dev)
    src0 = 1.2 * np.asarray(ftab.psi_source)
    with torch.no_grad():
        phi_t = transport.compute_phi(
            transport.psi_from_ends(fsolve({}).ends), wt_dev)
        phi_0 = transport.compute_phi(transport.psi_from_ends(
            fsolve({"psi_source": src0}).ends), wt_dev)
        loss_0 = torch.mean((phi_0 / phi_t - 1.0) ** 2)

    def fit_loss(final, params):
        phi = transport.compute_phi(transport.psi_from_ends(final.ends),
                                    wt_dev)
        return torch.mean((phi / phi_t - 1.0) ** 2) / loss_0

    fit_p, fit_hist = adj.fit_params(
        fcfg, ftab, None, fit_loss, {"psi_source": src0},
        num_steps=na, learning_rate=0.05, iterations=3, solver="pallas",
        device=dev)
    if not all(np.isfinite(fit_hist)):
        raise AssertionError(f"fit_params losses not finite: {fit_hist}")
    launches.update(read_counts(PATH_ADJ_K, "the K-fused adjoint (phase 10)"))
    # B11's and B12's launch shapes at the bench: clusters of C > 1 blocks a
    # row.
    b11_geo = ca.fwd_k_geometry(Na, Ka, fwd_eng.Bh)
    b12_geo = ca.bwd_geometry(Na, Ka, fwd_eng.Bh, 4)
    for tag, geo_ in (("B11", b11_geo), ("B12", b12_geo)):
        if geo_[1] < 2:
            raise AssertionError(f"{tag} at the adjoint bench: {geo_[1]} "
                                 f"block a row")
    bench = {"fwd_seconds": f2_seconds, "grad_k1_seconds": g1_seconds,
             "grad_kfused_seconds": gk_seconds,
             "grad_k1_vs_fwd": g1_seconds / f2_seconds,
             "grad_kfused_vs_fwd": gk_seconds / f2_seconds,
             "grad_kfused_peak_gib": gk_peak}
    print(f"phase 10 K-fused adjoint: ok; kernel parity max normalised error "
          + ", ".join(kf_checks) + f"; B11 wavefront shapes (worst of "
          f"{REPEAT} launches, bit-identical): " + ", ".join(b11_wave)
          + f" (K = 16: {b11_c16} blocks a row, at most "
          f"{cs.SWEEP_MAX_CLUSTER}); B12 wavefront shapes (worst of "
          f"{REPEAT} launches, bit-identical, packs included): "
          + ", ".join(b12_wave) + f" (K = 16: {b12_c16} blocks a row, at "
          f"most {ca.ADJ_BWD_MAX_CLUSTER}); B11 vs B1 at the same K: "
          + ", ".join(b1k_parity) + "; B11 records vs K chained B9: "
          + ", ".join(b9k_records) + "; transposition <c,A d> vs "
          "<B12 c,d>: " + ", ".join(k_transposition) + f"; K-fused vs K = 1 "
          f"gradients (N=4096, 9 steps, K=4, reflective) {kvk1:.1e}, remat "
          f"vs none (17 steps, groups of 2 launches) {remat_err:.1e}; card vs "
          f"CPU at the K-fused default: value {kv_err:.1e}, kappa "
          f"{kk_err:.1e}, psi_source {ks_err:.1e}; adjoint bench (gray S_32, "
          f"N=2^17, BDF2, {na} steps) " + json.dumps(bench) + " (K-fused "
          f"windows {fmt_windows(gk_windows)}; row walk: "
          + ", ".join(f"{k} {v}" for k, v in WALK_GRAD_RATIOS.items())
          + f"; B11 on the row walk: grad_kfused_vs_fwd "
          f"{B11_B14_WALK['grad_kfused_vs_fwd']}); B11 grid at K = {Ka}: "
          f"{fwd_eng.Bh} rows x {b11_geo[1]} blocks of {b11_geo[0]} threads "
          f"a launch, {b11_geo[2]} tiles a row; B12 grid at K = {Ka}: "
          f"{fwd_eng.Bh} rows x {b12_geo[1]} "
          f"blocks of {b12_geo[0]} threads a launch, {b12_geo[2]} sub-tiles "
          f"a row; fit_params 3 iterations on "
          f"the K-fused default, losses "
          + ", ".join(f"{x:.6g}" for x in fit_hist)
          + f" (x {float(loss_0):.6g}), mu<0 source 2.4 -> "
          f"{float(fit_p['psi_source'][0, 0]):.6g}; card: {card}",
          flush=True)
    phase_seconds(10)


    # -- 11. B8, the per-sub-step mesh engine's kernel --------------------------
    from radiative_transfer_tpu_torch.parallel import mesh as mesh_mod

    mesh1 = mesh_mod.make_mesh_1d(1)

    def mesh_engine(cfg, engine_name, mesh=mesh1, **kw):
        tables, _, _ = transport.build_tables(cfg)
        return make_multichip_engine(cfg, tables, mesh, engine=engine_name,
                                     device=dev, **kw)

    def b8_inputs(eng, kind, seed):
        """Pending corrections (the engine's d0, a, ln_a; inc around the
        row's scale, both signs), halo tails and planes around the initial
        state, packed (rows, N_loc)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = eng.rows
        base = eng.init_state().e0.reshape(rows, -1)
        scale = base[:, :1]
        n_corr, n_halo, n_planes = {BE: (1, 0, 2), CN: (2, 1, 3),
                                    BDF: (3, 2, 6)}[kind]

        def rand(shape):
            return torch.rand(shape, generator=g, device=dev)

        corrs = [torch.cat([scale * (rand((rows, 1)) - 0.5),
                            eng.cc[kind].reshape(rows, 3)], 1).contiguous()
                 for _ in range(n_corr)]
        halos = [(scale * (0.5 + rand((rows, 1)))).contiguous()
                 for _ in range(n_halo)]
        planes = [(base * (0.5 + rand(base.shape))).contiguous()
                  for _ in range(n_planes)]
        return (kind, eng.coef[kind], corrs, halos, planes), dict(
            blk=eng.block, npass=eng.scan_npass[kind])

    def worst_of(args, kw, ref):
        """REPEAT launches of B8 on the same inputs: the one farthest from
        `ref` (a race between the look-back's tiles shows intermittently)."""
        outs = [cs.sharded_substep_launch(*args, **kw) for _ in range(REPEAT)]
        return max(outs, key=lambda o: max(nerr(g, r)
                                           for g, r in zip(o, ref)))

    # Packed rows 32 (M = 8, G = 4); N = 4096 is 8 kernel tiles of b8_tile
    # = 512 cells, N = 26624 52 (plain versions: blocks of 512). Rows 2
    # (M = 2, G = 1): N = 384 lies below one tile; N = 131328 is 256 full
    # tiles and a ragged 257th, a row long enough in this deck's thin
    # groups for float32 rounding of the function itself to reach 1e-5,
    # so it is held by check_f64. Each launched REPEAT times.
    b8_tile = cs.sharded_geometry(1 << 20)[0] * 8
    n_checks = len(checks)
    for Mr, Gr, Nr in ((8, 4, 4096), (8, 4, 26624), (2, 1, b8_tile - 128),
                       (2, 1, 256 * b8_tile + b8_tile // 2)):
        e = mesh_engine(load_config(deck, M=Mr, G=Gr, N=Nr, ts_method=3),
                        "pallas", block=512)
        T = cs.sharded_geometry(Nr)[1]
        for kind, label in ((BE, "BE"), (CN, "CN"), (BDF, "BDF")):
            args, kw = b8_inputs(e, kind, 110 + kind)
            ref = cs.sharded_substep_launch_ref(*args, **kw)
            tag = f"B8-{label}-rows{e.rows}-N{Nr}-T{T}"
            if T <= 256:
                check("sharded_substep_launch", tag, worst_of(args, kw, ref),
                      ref)
                continue
            _, coef_, corrs_, halos_, planes_ = args
            ref64 = cs.sharded_substep_launch_ref(
                kind, coef_.double(), f64(corrs_), f64(halos_), f64(planes_),
                **kw)
            check_f64("sharded_substep_launch", tag,
                      worst_of(args, kw, ref64), ref, ref64)
    b8_checks = checks[n_checks:]
    # The llnl-shipped rung's shard (rows 248, N_loc = 2^13), each kind,
    # and one BDF launch timed there.
    llnl_cfg = rung_cfgs(1)[1][1]
    sh_llnl = mesh_engine(llnl_cfg, "pallas")
    n_checks = len(checks)
    for kind, label in ((BE, "BE"), (CN, "CN"), (BDF, "BDF")):
        args, kw = b8_inputs(sh_llnl, kind, 115 + kind)
        l8_ms, l8_out = timed(
            lambda: cs.sharded_substep_launch(*args, **kw), 20)
        l8_plain_ms, l8_ref = timed(
            lambda: cs.sharded_substep_launch_ref(*args, **kw), 1)
        _, coef_, corrs_, halos_, planes_ = args
        l8_ref64 = cs.sharded_substep_launch_ref(
            kind, coef_.double(), f64(corrs_), f64(halos_), f64(planes_),
            **kw)
        check_f64("sharded_substep_launch", f"B8-{label}-llnl",
                  worst_of(args, kw, l8_ref64), l8_ref, l8_ref64)
    b8_llnl_checks = checks[n_checks:]
    # The gray rung's shard (rows 32, N_loc = 2^20), BDF: timed below.
    sh_gray = mesh_engine(gray_cfg(M, N, 3), "pallas")
    b8_args, b8_kw = b8_inputs(sh_gray, BDF, 120)
    b8_threads, b8_T = cs.sharded_geometry(N)
    if b8_T < 2:
        raise AssertionError("B8 at the gray rung's shard runs one block a "
                             "row")
    torch.cuda.synchronize()
    print("phase 11 B8: ok, max normalised error "
          + ", ".join(b8_checks + b8_llnl_checks)
          + f"; one BDF launch at the llnl-shipped shard (rows "
          f"{sh_llnl.rows}, N_loc 2^13, block {sh_llnl.block}): "
          f"{l8_ms:.4f} ms, plain {l8_plain_ms:.1f} ms; timed at the gray "
          f"rung's shard (rows {sh_gray.rows}, N_loc 2^20, BDF) in the "
          f"kernels line; B8 grid there: {sh_gray.rows} rows x {b8_T} "
          f"blocks of {b8_threads} threads, one a tile; card: {card}",
          flush=True)
    phase_seconds(11)

    # -- 12. B13, the fused engine's kernel --------------------------------------
    def b13_inputs(eng, seed, materialize_only=False):
        """The previous step's unknowns v around the row's scale (both
        signs) and zero-boundary planes around the initial state."""
        g = torch.Generator(device=dev).manual_seed(seed)
        rows = eng.rows
        st0 = eng.init_state()       # the fused engine's z0, or the state's e0
        base = getattr(st0, "z0", None)
        base = (st0.e0 if base is None else base).reshape(rows, -1)
        v = (base[:, :1] * (torch.rand((rows, 7), generator=g, device=dev)
                            - 0.5)).contiguous()
        z = [(base * (0.5 + torch.rand(base.shape, generator=g,
                                       device=dev))).contiguous()
             for _ in range(2)]
        return (eng.coef[BE], eng.coef[CN], eng.coef[BDF], v, *z), dict(
            symmetric_half=eng.cfg.bdf2_symmetric_half, blk=eng.block,
            npass=eng.scan_npass, materialize_only=materialize_only)

    n_checks = len(checks)
    for Nr in (4096, 26624):
        for sym in (False, True):
            e = mesh_engine(load_config(deck, M=8, G=4, N=Nr, ts_method=3,
                                        bdf2_symmetric_half=sym),
                            "fused", block=512)
            for mo in (False, True):
                args, kw = b13_inputs(e, 130 + 2 * sym + mo, mo)
                check("fused_step_launch",
                      f"B13-{'mat' if mo else 'step'}-"
                      f"{'sym' if sym else 'asym'}-N{Nr}",
                      cf.fused_step_launch(*args, **kw),
                      cf.fused_step_launch_ref(*args, **kw))
    b13_checks = checks[n_checks:]
    # B13's look-back on its own shapes, both variants, each launched REPEAT
    # times and the worst held by check_f64 (launches need not agree to the
    # bit, as B9's): a row below one tile (N = 100, rows 2), one tile, T =
    # 2, a ragged last tile (N = 52736), 2^18 cells (T above 32), rows 2;
    # both half modes. Inputs from the per-sub-step engine's packing (the
    # same rows and coefficients as the fused engine's).
    b13_tile = cf.fused_geometry(N)[0] * 8
    b13_lb = []
    for Mr, Gr, Nr, sym, what in (
            (2, 1, 100, False, "below-one-tile"),
            (8, 4, b13_tile, True, "one-tile"),
            (8, 4, 2 * b13_tile, False, "T2"),
            (8, 4, 52736, True, "ragged"),
            (2, 4, 1 << 18, False, "T>32"),
            (2, 1, 52736, True, "rows2")):
        e = mesh_engine(load_config(deck, M=Mr, G=Gr, N=Nr, ts_method=3,
                                    bdf2_symmetric_half=sym), "pallas")
        T13 = cf.fused_geometry(Nr)[1]
        for mo in (False, True):
            args, kw = b13_inputs(e, 150 + len(b13_lb), mo)
            ref = cf.fused_step_launch_ref(*args, **kw)
            ref64 = cf.fused_step_launch_ref(*f64(args), **kw)
            outs = [cf.fused_step_launch(*args, **kw) for _ in range(REPEAT)]
            worst = max(outs, key=lambda o: max(nerr(g, r)
                                                for g, r in zip(o, ref64)))
            n_before = len(checks)
            check_f64("fused_step_launch",
                      f"B13-{'mat' if mo else 'step'}-{what}-"
                      f"{'sym' if sym else 'asym'}-rows{e.rows}-N{Nr}-T{T13}",
                      worst, ref, ref64)
            b13_lb.append(checks.pop(n_before))
    t0 = time.perf_counter()
    fx_gray = mesh_engine(gray_cfg(M, N, 3), "fused")
    fx_build_s = time.perf_counter() - t0      # mostly the host outflow map
    b13_args, b13_kw = b13_inputs(fx_gray, 140)
    fx_llnl = mesh_engine(llnl_cfg, "fused")
    n_checks = len(checks)
    l13_ms = {}
    for mo, label in ((False, "step"), (True, "mat")):
        l13_args, l13_kw = b13_inputs(fx_llnl, 141 + mo, mo)
        ms, l13_out = timed(
            lambda: cf.fused_step_launch(*l13_args, **l13_kw), 20)
        plain_ms, l13_ref = timed(
            lambda: cf.fused_step_launch_ref(*l13_args, **l13_kw), 1)
        l13_ms[label] = f"{ms:.4f} ms (plain {plain_ms:.1f} ms)"
        check_f64("fused_step_launch", f"B13-{label}-llnl", l13_out,
                  l13_ref, cf.fused_step_launch_ref(*f64(l13_args),
                                                    **l13_kw))
    b13_checks += checks[n_checks:]
    b13_geo = cf.fused_geometry(N)
    if b13_geo[1] < 2:
        raise AssertionError("B13 at the gray rung's shard runs one block a "
                             "row")
    print("phase 12 B13: ok, max normalised error " + ", ".join(b13_checks)
          + f"; look-back shapes (worst of {REPEAT} launches): "
          + ", ".join(b13_lb)
          + f"; one launch at the llnl-shipped shard (rows {fx_llnl.rows}, "
          f"N_loc 2^13, block {fx_llnl.block}): step {l13_ms['step']}, "
          f"materialize_only {l13_ms['mat']}; the gray rung's shard (rows "
          f"{fx_gray.rows}, N_loc 2^20) in the kernels line, its engine "
          f"built in {fx_build_s:.1f} s; B13 grid there: {fx_gray.rows} rows "
          f"x {b13_geo[1]} tiles of {b13_geo[0] * 8} cells, one block of "
          f"{b13_geo[0]} threads a tile, at most {b13_geo[2]} x {n_sm} in "
          f"flight; card: {card}",
          flush=True)
    phase_seconds(12)
    # Phase 13 reuses these engines: the fused engine's host outflow map
    # (parallel/step_response.py, float64 recurrences over every cell) takes
    # tens of seconds to build at the gray rung.
    built = {("gray", "pallas"): sh_gray, ("gray", "fused"): fx_gray,
             ("llnl", "pallas"): sh_llnl, ("llnl", "fused"): fx_llnl}

    # -- 13. the mesh path -------------------------------------------------------
    cs.reset_launch_counts()
    cf.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mesh_cli = []
        for engine_name in ("pallas", "fused", "auto"):
            summary, out = cli_vs_cpu(
                tmp, gray_deck, 200, f"mesh1x1-{engine_name}",
                ["--engine", engine_name, "--mesh", "1x1", "--dtype",
                 "float32"])
            mesh_cli.append(summary)
        if "auto engine: CudaSweepEngine" not in out:
            raise AssertionError("cli --engine auto --mesh 1x1 on "
                                 "single_group.prm did not keep the "
                                 "single-device rule: " + "; ".join(out[:4]))
        text = open(gray_deck).read()
        for old, new in (("N=100", "N=2048"), ("X=1.", "X=20.48")):
            text = text.replace(old, new)
        thick = os.path.join(tmp, "single_group_thick.prm")
        with open(thick, "w") as fh:
            fh.write(text)
        mesh_cli.append(cli_vs_cpu(
            tmp, thick, 200, "mesh1x1-halo-thick",
            ["--engine", "halo", "--mesh", "1x1", "--dtype", "float32"])[0])

    held = Held()

    rung_lines, fused_gray_rate = [], None
    halo_gray_rate = halo_gray_grid = b4r = None
    for tag, cfg, steps0 in rung_cfgs(1):
        ups_rung = 4 * cfg.M * cfg.G * cfg.N * 64
        ref_e = engine(cfg)
        ref0 = planes_of(ref_e, ref_e.solve(num_steps=steps0))
        row = {}
        if tag == "llnl":
            # The float32 engines' distance from the double-float one.
            dfe = df_engine(cfg)
            d0 = planes_of(dfe, dfe.solve(num_steps=steps0))
            row["CudaSweepEngine_vs_df_after_2"] = max(
                nerr(a, b) for a, b in zip(ref0, d0))
            del dfe
        pk = peak_from()
        torch.cuda.synchronize()
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        ref_e.solve(num_steps=8)                           # warm-up
        a_ev.record()
        rst = ref_e.solve(num_steps=64)
        b_ev.record()
        torch.cuda.synchronize()
        ref_secs = a_ev.elapsed_time(b_ev) / 1e3
        ref64 = planes_of(ref_e, rst)
        ref_ok, ref_max = guard(ref64)
        row["CudaSweepEngine"] = {"seconds_64": ref_secs,
                                  "updates_per_s": ups_rung / ref_secs,
                                  "peak_gib": pk(), "in_guard_64": ref_ok,
                                  "max_abs_64": ref_max}
        del ref_e, rst
        rung_engines = ("pallas", "fused", "halo") if tag == "gray" else (
            "pallas", "fused")
        for engine_name in rung_engines:
            eng = built.pop((tag, engine_name), None) or mesh_engine(
                cfg, engine_name)
            ename = type(eng).__name__
            err0 = max(nerr(a, b) for a, b in zip(
                planes_of(eng, eng.solve(num_steps=steps0)), ref0))
            pk = peak_from()
            eng.solve(num_steps=8)                         # warm-up
            torch.cuda.synchronize()
            a_ev.record()
            st = eng.solve(num_steps=64)
            b_ev.record()
            torch.cuda.synchronize()
            secs = a_ev.elapsed_time(b_ev) / 1e3
            peak64 = pk()
            got64 = planes_of(eng, st)              # 64 steps from the start
            ok, mx = guard(got64)
            drift = max(nerr(a, b) for a, b in zip(got64, ref64))
            row[ename] = {
                f"vs_CudaSweepEngine_after_{steps0}": held(
                    f"{tag} {ename} after {steps0} steps", err0),
                "seconds_64": secs, "updates_per_s": ups_rung / secs,
                "peak_gib": peak64, "in_guard_64": ok, "max_abs_64": mx,
                "drift_64": held.guarded(f"{tag} {ename} 64-step drift",
                                         drift, ref64, DRIFT_TOL)}
            if (tag, engine_name) == ("gray", "fused"):
                fused_gray_rate = ups_rung / secs
            if (tag, engine_name) == ("gray", "halo"):
                # B4's grid at the gray rung (one cluster a packed row: more
                # than one block a row), and its main launch's arguments
                # from the 64-step state, timed with the shapes below.
                halo_gray_rate = ups_rung / secs
                Kr, Xr = eng.K_launch, eng.H + eng.N_loc
                threads, Cr, tm, th = cs.halo_bdf2_geometry(Xr, Kr, eng.H,
                                                            eng.rows)
                if Cr < 2:
                    raise AssertionError(f"B4 at the gray rung: {Cr} block "
                                         f"a row")
                halo_gray_grid = (f"K={Kr} H={eng.H}: {eng.rows} rows x "
                                  f"{Cr} blocks of {threads} threads, tiles "
                                  f"a row {th} (halo) + {tm} (seeded)")
                xr = [torch.cat([p.new_zeros((*p.shape[:-1], eng.H)), p], -1)
                      .reshape(eng.rows, -1) for p in (st.e0, st.e1)]
                b4r = (Cr, (eng.coef[BE], eng.coef[CN], eng.coef[BDF],
                            eng._main_seeds(Kr), eng.hb, *xr),
                       dict(K=Kr,
                            symmetric_half=bool(cfg.bdf2_symmetric_half),
                            blk=eng.block, npass_be=eng.scan_npass[BE],
                            npass_cn=eng.scan_npass[CN],
                            npass_bdf=eng.scan_npass[BDF]))
            del eng, st, got64
        rung_lines.append(f"{tag} (N={cfg.N}) " + json.dumps(row))
    launches.update(read_counts(PATH_SHARDED + PATH_FUSED,
                                "the mesh path (phase 13)"))

    # The two-rank rung: two processes share the card over gloo.
    ranks, backend, two_wall = run_ranks(2)
    two_lines = compare_ranks(ranks, 2, mesh_engine, held)
    print(f"phase 13 mesh path: {'FAILED' if held.failures else 'ok'}; CLI "
          "--mesh 1x1 vs CPU: " + "; ".join(mesh_cli) + "; one-rank rungs "
          "(64 steps timed with CUDA events after an 8-step warm-up): "
          + "; ".join(rung_lines) + "; row-walk gray rung updates/s: "
          + ", ".join(f"{k.split()[-1]} {v:.6g}" for k, v in WALK_RATES.items()
                      if k.startswith("gray rung"))
          + f"; FusedExchangeCudaEngine gray rung {fused_gray_rate:.6g} "
          f"updates/s (B13 one block a row: "
          f"{B9_B13_WALK['gray rung FusedExchangeCudaEngine']:.6g})"
          + f"; HaloCudaEngine gray rung {halo_gray_rate:.6g} updates/s "
          f"(B4 on the row walk: "
          f"{B4_B15_WALK['gray rung HaloCudaEngine']:.6g}), B4 grid there "
          f"{halo_gray_grid}"
          + f"; two ranks sharing the card ({backend};"
          " a check of the exchanges on the real kernels, not a scaling "
          f"figure; {two_wall:.1f} s wall with start-up): "
          + "; ".join(two_lines) + f"; card: {card}", flush=True)
    phase_seconds(13)
    if held.failures:
        raise AssertionError("phase 13: " + "; ".join(held.failures))

    # -- 14. the general f64 path -------------------------------------------------
    print(general_path(
        dev, card, cli_vs_cpu, run_cli, variant, peak_from,
        {"CudaSweepEngine": rate, "DFCudaEngine": d_rate}),
        flush=True)
    phase_seconds(14)

    # -- 15. A8's utilities: checkpoints, the CLI's run-time flags ----------------
    print(utilities_path(dev, card, peak_from), flush=True)
    phase_seconds(15)

    # -- 16. ensembles (A10) and the fast engine (A7's first half) ---------------
    print(ensemble_path(dev, card, peak_from,
                        {"CudaSweepEngine": rate, "DFCudaEngine": d_rate}),
          flush=True)
    phase_seconds(16)

    # -- 17. steady state and the sharded fast engine (A7's second half) -------
    print(steady_fast_path(dev, card, peak_from), flush=True)
    phase_seconds(17)

    # -- 18. the native I/O (A14) and the plot reader (A13) ------------------------
    print(native_io_path(dev, card, rtio_line), flush=True)
    phase_seconds(18)

    # -- 19. the worked examples (A16) and the remat peak under vmap(grad) ----
    print(examples_path(dev, card), flush=True)
    phase_seconds(19)

    # -- kernel vs plain at the full-size shapes (not counted above) ------------
    # Bytes: each input read once, each output written once (a record the
    # kernel only passes between its own launches is not counted; the halo
    # kernels read seeds and write a record of the same shape).
    table = []
    rs = rand_state(big, 99)
    rcn = rand_state(cn_eng, 98)
    consts = (big.coef[BE], big.coef[CN], big.coef[BDF], big.bc, big.flip)
    planes = 2 * big.Bh * N * 4            # bytes of one (2, Bh, N) plane
    cells = 2 * big.Bh * N

    # B5 at gray_s8 CN: its main launch over H + N packed cells (phase 6's
    # arguments). B4 at gray_s8 BDF2: the main launch timed above, on random planes.
    xb = [x * (0.5 + torch.rand(x.shape, generator=g5, device=dev))
          for x in (x0.reshape(rows8, -1), x1.reshape(rows8, -1))]
    b4_args = (halo.coef[BE], halo.coef[CN], halo.coef[BDF], main_seeds,
               halo.hb, *xb)
    b4_kw = dict(K=Kh, symmetric_half=False, blk=halo.block,
                 npass_be=halo.scan_npass[BE], npass_cn=halo.scan_npass[CN],
                 npass_bdf=halo.scan_npass[BDF])
    Xh = xb[0].shape[1]

    # B6 at the df bench shape (the engine's K), B7 CN at the same shape:
    # 4 planes in, 12 (B6) or 8 (B7) out, on random double-float states.
    dcn = df_engine(gray_cfg(M, N, 2))
    Kdc = dcn.max_steps_per_launch()
    rd, rdc = df_rand(dbig, 96), df_rand(dcn, 95)
    use_corr = bool(dbig.cfg.use_correction)

    def df_consts(eng):
        return nbytes(*eng.coef.values(), *eng.dcoef.values(), eng.bc,
                      eng.bcl, eng.flip)

    def abs_err(got, ref):
        return max(float((g.double() - r.double()).abs().max())
                   for g, r in zip(got, ref))

    def df_abs_err(got, ref):
        return max(float(((got[i].double() + got[i + 1].double())
                          - (ref[i].double() + ref[i + 1].double()))
                         .abs().max()) for i in range(0, len(ref), 2))

    def f32_err(got, ref):
        return max(nerr(g, r) for g, r in zip(got, ref))

    # B14 at gray_s8 BDF2 (the main launch timed above) and B15 at gray_s8
    # CN (phase 8's arguments), each over H + N packed cells on random
    # double-float planes: 4 planes in, 12 (B14) or 8 (B15) out, (hi, lo)
    # seeds in, a record out.
    b14_args = (*(dhalo.coef[k] for k in (BE, CN, BDF)),
                *(dhalo.dcoef[k] for k in (BE, CN, BDF)), *dseeds, dhalo.hb,
                *df_packed(dhalo, 94))
    b14_kw = dict(K=Kdh, symmetric_half=False, use_corr=use_corr,
                  blk=dhalo.block, npass=dhalo.scan_npass,
                  npass_c=dhalo.corr_npass)

    # B9 and B10 at the adjoint bench shape (gray S_32, N = 2^17, BDF2, a
    # reflective boundary), one step on a random state: B9 reads
    # 2 planes and writes 4 and its records; B10 reads the 2 input planes,
    # 4 cotangent planes and the records, and writes 2 planes, cbc and the 3
    # gradient packs.
    ageo, aco = ca.step_geometry(fwd_eng), adj_coefs(fwd_eng)
    ars = rand_state(fwd_eng, 92)
    acells = 2 * fwd_eng.Bh * Na
    aplane = acells * 4
    ga = torch.Generator(device=dev).manual_seed(91)
    acots = [(torch.rand(ars.e0.shape, generator=ga, device=dev) - 0.5)
             .contiguous() for _ in range(4)]
    b9_in = (*aco, fwd_eng.bc, fwd_eng.flip, ars.e0, ars.e1)
    a_recs = ca.fwd_record_launch(*b9_in, **ageo)[4:]
    p_recs = ca.fwd_record_launch_ref(*b9_in, **ageo)[4:]
    b10_in = (*aco, fwd_eng.flip, ars.e0, ars.e1, *acots)
    a_consts = nbytes(*aco, fwd_eng.bc, fwd_eng.flip)
    a_small = 4 * fwd_eng.Bh * (2 + 3 * 2 * cs._NCOEF)   # cbc and packs
    # B11 and B12 at the same shape and the K-fused default (K = Ka): B11
    # reads 2 planes and writes 6, the K-1 intermediate inputs (2 planes
    # each) and its records; B12 reads the 2 input planes, the intermediate
    # inputs, 6 cotangent planes and the records, and writes 2 planes, cbc
    # and the 3 gradient packs.
    b11_out = ca.fwd_record_k_launch(*b9_in, K=Ka, **ageo)
    p11_out = ca.fwd_record_k_launch_ref(*b9_in, K=Ka, **ageo)
    kcots = acots + [(torch.rand(ars.e0.shape, generator=ga, device=dev)
                      - 0.5).contiguous() for _ in range(2)]
    b12_in = (*aco, fwd_eng.flip, ars.e0, ars.e1, *b11_out[9:], *kcots,
              *b11_out[6:9])
    p12_in = (*aco, fwd_eng.flip, ars.e0, ars.e1, *p11_out[9:], *kcots,
              *p11_out[6:9])
    k_recs = nbytes(*b11_out[6:9])

    # B8 at the gray rung's shard (BDF: 6 planes in, 2 out) and B13 there
    # (2 planes in, 4 out and the record).
    # B8 also zeroes and publishes its look-back words (8 bytes a tile and
    # the tile counter).
    b8_bytes = (8 * nbytes(b8_args[4][0]) + nbytes(b8_args[1], *b8_args[2],
                                                   *b8_args[3])
                + 16 * (sh_gray.rows * b8_T + 1))
    b13_bytes = (6 * nbytes(b13_args[4]) + nbytes(*b13_args[:4])
                 + 4 * fx_gray.rows * 6)
    f32 = (abs_err, f32_err, TOL, SWEEP_CU)
    dfk = (df_abs_err, df_err, DF_TOL, DF_CU)
    jobs = [
        ("bdf2_launch", lambda: big.multi_step(rs, K),
         lambda: bdf2_plain(big, rs, K), 20,
         8 * planes + nbytes(*consts), cells * K * BDF2_STEP_FLOPS, f32),
        ("multistep_launch", lambda: cn_eng.multi_step(rcn, Kcn)[:4],
         lambda: multistep_plain(cn_eng, rcn, Kcn), 10,
         6 * planes + nbytes(cn_eng.coef[CN], big.bc, big.flip),
         cells * Kcn * FLOPS_PER_CELL["CN"], f32),
        ("substep_launch", lambda: big.substep(BDF, rs),
         lambda: substep_plain(big, BDF, rs), 50,
         8 * planes + nbytes(big.coef[BDF], big.bc, big.flip),
         cells * FLOPS_PER_CELL["BDF"], f32),
        ("halo_bdf2_launch", lambda: cs.halo_bdf2_launch(*b4_args, **b4_kw),
         lambda: cs.halo_bdf2_launch_ref(*b4_args, **b4_kw), 20,
         8 * nbytes(xb[0]) + nbytes(*b4_args[:3]) + 2 * nbytes(main_seeds),
         rows8 * Xh * Kh * BDF2_STEP_FLOPS, f32),
        ("halo_multistep_launch",
         lambda: cs.halo_multistep_launch(*b5_args, **b5_kw),
         lambda: cs.halo_multistep_launch_ref(*b5_args, **b5_kw), 20,
         6 * nbytes(xc[0]) + nbytes(halo_cn.coef[CN]) + 2 * nbytes(s5),
         halo_cn.rows * xc[0].shape[1] * Kc5 * FLOPS_PER_CELL["CN"], f32),
        ("df_bdf2_launch", lambda: df_launch(dbig, rd, Kd),
         lambda: df_launch(dbig, rd, Kd, plain=True), 5,
         16 * planes + df_consts(dbig),
         cells * Kd * df_step_flops(3, use_corr), dfk),
        ("df_multistep_launch", lambda: df_launch(dcn, rdc, Kdc),
         lambda: df_launch(dcn, rdc, Kdc, plain=True), 5,
         12 * planes + df_consts(dcn),
         cells * Kdc * df_step_flops(2, use_corr), dfk),
        ("df_halo_bdf2_launch",
         lambda: cd.df_halo_bdf2_launch(*b14_args, **b14_kw),
         lambda: cd.df_halo_bdf2_launch_ref(*b14_args, **b14_kw), 10,
         16 * nbytes(b14_args[-1]) + nbytes(*b14_args[:6])
         + 4 * nbytes(dseeds[0]),
         b14_args[-1].numel() * Kdh * df_step_flops(3, use_corr), dfk),
        ("df_halo_multistep_launch",
         lambda: cd.df_halo_multistep_launch(*b15_args, **b15_kw),
         lambda: cd.df_halo_multistep_launch_ref(*b15_args, **b15_kw), 10,
         12 * nbytes(b15_args[-1]) + nbytes(*b15_args[1:3])
         + 4 * nbytes(b15_args[3]),
         b15_args[-1].numel() * Kdc15 * df_step_flops(2, use_corr), dfk),
        ("fwd_record_launch",
         lambda: ca.fwd_record_launch(*b9_in, **ageo)[:4],
         lambda: ca.fwd_record_launch_ref(*b9_in, **ageo)[:4], 20,
         6 * aplane + nbytes(*a_recs) + a_consts, acells * BDF2_STEP_FLOPS,
         (abs_err, f32_err, TOL, ADJ_CU)),
        ("bwd_launch", lambda: ca.bwd_launch(*b10_in, *a_recs, **ageo),
         lambda: ca.bwd_launch_ref(*b10_in, *p_recs, **ageo), 20,
         8 * aplane + nbytes(*a_recs) + a_consts + a_small,
         acells * ADJ_BDF2_STEP_FLOPS, (abs_err, adj_err, TOL, ADJ_CU)),
        ("fwd_record_k_launch",
         lambda: (lambda o: o[:6] + o[9:])(
             ca.fwd_record_k_launch(*b9_in, K=Ka, **ageo)),
         lambda: (lambda o: o[:6] + o[9:])(
             ca.fwd_record_k_launch_ref(*b9_in, K=Ka, **ageo)), 10,
         (8 + 2 * (Ka - 1)) * aplane + k_recs + a_consts,
         acells * Ka * BDF2_STEP_FLOPS, (abs_err, f32_err, TOL, ADJ_CU)),
        ("bwd_k_launch", lambda: ca.bwd_k_launch(*b12_in, K=Ka, **ageo),
         lambda: ca.bwd_k_launch_ref(*p12_in, K=Ka, **ageo), 10,
         (10 + 2 * (Ka - 1)) * aplane + k_recs + a_consts + a_small,
         acells * Ka * ADJ_BDF2_STEP_FLOPS, (abs_err, adj_err, TOL, ADJ_CU)),
        ("sharded_substep_launch",
         lambda: cs.sharded_substep_launch(*b8_args, **b8_kw),
         lambda: cs.sharded_substep_launch_ref(*b8_args, **b8_kw), 20,
         b8_bytes, b8_args[4][0].numel() * B8_FLOPS_PER_CELL["BDF"],
         (abs_err, f32_err, TOL, SHARDED_CU)),
        ("fused_step_launch", lambda: cf.fused_step_launch(*b13_args, **b13_kw),
         lambda: cf.fused_step_launch_ref(*b13_args, **b13_kw), 10,
         b13_bytes, b13_args[4].numel() * B13_FLOPS_PER_CELL,
         (abs_err, f32_err, TOL, FUSED_CU)),
    ]
    split = []
    for name, kernel_fn, plain_fn, reps, nb, flops, kind in jobs:
        abs_fn, norm_fn, tol, source = kind
        ms, got = timed(kernel_fn, reps)
        pms, ref = timed(plain_fn, 1)
        err = abs_fn(got, ref)
        norm = norm_fn(got, ref)
        if not norm <= tol:
            raise AssertionError(f"{name} full size: normalised error "
                                 f"{norm:.3e} > {tol}")
        bound_ms, bound_by = bound(nb, flops)
        # The path's launches at the shape just timed, and the rest.
        at = sum(1 for key in path_shapes[name] if key == shape_log[name][-1])
        logged = len(path_shapes[name])
        split.append(f"{name} {at} + {logged - at}"
                     + ("" if logged == launches[name] else
                        f" (count {launches[name]})"))
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": REPLACES[name],
                      "launches": launches[name], "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      # No single PyTorch call computes this affine
                      # recurrence with its 2x2 reconstruction (nor its
                      # transpose).
                      "library_ms": None})
    # The redesigned kernels' shape choices, timed as the table times (not
    # counted above): B1 and B2-CN at the bench (below), B6 at the df bench
    # at K = 1, 2 and 4 with 512 and 256
    # threads a block, B6 at gray_s8 (the engine's K) with at most 16 and 8
    # blocks a row, B8 (BDF) at the gray rung's shard with 32-512 threads.
    shape_ms = []

    def shaped(mod, attr, value, fn, reps):
        old = getattr(mod, attr)
        setattr(mod, attr, value)
        try:
            return timed(fn, reps)[0]
        finally:
            setattr(mod, attr, old)

    # B1 at the bench at K = 1, 4, 8 and B2-CN there at K = 8, 16, each at
    # the C the geometry picks and at half of it.
    for tag, eng_, Kxs, spp, x in (("B1", big, (1, 4, 8), 4, rs),
                                   ("B2-CN", cn_eng, (8, 16), 1, rcn)):
        for Kx in Kxs:
            C = cs.sweep_geometry(N, Kx, eng_.Bh, spp)[1]
            for mc in (cs.SWEEP_MAX_CLUSTER, max(1, C // 2)):
                ms = shaped(cs, "SWEEP_MAX_CLUSTER", mc,
                            lambda: eng_.multi_step(x, Kx), 3)
                Cx = min(C, mc)
                shape_ms.append(f"{tag} bench K={Kx} C={Cx} {ms:.3f} ms")
    for thr in (512, 256):
        for Kx in (1, 2, 4):
            ms = shaped(cd, "DF_BDF2_THREADS", thr,
                        lambda: df_launch(dbig, rd, Kx), 3)
            shape_ms.append(f"B6 df bench K={Kx} {thr} threads {ms:.3f} ms")
    rd8 = df_rand(d8, 90)
    for mc in (16, 8):
        ms = shaped(cd, "DF_BDF2_MAX_CLUSTER", mc,
                    lambda: df_launch(d8, rd8, Kd8), 5)
        shape_ms.append(f"B6 gray_s8 K={Kd8} at most {mc} blocks a row "
                        f"{ms:.3f} ms")
    # B14 at gray_s8's main launch with at most 16 and 8 blocks a chain; B11
    # at the adjoint bench (K = Ka) at the blocks a row the geometry picks
    # and at half as many.
    for mc in (16, 8):
        ms = shaped(cd, "DF_BDF2_MAX_CLUSTER", mc,
                    lambda: cd.df_halo_bdf2_launch(*b14_args, **b14_kw), 5)
        shape_ms.append(f"B14 gray_s8 K={Kdh} at most {mc} blocks a chain "
                        f"{ms:.3f} ms")
    # B14's other option at gray_s8, two launches: the seeded chains alone
    # (rows clusters over [H, H + N)) and the halo chains alone (over [0,
    # H)), each from the same planes as one launch's, at the blocks a chain
    # the geometry picks for rows clusters.
    for tag, lo, hi in (("seeded chains alone", dhalo.H, dhalo.H + Ns),
                        ("halo chains alone", 0, dhalo.H)):
        part = [p[:, lo:hi].contiguous() for p in b14_args[9:]]
        ms = timed(lambda: cd.df_halo_bdf2_launch(*b14_args[:8], 0, *part,
                                                  **b14_kw), 5)[0]
        C = cd.df_halo_bdf2_geometry(hi - lo, Kdh, 0, dhalo.rows)[1]
        shape_ms.append(f"B14 gray_s8 K={Kdh} {tag} C={C} {ms:.3f} ms")
    # B4 at gray_s8's main launch and at the gray rung's (one rank), B15 at
    # gray_s8's CN main launch, each at the blocks a row the geometry picks
    # and at half as many.
    C4 = cs.halo_bdf2_geometry(Xh, Kh, halo.H, rows8)[1]
    for Cx, fn, tag in (
            (C4, lambda: cs.halo_bdf2_launch(*b4_args, **b4_kw),
             f"B4 gray_s8 K={Kh}"),
            (b4r[0], lambda: cs.halo_bdf2_launch(*b4r[1], **b4r[2]),
             f"B4 gray rung K={b4r[2]['K']}")):
        for mc in sorted({Cx, max(1, Cx // 2)}, reverse=True):
            ms = shaped(cs, "SWEEP_MAX_CLUSTER", mc, fn, 5)
            shape_ms.append(f"{tag} C={mc} {ms:.3f} ms")
    C15 = cd.df_halo_multistep_geometry(dhalo_cn.H + Ns, Kdc15, dhalo_cn.H,
                                        dhalo_cn.rows)[1]
    for mc in sorted({C15, max(1, C15 // 2)}, reverse=True):
        ms = shaped(cd, "DF_BDF2_MAX_CLUSTER", mc,
                    lambda: cd.df_halo_multistep_launch(*b15_args, **b15_kw),
                    5)
        shape_ms.append(f"B15 gray_s8 CN K={Kdc15} C={mc} {ms:.3f} ms")
    # B5 at gray_s8's CN main launch and B7 at the df bench's CN shape, each
    # at the blocks a row the geometry picks and at half as many.
    C5 = cs.halo_multistep_geometry(halo_cn.H + Ns, Kc5, halo_cn.H,
                                    halo_cn.rows)[1]
    for mc in sorted({C5, max(1, C5 // 2)}, reverse=True):
        ms = shaped(cs, "SWEEP_MAX_CLUSTER", mc,
                    lambda: cs.halo_multistep_launch(*b5_args, **b5_kw), 20)
        shape_ms.append(f"B5 gray_s8 CN K={Kc5} C={mc} {ms:.3f} ms")
    C7 = cd.df_multistep_geometry(N, Kdc, dcn.Bh)[1]
    for mc in sorted({C7, max(1, C7 // 2)}, reverse=True):
        ms = shaped(cd, "DF_BDF2_MAX_CLUSTER", mc,
                    lambda: df_launch(dcn, rdc, Kdc), 5)
        shape_ms.append(f"B7 df bench CN K={Kdc} C={mc} {ms:.3f} ms")
    C11 = ca.fwd_k_geometry(Na, Ka, fwd_eng.Bh)[1]
    for mc in sorted({C11, max(1, C11 // 2)}, reverse=True):
        ms = shaped(cs, "SWEEP_MAX_CLUSTER", mc,
                    lambda: ca.fwd_record_k_launch(*b9_in, K=Ka, **ageo), 5)
        shape_ms.append(f"B11 adjoint bench K={Ka} C={mc} {ms:.3f} ms")
    # B3 at the bench, each kind, with 32-512 threads a block (look-back
    # tiles of 8 cells a thread).
    for thr in (32, 64, 128, 256, 512):
        for kind, kname in ((BE, "BE"), (CN, "CN"), (BDF, "BDF")):
            ms = shaped(cs, "SUBSTEP_THREADS", thr,
                        lambda: big.substep(kind, rs), 20)
            shape_ms.append(f"B3 bench {kname} {thr} threads {ms:.4f} ms")
    for thr in (32, 64, 128, 512):
        ms = shaped(cs, "SHARDED_THREADS", thr,
                    lambda: cs.sharded_substep_launch(*b8_args, **b8_kw), 20)
        shape_ms.append(f"B8 gray shard BDF {thr} threads {ms:.4f} ms")
    # B9 at the adjoint bench with 32-512 threads a block (look-back tiles
    # of 8 cells a thread); B13 at the gray rung's shard with 32-128
    # threads (its build's launch bounds), both variants at its own.
    for thr in (32, 64, 128, 256, 512):
        ms = shaped(ca, "ADJ_FWD_THREADS", thr,
                    lambda: ca.fwd_record_launch(*b9_in, **ageo), 20)
        shape_ms.append(f"B9 adjoint bench {thr} threads {ms:.4f} ms")
    for thr in (32, 64, 128):
        ms = shaped(cf, "FUSED_THREADS", thr,
                    lambda: cf.fused_step_launch(*b13_args, **b13_kw), 10)
        shape_ms.append(f"B13 gray shard {thr} threads {ms:.4f} ms")
    ms = timed(lambda: cf.fused_step_launch(
        *b13_args, **dict(b13_kw, materialize_only=True)), 10)[0]
    shape_ms.append(f"B13 gray shard materialize_only {cf.FUSED_THREADS} "
                    f"threads {ms:.4f} ms")
    # B10 and B12 (K = Ka) at the adjoint bench with 256 and 128 threads a
    # block (1024- and 512-cell sub-tiles), each at the blocks a row the
    # geometry picks and at half as many.
    for tag, Kx, fn in (
            ("B10", 1, lambda: ca.bwd_launch(*b10_in, *a_recs, **ageo)),
            ("B12", Ka, lambda: ca.bwd_k_launch(*b12_in, K=Ka, **ageo))):
        for thr in (ca.ADJ_BWD_THREADS, 128):
            old_thr = ca.ADJ_BWD_THREADS
            ca.ADJ_BWD_THREADS = thr
            try:
                C = ca.bwd_geometry(Na, Kx, fwd_eng.Bh, 4)[1]
                for mc in sorted({C, max(1, C // 2)}, reverse=True):
                    ms = shaped(ca, "ADJ_BWD_MAX_CLUSTER", mc, fn, 5)
                    shape_ms.append(f"{tag} adjoint bench K={Kx} {thr} "
                                    f"threads C={mc} {ms:.3f} ms")
            finally:
                ca.ADJ_BWD_THREADS = old_thr
    print("redesign shapes (one H100 launch each, CUDA events): "
          + "; ".join(shape_ms) + f"; card: {card}", flush=True)
    print("path launches at the timed shape + elsewhere: " + ", ".join(split),
          flush=True)
    row_ms = {row["name"]: row["ms"] for row in table}
    # B3 at the bench at each kind (BDF the table's row), beside its bound:
    # BE reads 2 planes, CN 3, BDF 6, and each writes 2.
    b3_kinds = []
    for kind, kname, nplanes in ((BE, "BE", 4), (CN, "CN", 5),
                                 (BDF, "BDF", 8)):
        ms = (row_ms["substep_launch"] if kind == BDF else
              timed(lambda: big.substep(kind, rs), 20)[0])
        bms, by = bound(nplanes * planes
                        + nbytes(big.coef[kind], big.bc, big.flip),
                        cells * FLOPS_PER_CELL[kname])
        b3_kinds.append(f"{kname} {ms:.4f} ms (bound {bms:.4f} by {by}; row "
                        f"walk {B3_WALK[f'substep_launch {kname} ms']})")
    print(f"B3, one launch at the bench ({cs.SUBSTEP_THREADS} threads a "
          "block), this run against the row walk (one block a row, NVIDIA "
          "H100 80GB HBM3 at 700.00 W): " + "; ".join(b3_kinds)
          + f"; card: {card}", flush=True)
    print("B9 and B13, one launch, this run against the row walk (one block "
          "a row, NVIDIA H100 80GB HBM3 at 700.00 W): fwd_record_launch "
          f"{row_ms['fwd_record_launch']:.4f} ms (row walk "
          f"{B9_B13_WALK['fwd_record_launch ms']}), fused_step_launch "
          f"{row_ms['fused_step_launch']:.4f} ms (row walk "
          f"{B9_B13_WALK['fused_step_launch ms']}); grad_k1_vs_fwd "
          f"{bench['grad_k1_vs_fwd']:.4g} (row walk "
          f"{B9_B13_WALK['grad_k1_vs_fwd']}); card: {card}", flush=True)
    print("B11 and B14, one launch, this run against the row walk (one block "
          "a row, NVIDIA H100 80GB HBM3 at 700.00 W): fwd_record_k_launch "
          f"{row_ms['fwd_record_k_launch']:.4f} ms (row walk "
          f"{B11_B14_WALK['fwd_record_k_launch ms']}), df_halo_bdf2_launch "
          f"{row_ms['df_halo_bdf2_launch']:.4f} ms (row walk "
          f"{B11_B14_WALK['df_halo_bdf2_launch ms']}); card: {card}",
          flush=True)
    print("B4 and B15, one launch, this run against the row walk (one block "
          "a row, NVIDIA H100 80GB HBM3 at 700.00 W): halo_bdf2_launch "
          f"{row_ms['halo_bdf2_launch']:.4f} ms (row walk "
          f"{B4_B15_WALK['halo_bdf2_launch ms']}), df_halo_multistep_launch "
          f"{row_ms['df_halo_multistep_launch']:.4f} ms (row walk "
          f"{B4_B15_WALK['df_halo_multistep_launch ms']}); gray_s8 "
          f"HaloCudaEngine {ups / h_seconds:.6g} updates/s (row walk "
          f"{B4_B15_WALK['gray_s8 HaloCudaEngine']:.6g}), gray rung "
          f"HaloCudaEngine {halo_gray_rate:.6g} (row walk "
          f"{B4_B15_WALK['gray rung HaloCudaEngine']:.6g}); card: {card}",
          flush=True)
    print("B5 and B7, one launch, this run against the row walk (one block "
          "a row, NVIDIA H100 80GB HBM3 at 700.00 W): halo_multistep_launch "
          f"{row_ms['halo_multistep_launch']:.4f} ms (row walk "
          f"{B5_B7_WALK['halo_multistep_launch ms']}), df_multistep_launch "
          f"{row_ms['df_multistep_launch']:.4f} ms (row walk "
          f"{B5_B7_WALK['df_multistep_launch ms']}); gray_s8 CN "
          f"HaloCudaEngine {ups_cn / hc_seconds:.6g} updates/s (row walk "
          f"{B5_B7_WALK['gray_s8 CN HaloCudaEngine']:.6g}), df gray_s8 CN "
          f"DFCudaEngine {ups_cn / dpc_seconds:.6g} (row walk "
          f"{B5_B7_WALK['df gray_s8 CN DFCudaEngine']:.6g}); card: {card}",
          flush=True)
    phase_seconds("tail (kernel table, shapes)")
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2], int(sys.argv[3]),
                             int(sys.argv[4])))
    if sys.argv[1:2] == ["--general-worker"]:
        sys.exit(general_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--a8-worker"]:
        sys.exit(a8_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--ensemble-worker"]:
        sys.exit(ensemble_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--fast-mesh-worker"]:
        sys.exit(fast_mesh_worker(sys.argv[2], int(sys.argv[3]),
                                  sys.argv[4]))
    if sys.argv[1:2] == ["--remat-worker"]:
        sys.exit(remat_worker(sys.argv[2], sys.argv[3] == "1"))
    if sys.argv[1:2] == ["--ranks"]:
        sys.exit(ranks_check(int(sys.argv[2]), sys.argv[3:4] == ["fast"]))
    sys.exit(main())
