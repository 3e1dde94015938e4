#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, one line each; any failure exits nonzero before the result line:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compile csrc/*.cu with nvcc for sm_90a (radiative_transfer_tpu_torch
   /_build/) and print its seconds, each nvcc command's seconds and the
   compiler's register report;
3. kernel parity: each CUDA kernel (B1 bdf2, B2 multistep, B3 substep) on
   seeded random states against its plain PyTorch version on the same card,
   max error over max magnitude <= 1e-5 (the kernels scan exactly, the plain
   versions truncate to scan_tol = 1e-10; the rest is f32 rounding);
4. main path: the port's CLI with --engine pallas --device cuda on
   prm/llnl_slab_test.prm (2 steps), prm/single_group.prm (200 steps) and its
   BE and CN variants, plus BE/CN engine.step() calls; the 8 CSVs must be
   finite and agree with the same CLI run on the CPU (plain versions)
   within the f32 drift of two trajectories (5e-5, see DRIFT_TOL);
5. full size: the bench.py workload (gray S_32, N = 2^20, BDF2, Courant 0.4,
   reflective left, source right): three windows of 64 steps after a
   two-launch warm-up, timed with CUDA events; prints the median updates/s,
   the plain version's time for one K-step launch at the same shape and
   the peak device memory above what the phase started with;
6. tiny-batch auto route (the packed-rows halo engine, B4 and B5): the CLI
   with --engine auto --dtype float32 on prm/single_group.prm (routes to
   the plain engine) against its CPU run; HaloCudaEngine against
   CudaSweepEngine at the benchmarks/suite.py gray_s8 shape (S_8 gray,
   Bh = 4, N = 2^18, Courant 0.4, reflective left) for BDF2, BE and CN, 64
   steps, ends, prev and half within DRIFT_TOL; then gray_s8 through
   make_multichip_engine("auto"), which must pick HaloCudaEngine, timed as
   in phase 5, and the same workload on CudaSweepEngine;
7. f64-grade path (the double-float engine, B6 and B7): the CLI with
   --engine df on prm/single_group.prm (200 steps) and its BE and CN
   variants, prm/multi_group_equilibrium.prm (200 steps) and
   prm/llnl_slab_test.prm (2 steps), each within DF_CLI_TOL of its CPU run;
   --engine auto at the default float64 must print the df line; the
   equilibrium deck (single_group.prm with psi_source = B) must keep
   max|F| / B < 1e-12 after 200 steps; then the bench workload and gray_s8
   on DFCudaEngine, timed as in phase 5;
8. f64 tiny-batch route (the packed-rows double-float halo engine, B14 and
   B15): B14 and B15 against their plain versions to DF_TOL in hi + lo
   (packed rows 2 and 32, a segment and a reset cell off the kernel's
   2048-cell tile, reset 0 and > 0, K 1 and 2 for BDF2 in both half modes,
   K 1 and 3 for BE and CN); then the path: the CLI with --engine auto at
   the default float64 on a tiny-batch deck thick enough for the creep bound
   (single_group.prm at N = 2048, X = 20.48), which must print JAX's df halo
   line, within DF_CLI_TOL of its CPU run; DFHaloCudaEngine against
   DFCudaEngine at gray_s8 for BDF2, BE and CN, 64 steps, ends, prev and
   half within DF_TOL in hi + lo (and whether every plane is bit-equal);
   then gray_s8 BDF2 through make_multichip_engine(engine="df"), which must
   pick DFHaloCudaEngine, timed as in phase 5, and on DFCudaEngine;
9. the adjoint path (B9 forward-with-records, B10 transposed step): B9 and
   B10 against their plain versions (planes and cbc <= 1e-5, gradient packs
   <= 1e-4 of their largest magnitude) for BE, CN and BDF2, reflective and
   source left, rows of 4 B9 tiles (13 B10 sub-tiles) and a ragged single
   tile; B9's step against B1's (B2's for BE/CN) at K = 1 (B1's tiles and
   arithmetic: held to 1e-6, bit-equality reported); a transposition check
   independent of the plain versions (with Sb = c0 = 0 and bc = 0 the step
   is a linear map A of the state: <c, A d> = <B10(c), d> within 1e-5, for
   random d and c = A d); make_diff_solve_cuda(steps_per_launch=1)
   gradients on the card against the same call on the CPU (gray
   off-equilibrium, M = 4, N = 4096, 8 steps: value 1e-5, kappa 2e-3,
   psi_source 1e-4); then the path at benchmarks/adjoint_bench.py's chip
   shape (gray S_32, N = 2^17, BDF2, 96 steps): value_and_grad of
   sum(ends^2) * 1e-3 through make_diff_solve_cuda at K = 1 against the
   same 96 steps forward on CudaSweepEngine at its K, three CUDA-event
   windows each, the grad/forward ratio and peak device memory;
10. the K-fused adjoint (B11 K-step forward with records, B12 transposed
   K-step launch): B11 and B12 against their plain versions (the
   intermediate inputs with the planes; bars as phase 9) at K = 2, 3 and 4,
   reflective and source left, both half modes, a 13-tile row with a ragged
   last tile (N = 52736), 4-tile rows (N = 12800, one at K = 2), N = 5000
   and N = 100; B11 against B1 at the same K (all six planes bit-equal),
   B11's records and intermediate inputs against K chained B9 launches
   (reported); the transposition check <c, A d> = <B12(c), d> within 1e-5;
   K-fused against K = 1 gradients on the card within 1e-4 (JAX's
   test_kfused_gradients_match_k1 at N = 4096) and remat groups of K-step
   launches against none within 1e-4; card against CPU gradients at the
   K-fused default at phase 9's bars; the adjoint bench in turns: the
   forward, value_and_grad at K = 1 and at the K-fused default (K = 4),
   printed as fwd_seconds, grad_k1_seconds, grad_kfused_seconds and both
   ratios to the forward, with the K-fused step's peak memory; and 3
   fit_params(solver="pallas") iterations at that shape on the K-fused
   default (the off-equilibrium boundary source from 20% above it, the
   loss scaled to 1 at the start), every loss finite.

Phase 3 also holds B4 and B5 against their plain versions (rows 2 and 8, a
segment and a reset cell off the kernel's tile, reset 0 and > 0, K 1/3/8
and 16 for BE/CN, both half modes), and B6 and B7 against theirs to
DF_TOL in hi + lo (B6 with both half modes, reflective and source left, K 1,
3 and the engine's, on an N off the kernel's tile and on N = 100; B7 BE and
CN with K 1, reflective and source left, and K 8). Every kernel wrapper's
launch count is zeroed before a path's phases and read after them: each
kernel of a path must have launched on it (B1-B3 on phases 4-5, B4-B5 on
phase 6, B6-B7 on phase 7, B14-B15 on phase 8, B9-B10 on phase 9,
B11-B12 on phase 10's K-fused grad steps and fit).
Then each kernel is timed against its plain version at its full-size shape,
beside its bound (the larger of the bytes it must move over 3.35 TB/s and
the operations it must do over 67 TFLOP/s f32, the H100 SXM data-sheet
peaks). The last lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
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
}
# The kernels each path must launch.
PATH_PLAIN = ("bdf2_launch", "multistep_launch", "substep_launch")
PATH_AUTO = ("halo_bdf2_launch", "halo_multistep_launch")
PATH_DF = ("df_bdf2_launch", "df_multistep_launch")
PATH_DF_HALO = ("df_halo_bdf2_launch", "df_halo_multistep_launch")
PATH_ADJ = ("fwd_record_launch", "bwd_launch")
PATH_ADJ_K = ("fwd_record_k_launch", "bwd_k_launch")
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
# solve 16, the residual 104, the correction solve 16, the renormalisation
# 12; the correction source adds 32 where use_correction is set. The scan
# work (a^n products, shuffles) and the integer masks are not counted.
DF_FLOPS_PER_CELL = {"BE": 192, "CN": 258, "BDF": 374}
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


def df_step_flops(ts_method: int, use_corr: bool) -> int:
    """Operations per cell of one double-float timestep."""
    phases = (("BE", "CN", "BE", "BDF") if ts_method == 3 else
              ("BE",) if ts_method == 1 else ("CN",))
    return sum(DF_FLOPS_PER_CELL[p] + DF_CORR_FLOPS * use_corr
               for p in phases)


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
                r"((?:df_)?(?:halo_)?(?:bdf2|multistep|substep)"
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
    from radiative_transfer_tpu_torch import cli, constants, load_config
    from radiative_transfer_tpu_torch.config.config import Config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import _cuda_build
    from radiative_transfer_tpu_torch.ops import cuda_adjoint as ca
    from radiative_transfer_tpu_torch.ops import cuda_df as cd
    from radiative_transfer_tpu_torch.ops import cuda_sweep as cs
    from radiative_transfer_tpu_torch.ops.fast_sweep import (BDF, BE, CN,
                                                             FlatState)

    dev = torch.device("cuda")
    card = card_line()

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

    def engine(cfg, **kw):
        tables, _, _ = transport.build_tables(cfg)
        return cs.CudaSweepEngine(cfg, tables, device=dev, **kw)

    def rand_state(eng, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        base = eng.init_state().e0
        return FlatState(*[
            (base * (0.5 + torch.rand(base.shape, generator=g, device=dev)))
            .contiguous() for _ in range(6)])

    def bdf2_plain(eng, st, K):
        """The plain B1 launch, as the engine's FlatState."""
        e0, e1, h0, h1, p0, p1 = cs.bdf2_launch_ref(
            eng.coef[BE], eng.coef[CN], eng.coef[BDF], eng.bc,
            eng.flip, st.e0, st.e1, K=K, s_be=eng.kcs[BE].s,
            s_cn=eng.kcs[CN].s, s_bdf=eng.kcs[BDF].s,
            reflective=eng.reflective,
            symmetric_half=eng.cfg.bdf2_symmetric_half, blk=eng.block,
            npass_be=eng.scan_npass[BE], npass_cn=eng.scan_npass[CN],
            npass_bdf=eng.scan_npass[BDF])
        return FlatState(e0, e1, p0, p1, h0, h1)

    def multistep_plain(eng, st, K):
        kind = BE if eng.cfg.ts_method == 1 else CN
        return cs.multistep_launch_ref(
            kind, eng.coef[kind], eng.bc, eng.flip, st.e0, st.e1,
            K=K, s=eng.kcs[kind].s, reflective=eng.reflective,
            blk=eng.block, npass=eng.scan_npass[kind])

    def substep_planes(kind, st):
        return {BE: (st.e0, st.e1), CN: (st.e0, st.e1, st.p1),
                BDF: tuple(st)}[kind]

    def substep_plain(eng, kind, st):
        return cs.substep_launch_ref(
            kind, eng.coef[kind], eng.bc, eng.flip,
            substep_planes(kind, st), s=eng.kcs[kind].s,
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

    eng = mg(3, reflective=True)
    for kind, label in ((BE, "BE"), (CN, "CN"), (BDF, "BDF")):
        st = rand_state(eng, kind)
        check("substep_launch", f"B3-{label}", eng.substep(kind, st),
              substep_plain(eng, kind, st))
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
    for ts_method, label in ((1, "BE"), (2, "CN")):
        for K, refl in ((1, True), (1, False), (8, False)):
            e = dmg(ts_method, refl)
            ins = df_rand(e, 50 + K)
            df_check("df_multistep_launch",
                     f"B7-{label}-K{K}-{'refl' if refl else 'src'}",
                     df_launch(e, ins, K), df_launch(e, ins, K, plain=True))
    torch.cuda.synchronize()
    print(f"phase 3 kernel parity: ok, max normalised error "
          + ", ".join(checks), flush=True)

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
                       cd if name.startswith("df_") else cs, name)

    def read_counts(path, label):
        counts = {name: wrapper(name).launches for name in path}
        missing = [name for name, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels not launched on {label}: "
                                 f"{missing} ({counts})")
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

    # -- 5. full size ------------------------------------------------------------
    C = constants.SPEED_OF_LIGHT

    def gray_cfg(M, N, ts_method, steps=64):
        """bench.py's and benchmarks/suite.py's gray workload: S_M, one
        group, cell Courant 0.4, reflective left, source right."""
        return Config(
            M=M, G=1, N=N, X=1.0, bc_left_indicator=2, bc_right_indicator=1,
            psi_source=tuple((4.0931,) for _ in range(M)),
            rho=1.0, kappa_grey=1.0, T=1.0, ts_method=ts_method,
            dt=0.4 * (1.0 / N) / C, max_timesteps=steps,
            include_validation=False)

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

    launches = read_counts(PATH_PLAIN, "the main path (phases 4-5)")

    plain_ms, _ = timed(lambda: bdf2_plain(big, st, K), 1)
    print(f"phase 5 full size: gray S_32 N=2^20 BDF2 K={K} block "
          f"{big.block}: {steps} steps in {seconds:.4f} s (median of "
          f"{fmt_windows(windows)}) = {rate:.6g} "
          f"updates/s; plain version {plain_ms:.1f} ms per K-step launch; "
          f"peak device memory {peak_gib:.3f} GiB above the phase's start; "
          f"max|x| ok; card: {card}",
          flush=True)

    # -- 6. tiny-batch auto route ------------------------------------------------
    from radiative_transfer_tpu_torch.parallel import make_multichip_engine
    from radiative_transfer_tpu_torch.parallel.halo_cuda import HaloCudaEngine

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

    pairs = []
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
        pairs.append(f"{label} K={he.K_launch} H={he.H} block {he.block} "
                     f"ends/prev/half {max(errs):.1e}")

    halo = auto_engine(gray_cfg(Ms, Ns, 3))
    Kh = halo.K_launch
    peak = peak_from()
    h_seconds, h_windows, hst = windows_of(
        lambda s, n: halo.solve(s, num_steps=n), halo.init_state(), 2 * Kh)
    h_peak = peak()
    launches.update(read_counts(PATH_AUTO, "the auto route (phase 6)"))

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
    ups = 4 * Ms * Ns * 64
    print(f"phase 6 auto route: ok; {cli_summary}; gray_s8 vs "
          f"CudaSweepEngine 64 steps: {'; '.join(pairs)}; gray_s8 BDF2 "
          f"(S_8, Bh=4, N=2^18) via auto = HaloCudaEngine K={Kh} H={halo.H}: "
          f"64 steps in {h_seconds:.4f} s (median of {fmt_windows(h_windows)})"
          f" = {ups / h_seconds:.6g} updates/s, peak device memory "
          f"{h_peak:.3f} GiB above the run's start, main launch {main_ms:.3f} ms, fixup launch "
          f"{fix_ms:.3f} ms; CudaSweepEngine K={K8}: 64 steps in "
          f"{p_seconds:.4f} s (median of {fmt_windows(p_windows)}) = "
          f"{ups / p_seconds:.6g} updates/s, peak {p_peak:.3f} GiB; halo/plain "
          f"{p_seconds / h_seconds:.3f}x; card: {card}", flush=True)

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
    _, Kd8, d8_seconds, d8_windows, d8_peak = df_timed(gray_cfg(Ms, Ns, 3))
    launches.update(read_counts(PATH_DF, "the f64-grade path (phase 7)"))
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
          f"updates/s, peak {d8_peak:.3f} GiB; card: {card}", flush=True)

    # -- 8. f64 tiny-batch route ---------------------------------------------
    from radiative_transfer_tpu_torch.parallel.df_halo_cuda import (
        DFHaloCudaEngine)

    # B14/B15 on packed rows (2*Bh, 12800) against their plain versions, in
    # hi + lo. Blocks of 1280 cells: reset 3 restarts the chains at cell
    # 3840, inside the second 2048-cell df tile, and leaves an 8960-cell
    # segment (4 tiles and a ragged 768) whose first tile is mid-row: the
    # K = 1 cases run one sub-step a tile there, where a slot read before
    # its barrier would show.
    n_checks = len(checks)
    for Mr, Gr in ((2, 1), (8, 4)):
        e = df_engine(load_config(deck, M=Mr, G=Gr, N=12800, ts_method=3))
        rows = 2 * e.Bh
        coef = {k: c.reshape(rows, -1) for k, c in e.coef.items()}
        dcoef = {k: c.reshape(rows, -1) for k, c in e.dcoef.items()}
        npass = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), hblk, 1e-10)
                 for k in e.kcs}
        npass_c = {k: cs._scan_npass(float(np.max(e.kcs[k].a)), hblk,
                                     cd.CORR_SCAN_TOL) for k in e.kcs}
        g = torch.Generator(device=dev).manual_seed(100 + rows)
        ins = [p.reshape(rows, -1) for p in df_rand(e, 60 + rows)]

        def df_seeds(C):
            # (hi, lo): the row's scale times [0.5, 6.5), lo within an ulp.
            sh = (ins[0][:, :1] * (0.5 + 6 * torch.rand(
                (rows, C), generator=g, device=dev))).contiguous()
            return sh, (sh * (torch.rand(sh.shape, generator=g, device=dev)
                              - 0.5) * 2.0 ** -24).contiguous()

        for reset in (0, 3):
            for K, sym in ((1, False), (2, True)):
                args = (*(coef[k] for k in (BE, CN, BDF)),
                        *(dcoef[k] for k in (BE, CN, BDF)),
                        *df_seeds(4 * K), reset, *ins)
                kw = dict(K=K, symmetric_half=sym, use_corr=True, blk=hblk,
                          npass=npass, npass_c=npass_c)
                df_check("df_halo_bdf2_launch",
                         f"B14-rows{rows}-r{reset}-K{K}-"
                         f"{'sym' if sym else 'asym'}",
                         cd.df_halo_bdf2_launch(*args, **kw),
                         cd.df_halo_bdf2_launch_ref(*args, **kw))
            for kind, label in ((BE, "BE"), (CN, "CN")):
                for K in (1, 3):
                    args = (kind, coef[kind], dcoef[kind], *df_seeds(K),
                            reset, *ins)
                    kw = dict(K=K, use_corr=True, blk=hblk,
                              npass=npass[kind], npass_c=npass_c[kind])
                    df_check("df_halo_multistep_launch",
                             f"B15-{label}-rows{rows}-r{reset}-K{K}",
                             cd.df_halo_multistep_launch(*args, **kw),
                             cd.df_halo_multistep_launch_ref(*args, **kw))
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
    print(f"phase 8 f64 tiny-batch route: ok; kernel parity max hi+lo error "
          + ", ".join(halo_checks) + f"; {dh_cli} (prints '{halo_line}'); "
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
          f"{dp_seconds / dh_seconds:.3f}x; card: {card}", flush=True)

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

    n_checks = len(checks)
    adj_cases = [(3, True, False, 12800), (3, False, True, 12800),
                 (3, False, False, 12800), (3, True, True, 100),
                 (1, True, False, 12800), (1, False, False, 5000),
                 (2, False, False, 12800), (2, True, False, 12800)]
    b1_parity, b10_transposed = [], []
    for ts_method, refl, sym, Nx in adj_cases:
        # M = 8 x G = 4 (Bh = 16); N = 12800 is 3 full 4096-cell B9 tiles
        # and a ragged 512, 13 B10 sub-tiles of 1024 (plain versions: 25
        # blocks of 512); N = 5000 and 100 end mid-tile.
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
        one = e.multi_step(FlatState(e0, e1, e0, e1, e0, e1), 1)
        ref1 = ((one.e0, one.e1, one.h0, one.h1) if ts_method == 3
                else (one.e0, one.e1))
        err1 = max(nerr(g, r) for g, r in zip(fk, ref1))
        same = all(torch.equal(g, r) for g, r in zip(fk, ref1))
        b1_parity.append(f"{label}={err1:.1e}{' bit-equal' if same else ''}")
        if not err1 <= 1e-6:
            raise AssertionError(f"B9 {label} against B1/B2 at K = 1: "
                                 f"{err1:.3e} > 1e-6")
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
    print(f"phase 9 adjoint path: ok; kernel parity max normalised error "
          + ", ".join(adj_checks) + "; B9 vs B1/B2 at K = 1: "
          + ", ".join(b1_parity) + "; transposition <c,A d> vs <B10 c,d>: "
          + ", ".join(b10_transposed) + f"; make_diff_solve_cuda card vs CPU "
          f"(gray M=4 N=4096 8 steps): value {v_err:.1e}, kappa {k_err:.1e}, "
          f"psi_source {s_err:.1e}; adjoint bench (gray S_32, N=2^17, BDF2, "
          f"{na} steps): value_and_grad at K = 1 in {g_seconds:.4f} s (median "
          f"of {fmt_windows(g_windows)}), peak device memory {g_peak:.3f} GiB "
          f"above its start; forward on CudaSweepEngine K={Ka} in "
          f"{f_seconds:.4f} s (median of {fmt_windows(f_windows)}), peak "
          f"{f_peak:.3f} GiB; grad/forward {g_seconds / f_seconds:.3f}; "
          f"card: {card}", flush=True)

    # -- 10. the K-fused adjoint ---------------------------------------------
    # B11/B12 against their plain versions, B11 against B1 at the same K (bit
    # for bit) and its records against K chained B9 launches (reported), and
    # the transposition check of the pair. M = 8 x G = 4 (Bh = 16); N =
    # 52736 is 13 B11 tiles (the last ragged, 3584 cells) and 52 B12
    # sub-tiles (plain versions: 103 blocks of 512); N = 12800 4 tiles and 13
    # sub-tiles (plain: 25 blocks); N = 5000 and 100 end mid-tile.
    n_checks = len(checks)
    kf_cases = [(True, False, 3, 52736), (False, True, 2, 12800),
                (True, True, 4, 12800), (False, False, 4, 5000),
                (True, False, 2, 100)]
    b1k_parity, b9k_records, k_transposition = [], [], []
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
        one = e.multi_step(FlatState(e0, e1, e0, e1, e0, e1), Kk)
        if not all(torch.equal(g, r) for g, r in zip(
                fk[:6], (one.e0, one.e1, one.h0, one.h1, one.p0, one.p1))):
            raise AssertionError(f"B11 {label}: not bit-equal to B1 at "
                                 f"K = {Kk}")
        b1k_parity.append(f"{label} bit-equal")
        # K chained B9 launches: their records and intermediate inputs.
        ins, recs = [(e0, e1)], []
        for _ in range(Kk):
            o = ca.fwd_record_launch(*co, e.bc, e.flip, *ins[-1], **geo)
            recs.append(o[4:])
            ins.append(o[:2])
        chained = (torch.cat([r[0] for r in recs], 1),
                   torch.stack([r[1] for r in recs], 1),
                   torch.stack([r[2] for r in recs], 1),
                   *(torch.stack([x[i] for x in ins[1:Kk]]) for i in (0, 1)))
        diff = max(float((a - b).abs().max())
                   for a, b in zip(fk[6:], chained))
        b9k_records.append(f"{label} " + ("bit-equal" if diff == 0.0 else
                                          f"max|diff| {diff:.1e}"))
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
    bench = {"fwd_seconds": f2_seconds, "grad_k1_seconds": g1_seconds,
             "grad_kfused_seconds": gk_seconds,
             "grad_k1_vs_fwd": g1_seconds / f2_seconds,
             "grad_kfused_vs_fwd": gk_seconds / f2_seconds,
             "grad_kfused_peak_gib": gk_peak}
    print(f"phase 10 K-fused adjoint: ok; kernel parity max normalised error "
          + ", ".join(kf_checks) + "; B11 vs B1 at the same K: "
          + ", ".join(b1k_parity) + "; B11 records vs K chained B9: "
          + ", ".join(b9k_records) + "; transposition <c,A d> vs "
          "<B12 c,d>: " + ", ".join(k_transposition) + f"; K-fused vs K = 1 "
          f"gradients (N=4096, 9 steps, K=4, reflective) {kvk1:.1e}, remat "
          f"vs none (17 steps, groups of 2 launches) {remat_err:.1e}; card vs "
          f"CPU at the K-fused default: value {kv_err:.1e}, kappa "
          f"{kk_err:.1e}, psi_source {ks_err:.1e}; adjoint bench (gray S_32, "
          f"N=2^17, BDF2, {na} steps) " + json.dumps(bench) + " (K-fused "
          f"windows {fmt_windows(gk_windows)}); fit_params 3 iterations on "
          f"the K-fused default, losses "
          + ", ".join(f"{x:.6g}" for x in fit_hist)
          + f" (x {float(loss_0):.6g}), mu<0 source 2.4 -> "
          f"{float(fit_p['psi_source'][0, 0]):.6g}; card: {card}",
          flush=True)


    # -- kernel vs plain at the full-size shapes (not counted above) ------------
    # Bytes: each input read once, each output written once (a record the
    # kernel only passes between its own launches is not counted; the halo
    # kernels read seeds and write a record of the same shape).
    table = []
    cn_eng = engine(gray_cfg(M, N, 2))
    Kcn = cn_eng.max_steps_per_launch()
    rs = rand_state(big, 99)
    rcn = rand_state(cn_eng, 98)
    consts = (big.coef[BE], big.coef[CN], big.coef[BDF], big.bc, big.flip)
    planes = 2 * big.Bh * N * 4            # bytes of one (2, Bh, N) plane
    cells = 2 * big.Bh * N

    # B5 at gray_s8 CN: its main launch over H + N packed cells.
    halo_cn = auto_engine(gray_cfg(Ms, Ns, 2))
    Kc5 = halo_cn.K_launch
    g5 = torch.Generator(device=dev).manual_seed(97)
    xc = [torch.cat([p.new_zeros((2, halo_cn.Bh, halo_cn.H)), p], -1)
          .reshape(halo_cn.rows, -1)
          * (0.5 + torch.rand((halo_cn.rows, halo_cn.H + Ns), generator=g5,
                              device=dev))
          for p in halo_cn.init_state()[:2]]
    s5 = halo_cn._main_seeds(Kc5)
    b5_args = (CN, halo_cn.coef[CN], s5, halo_cn.hb, *xc)
    b5_kw = dict(K=Kc5, blk=halo_cn.block, npass=halo_cn.scan_npass[CN])
    # B4 at gray_s8 BDF2: the main launch timed above, on random planes.
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
    # CN, each over H + N packed cells on random double-float planes: 4
    # planes in, 12 (B14) or 8 (B15) out, (hi, lo) seeds in, a record out.
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

    b14_args = (*(dhalo.coef[k] for k in (BE, CN, BDF)),
                *(dhalo.dcoef[k] for k in (BE, CN, BDF)), *dseeds, dhalo.hb,
                *df_packed(dhalo, 94))
    b14_kw = dict(K=Kdh, symmetric_half=False, use_corr=use_corr,
                  blk=dhalo.block, npass=dhalo.scan_npass,
                  npass_c=dhalo.corr_npass)
    dhalo_cn = df_auto(gray_cfg(Ms, Ns, 2))
    Kdc15 = dhalo_cn.K_launch
    b15_args = (CN, dhalo_cn.coef[CN], dhalo_cn.dcoef[CN],
                *dhalo_cn._main_seeds(Kdc15), dhalo_cn.hb,
                *df_packed(dhalo_cn, 93))
    b15_kw = dict(K=Kdc15, use_corr=use_corr, blk=dhalo_cn.block,
                  npass=dhalo_cn.scan_npass[CN],
                  npass_c=dhalo_cn.corr_npass[CN])

    # B9 and B10 at the adjoint bench shape (gray S_32, N = 2^17, BDF2, the
    # reflective two-launch coupling), one step on a random state: B9 reads
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
    ]
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
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": REPLACES[name],
                      "launches": launches[name], "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      # No single PyTorch call computes this affine
                      # recurrence with its 2x2 reconstruction (nor its
                      # transpose).
                      "library_ms": None})
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
