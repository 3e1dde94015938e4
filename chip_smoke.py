#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, one line each; any failure exits nonzero before the result line:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compile csrc/*.cu with nvcc for sm_90a (radiative_transfer_tpu_torch
   /_build/) and print its seconds and the compiler's register report;
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
   the peak device memory.

Every kernel wrapper's launch count is zeroed before phase 4 and read after
phase 5: each kernel must have launched on the main path. Then each kernel is
timed against its plain version at the full-size shape. The last lines are
the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
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
SOURCE = "radiative_transfer_tpu_torch/csrc/sweep.cu"
REPLACES = {
    "bdf2_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:444",
    "multistep_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:387",
    "substep_launch": "radiative_transfer_tpu/ops/pallas_sweep.py:229",
}


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
            k = re.search(r"(bdf2|multistep|substep)_kernel(?:ILi(\d)E)?",
                          m.group(1))
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


def nerr(got, ref) -> float:
    """max|got - ref| / max|ref|, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from radiative_transfer_tpu_torch import cli, constants, load_config
    from radiative_transfer_tpu_torch.config.config import Config
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.ops import _cuda_build
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
    print(f"phase 2 build: {build_s:.1f} s; ptxas: "
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
    torch.cuda.synchronize()
    print(f"phase 3 kernel parity: ok, max normalised error "
          + ", ".join(checks), flush=True)

    # -- 4. main path ------------------------------------------------------------
    cs.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:

        def run_cli(deck_path, steps, device, tag):
            outdir = os.path.join(tmp, f"{tag}_{device}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([deck_path, "--outdir", outdir, "--engine",
                               "pallas", "--steps", str(steps), "--device",
                               device, "--profile"])
            if rc != 0:
                raise RuntimeError(f"cli {tag} {device} exit {rc}:\n"
                                   + buf.getvalue()[-3000:])
            profile = [ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("wall:")]
            return outdir, profile[0] if profile else ""

        def variant(ts_method):
            text = open(os.path.join(ROOT, "prm", "single_group.prm")).read()
            if "ts_method=3" not in text:
                raise RuntimeError("single_group.prm no longer says ts_method=3")
            path = os.path.join(tmp, f"single_group_ts{ts_method}.prm")
            with open(path, "w") as fh:
                fh.write(text.replace("ts_method=3", f"ts_method={ts_method}"))
            return path

        names = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
                 "right_ends")
        runs = [(os.path.join(ROOT, "prm", "llnl_slab_test.prm"), 2, "llnl"),
                (os.path.join(ROOT, "prm", "single_group.prm"), 200, "gray"),
                (variant(1), 200, "gray-BE"), (variant(2), 200, "gray-CN")]
        summary = []
        for deck_path, steps, tag in runs:
            gpu_dir, profile = run_cli(deck_path, steps, "cuda", tag)
            cpu_dir, _ = run_cli(deck_path, steps, "cpu", tag)
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
                if not err <= DRIFT_TOL:
                    raise AssertionError(f"{tag} {name}.csv: GPU vs CPU "
                                         f"normalised error {err:.3e} > "
                                         f"{DRIFT_TOL}")
            summary.append(f"{tag} {steps} steps 8 CSVs finite, vs CPU "
                           f"{worst_csv:.1e} [{profile}]")
        for ts_method in (1, 2):
            e = engine(load_config(variant(ts_method)))
            st = e.init_state()
            for _ in range(5):
                st = e.step(st)
            if not bool(torch.isfinite(e.ends(st)).all()):
                raise AssertionError(f"step() ts_method={ts_method} not finite")
        torch.cuda.synchronize()
        print("phase 4 main path: ok; " + "; ".join(summary), flush=True)

    # -- 5. full size ------------------------------------------------------------
    M, G, N, steps = 32, 1, 1 << 20, 64
    C = constants.SPEED_OF_LIGHT

    def bench_cfg(ts_method):
        return Config(
            M=M, G=G, N=N, X=1.0, bc_left_indicator=2, bc_right_indicator=1,
            psi_source=tuple(tuple(4.0931 for _ in range(G))
                             for _ in range(M)),
            rho=1.0, kappa_grey=1.0, T=1.0, ts_method=ts_method,
            dt=0.4 * (1.0 / N) / C, max_timesteps=steps,
            include_validation=False)

    big = engine(bench_cfg(3))
    K = big.max_steps_per_launch()
    torch.cuda.reset_peak_memory_stats()
    # Warm-up: two launches, so the caching allocator already holds every
    # plane the timed solves allocate (no cudaMalloc inside a window).
    st = big.solve(big.init_state(), num_steps=2 * K, steps_per_launch=K)
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        st = big.solve(st, num_steps=steps, steps_per_launch=K)
        stop.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(stop) / 1e3)
    seconds = sorted(windows)[1]
    for plane in st:
        m = float(plane.abs().max())
        if not np.isfinite(m) or m > 1e3:
            raise AssertionError(f"full-size state diverged (max|x|={m})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rate = 4 * M * G * N * steps / seconds

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

    launches = {name: getattr(cs, name).launches for name in REPLACES}
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({launches})")

    plain_ms, _ = timed(lambda: bdf2_plain(big, st, K), 1)
    print(f"phase 5 full size: gray S_32 N=2^20 BDF2 K={K} block "
          f"{big.block}: {steps} steps in {seconds:.4f} s (median of "
          f"{', '.join(f'{w:.4f}' for w in windows)}) = {rate:.6g} "
          f"updates/s; plain version {plain_ms:.1f} ms per K-step launch; "
          f"peak device memory {peak_gib:.2f} GiB; max|x| ok; card: {card}",
          flush=True)

    # -- kernel vs plain at the full-size shape (not counted above) ------------
    rows = []
    cn_eng = engine(bench_cfg(2))
    Kcn = cn_eng.max_steps_per_launch()
    rs = rand_state(big, 99)
    rcn = rand_state(cn_eng, 98)
    jobs = [
        ("bdf2_launch", lambda: big.multi_step(rs, K),
         lambda: bdf2_plain(big, rs, K), 20),
        ("multistep_launch", lambda: cn_eng.multi_step(rcn, Kcn)[:4],
         lambda: multistep_plain(cn_eng, rcn, Kcn), 10),
        ("substep_launch", lambda: big.substep(BDF, rs),
         lambda: substep_plain(big, BDF, rs), 50),
    ]
    for name, kernel_fn, plain_fn, reps in jobs:
        ms, got = timed(kernel_fn, reps)
        pms, ref = timed(plain_fn, 1)
        err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, ref))
        norm = max(nerr(g, r) for g, r in zip(got, ref))
        if not norm <= TOL:
            raise AssertionError(f"{name} full size: normalised error "
                                 f"{norm:.3e} > {TOL}")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": launches[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
