"""Example 7: reference-grade precision at kernel rate, on the port.

The C++ reference computes everything in `double` and accepts results at
1e-6 absolute tolerances. This example runs the same gray transient four
ways and reports the drift against the f64 ground truth and the time of
each:

  * the f64 fast engine (ops/fast_sweep.FastEngine, plain PyTorch): the
    ground truth;
  * the f32 CUDA kernel (CudaSweepEngine, ~1e-6 drift);
  * the double-float CUDA kernel (DFCudaEngine, `--engine df`): f64-grade
    results from f32 arithmetic by in-kernel iterative refinement (drift
    ~1e-12);
  * the double-float halo engine (DFHaloCudaEngine) on a one-axis mesh of
    this process's ranks, f64-grade across the mesh.

Then it differentiates the solve at kernel rate: fit_params with
solver='pallas' recovers a perturbed opacity through the adjoint kernels
(ops/cuda_adjoint.py).

    python -m radiative_transfer_tpu_torch.examples.reference_precision \
        [--device cuda|cpu]

The size is the card's (N = 2^14, 400 steps) on cuda and a CPU's (N =
256, 40 steps) on cpu, where the kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import adjoint, load_config
from ..models import transport
from ..ops.cuda_df import DFCudaEngine
from ..ops.cuda_sweep import CudaSweepEngine
from ..ops.fast_sweep import FastEngine
from ..parallel import distributed
from ..parallel.df_halo_cuda import DFHaloCudaEngine
from ..parallel.mesh import make_mesh_1d
from ._common import add_device, deck, device_of, sync


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=None,
                    help="cells (default 2^14 on cuda, 256 on cpu)")
    ap.add_argument("--steps", type=int, default=None,
                    help="timesteps (default 400 on cuda, 40 on cpu)")
    ap.add_argument("--iters", type=int, default=60,
                    help="Adam iterations of the opacity fit")
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)
    on_card = dev.type == "cuda"
    N = args.N or (1 << 14 if on_card else 256)
    steps = args.steps or (400 if on_card else 40)
    cfg = load_config(deck("single_group.prm"), M=8, N=N, X=N * 0.01,
                      max_timesteps=steps)
    tables, _, _ = transport.build_tables(cfg)

    def timed(build, run):
        eng = build()
        run(eng)                             # kernel builds + warm-up
        sync(dev)
        t0 = time.perf_counter()
        st = run(eng)
        sync(dev)
        return eng, st, time.perf_counter() - t0

    def run64(eng):
        return eng.solve(num_steps=steps)

    # 1. f64 ground truth (the fast engine).
    fe, st64, t64 = timed(
        lambda: FastEngine(cfg, tables, dtype=torch.float64, device=dev),
        run64)
    ref = fe.ends(st64).cpu().numpy()
    scale = np.abs(ref).max()
    print(f"f64 fast engine: {t64 * 1e3:7.1f} ms   (ground truth)")

    def drift(eng, st):
        got = eng.ends(st).to(torch.float64).cpu().numpy()
        return float(np.abs(got - ref).max() / scale), got

    # 2. f32 CUDA kernel.
    pe, stf, tf = timed(lambda: CudaSweepEngine(cfg, tables, device=dev),
                        run64)
    drift_f, ends_f = drift(pe, stf)
    print(f"f32 kernel     : {tf * 1e3:7.1f} ms   drift {drift_f:.2e}")

    # 3. double-float kernel: f64-grade at kernel rate.
    de, std, td = timed(lambda: DFCudaEngine(cfg, tables, device=dev), run64)
    drift_d, ends_d = drift(de, std)
    print(f"double-float   : {td * 1e3:7.1f} ms   drift {drift_d:.2e}"
          f"   ({t64 / td:.1f}x the f64 engine)")

    # 3b. Reference precision at scale: the double-float halo engine shards
    # the same f64-grade solve over this process's ranks (one without a
    # launcher); shard-owned cells are bit-exact against the single-device
    # df kernel (parallel/df_halo_cuda.py).
    ranks = distributed.process_count()
    mesh = make_mesh_1d(ranks if cfg.N % ranks == 0 else 1)
    drift_h = ends_h = th = None
    try:
        he, sth, th = timed(
            lambda: DFHaloCudaEngine(cfg, tables, mesh=mesh, device=dev),
            run64)
        drift_h, ends_h = drift(he, sth)
        print(f"df halo mesh-{mesh.size}: {th * 1e3:7.1f} ms   "
              f"drift {drift_h:.2e}   (f64-grade across the mesh)")
    except ValueError as e:
        print(f"df halo: infeasible at this shape ({e})")

    # 4. Kernel-rate gradients: recover a perturbed opacity. The target
    # comes from a plain (non-differentiable) solve at the perturbed kappa.
    cfg_t = cfg.replace(kappa_grey=cfg.kappa_grey * 1.3, max_timesteps=8)
    tab_t, _, _ = transport.build_tables(cfg_t)
    fe_t = FastEngine(cfg_t, tab_t, dtype=torch.float64, device=dev)
    target_ends = fe_t.ends(fe_t.solve(num_steps=8))

    def loss(state, params):
        return torch.mean((state.ends - target_ends) ** 2)

    params, hist = adjoint.fit_params(
        cfg, tables, None, loss,
        {"kappa": np.asarray([cfg.kappa_grey])},
        num_steps=8, learning_rate=0.05, iterations=args.iters,
        solver="pallas", device=dev)
    kap = float(params["kappa"][0])
    target = cfg.kappa_grey * 1.3
    print(f"inverse opacity (solver='pallas'): recovered kappa = "
          f"{kap:.4f} (target {target:.4f}), "
          f"loss {hist[0]:.3e} -> {hist[-1]:.3e}")
    return {"rc": 0, "N": N, "steps": steps, "ms_f64": t64 * 1e3,
            "ms_f32": tf * 1e3, "ms_df": td * 1e3,
            "ms_df_halo": None if th is None else th * 1e3,
            "drift_f32": drift_f, "drift_df": drift_d,
            "drift_df_halo": drift_h, "mesh": mesh.size,
            "kappa": kap, "kappa_target": target, "loss": hist,
            "ends_f64": ref, "ends_f32": ends_f, "ends_df": ends_d,
            "ends_df_halo": ends_h}


if __name__ == "__main__":
    sys.exit(main()["rc"])
