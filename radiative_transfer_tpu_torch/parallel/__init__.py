"""Engine selection, the mesh and its engines.

Port of radiative_transfer_tpu/parallel/__init__.py on torch.distributed:
the packed-rows halo engines (parallel/halo_cuda.py,
parallel/df_halo_cuda.py), the per-sub-step mesh engine
(parallel/sharded_cuda.py), the single-exchange fused BDF2 mesh engine
(parallel/fused_exchange_cuda.py), the general engine on a mesh
(parallel/sharded.py, solve_sharded: the JAX general ShardedEngine), the
XLA fast engine's port and its mesh engine (ops/fast_sweep.FastEngine and
parallel/sharded_fast.ShardedFastEngine, plain PyTorch at float32 or
float64), the mesh (parallel/mesh.py) and the process-group helpers
(parallel/distributed.py).
"""

from __future__ import annotations

import inspect

from . import df_halo_cuda, halo_cuda


def _filter_kwargs(ctor, kw):
    """Keep only kwargs `ctor` accepts (selection crosses engines whose
    signatures differ, e.g. steps_per_launch is halo-only)."""
    accepted = inspect.signature(ctor).parameters
    return {k: v for k, v in kw.items() if k in accepted}


_ENGINES = ("auto", "single", "halo", "df", "df_halo", "pallas",
                 "fused", "fast")


def make_multichip_engine(cfg, tables, mesh=None, engine: str = "auto",
                          **kw):
    """The engine for `cfg` on `mesh` (parallel/mesh.py; None is one
    device), in JAX's order (pass `device=` among `kw`).

    Without a mesh, or at a one-rank mesh for ``auto``, ``single`` and
    ``df``:

    * ``auto``: the packed-rows HaloCudaEngine at tiny batches (Bh < 8),
      whose launches run both direction halves at once, when its creep
      bound admits the workload; else the plain CudaSweepEngine.
    * ``single``: the plain CudaSweepEngine.
    * ``halo``: HaloCudaEngine, raising ValueError with guidance where it
      is infeasible.
    * ``df``: the f64-grade selection, the CLI's ``--engine auto`` pick at
      float64: the packed-rows DFHaloCudaEngine (double-float kernels
      B14-B15) at tiny batches (Bh < 8) where its creep bound admits the
      workload, else the plain DFCudaEngine (B6-B7).
    * ``fast``: FastEngine (ops/fast_sweep.py, plain PyTorch at its
      ``dtype``), as the JAX package's solve_ensemble_stacked builds it
      without a mesh.

    With a mesh (the pinned mesh engines also at one rank, as JAX builds
    them at 1x1):

    * ``pallas``: ShardedCudaEngine (B8, one exchange a sub-step);
    * ``fused``: FusedExchangeCudaEngine (B13, one exchange a BDF2 step;
      ValueError for BE/CN);
    * ``halo``: HaloCudaEngine on the mesh; ``df_halo``: DFHaloCudaEngine
      on the mesh (both raise ValueError with guidance where infeasible);
    * ``df`` at more than one rank: DFHaloCudaEngine on the mesh;
    * ``auto`` at more than one rank: the halo engine where its creep
      bound admits the workload, else the fused engine at BDF2, else the
      sharded engine;
    * ``fast``: ShardedFastEngine (parallel/sharded_fast.py, plain
      PyTorch at its ``dtype``), also at one rank, as JAX builds it.

    Rules of the JAX selection that do not carry over: off a TPU it picks
    its XLA FastEngine (single device) or ShardedFastEngine (mesh), a rule
    that exists because Pallas off a TPU is an interpreter; the port
    routes the same on the CPU as on the card, without a mesh and with
    one. For an odd N whose whole-N block exceeds TPU VMEM it falls back
    to FastEngine (the CUDA kernels tile any N, so CudaSweepEngine stays;
    likewise DFCudaEngine for ``df`` where the JAX CLI's auto at float64
    checks ``whole_n_feasible``). The halo engines' block walks also drop
    the Mosaic "block % 128" rule, which JAX applies only off its
    interpreter.
    """
    from ..ops.cuda_df import DFCudaEngine
    from ..ops.cuda_sweep import CudaSweepEngine
    from .fused_exchange_cuda import FusedExchangeCudaEngine
    from .sharded_cuda import ShardedCudaEngine

    if mesh is None and engine not in ("auto", "single", "halo", "df",
                                       "fast"):
        raise ValueError(f"unknown engine {engine!r} without a mesh (auto, "
                         "single, halo, df, fast; pass a mesh for pallas, "
                         "fused and df_halo)")
    if engine not in _ENGINES:
        raise ValueError(f"unknown multi-chip engine {engine!r}")
    if engine == "fast":
        from ..ops.fast_sweep import FastEngine
        from .sharded_fast import ShardedFastEngine

        if mesh is not None:
            return ShardedFastEngine(cfg, tables, mesh, **_filter_kwargs(
                ShardedFastEngine.__init__, kw))
        return FastEngine(cfg, tables, **_filter_kwargs(FastEngine.__init__,
                                                        kw))
    n_dev = 1 if mesh is None else mesh.size
    tiny = (cfg.M // 2) * cfg.G < 8
    DFHalo, Halo = df_halo_cuda.DFHaloCudaEngine, halo_cuda.HaloCudaEngine

    def build(ctor):
        return ctor(cfg, tables, **_filter_kwargs(ctor.__init__,
                                                  dict(kw, mesh=mesh)))

    if engine == "df":
        if n_dev > 1:
            return build(DFHalo)
        if tiny:
            try:
                return build(DFHalo)
            except ValueError:
                pass  # infeasible (creep bound / odd N): plain df kernel
        return build(DFCudaEngine)
    if engine == "single" or (engine == "auto" and n_dev == 1):
        if engine == "auto" and tiny:
            try:
                return build(Halo)
            except ValueError:
                pass  # infeasible (creep bound / odd N): plain engine
        return build(CudaSweepEngine)
    if engine == "df_halo":
        return build(DFHalo)
    if engine == "halo":
        return build(Halo)
    if engine == "pallas":
        return build(ShardedCudaEngine)
    if engine == "fused":
        return build(FusedExchangeCudaEngine)
    try:
        return build(Halo)
    except ValueError:
        pass  # infeasible (creep bound / odd N): untruncatable fallbacks
    # Untruncatable BDF2 (the halo creep bound failed, e.g. the LLNL deck
    # at its shipped dt = 1e-3): one launch and one small all_gather a
    # whole step on the fused engine against four of each on the
    # per-sub-step engine.
    if cfg.ts_method == 3:
        try:
            return build(FusedExchangeCudaEngine)
        except ValueError:
            pass  # engine-specific limits; the last fallback says why
    return build(ShardedCudaEngine)
