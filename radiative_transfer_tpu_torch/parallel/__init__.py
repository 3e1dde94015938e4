"""Engine selection and the packed-rows halo engines (parallel/halo_cuda.py,
parallel/df_halo_cuda.py).

Port of the single-device branch of
radiative_transfer_tpu/parallel/__init__.py. The mesh engines (sharded,
halo exchange over NCCL) are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import inspect

from . import df_halo_cuda, halo_cuda


def _filter_kwargs(ctor, kw):
    """Keep only kwargs `ctor` accepts (selection crosses engines whose
    signatures differ, e.g. steps_per_launch is halo-only)."""
    accepted = inspect.signature(ctor).parameters
    return {k: v for k, v in kw.items() if k in accepted}


def make_multichip_engine(cfg, tables, mesh=None, engine: str = "auto",
                          **kw):
    """The engine for `cfg` on one device (pass `device=` among `kw`).

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

    Two rules of the JAX selection do not carry over: off a TPU it picks
    its XLA FastEngine (that rule exists because Pallas off a TPU is an
    interpreter; the port routes the same on the CPU as on the card), and
    for an odd N whose whole-N block exceeds TPU VMEM it falls back to
    FastEngine (the CUDA kernels tile any N, so CudaSweepEngine stays;
    likewise DFCudaEngine for ``df`` where the JAX CLI's auto at float64
    checks ``whole_n_feasible``). The halo engines' block walks also drop
    the Mosaic "block % 128" rule, which JAX applies only off its
    interpreter.
    """
    from ..ops.cuda_df import DFCudaEngine
    from ..ops.cuda_sweep import CudaSweepEngine

    if mesh is not None:
        raise NotImplementedError(
            "mesh engines are not ported yet (ROADMAP A11); pass mesh=None")
    if engine not in ("auto", "single", "halo", "df"):
        raise ValueError(f"unknown engine {engine!r} (auto, single, halo, "
                         "df)")
    tiny = (cfg.M // 2) * cfg.G < 8
    if engine == "df":
        if tiny:
            DFHalo = df_halo_cuda.DFHaloCudaEngine
            try:
                return DFHalo(cfg, tables,
                              **_filter_kwargs(DFHalo.__init__, kw))
            except ValueError:
                pass  # infeasible (creep bound / odd N): plain df kernel
        return DFCudaEngine(cfg, tables,
                            **_filter_kwargs(DFCudaEngine.__init__, kw))
    hkw = _filter_kwargs(halo_cuda.HaloCudaEngine.__init__, kw)
    if engine == "halo":
        return halo_cuda.HaloCudaEngine(cfg, tables, **hkw)
    if engine == "auto" and tiny:
        try:
            return halo_cuda.HaloCudaEngine(cfg, tables, **hkw)
        except ValueError:
            pass  # infeasible (creep bound / odd N): plain engine
    return CudaSweepEngine(cfg, tables,
                           **_filter_kwargs(CudaSweepEngine.__init__, kw))
