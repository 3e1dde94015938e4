"""Engine selection and the packed-rows halo engine (parallel/halo_cuda.py).

Port of the single-device branch of
radiative_transfer_tpu/parallel/__init__.py. The mesh engines (sharded,
halo exchange over NCCL) are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import inspect

from . import halo_cuda


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
    * ``df``: the f64-grade DFCudaEngine (double-float kernels B6-B7),
      the CLI's ``--engine auto`` pick at float64.

    Two rules of the JAX selection do not carry over: off a TPU it picks
    its XLA FastEngine (that rule exists because Pallas off a TPU is an
    interpreter; the port routes the same on the CPU as on the card), and
    for an odd N whose whole-N block exceeds TPU VMEM it falls back to
    FastEngine (the CUDA kernels tile any N, so CudaSweepEngine stays;
    likewise DFCudaEngine for ``df`` where the JAX CLI's auto at float64
    checks ``whole_n_feasible``). And for ``df`` at tiny batches (Bh < 8)
    JAX tries its packed-rows DFHaloEngine at a 1-device mesh, whose
    kernels B14-B15 are not ported: the port stays on DFCudaEngine there.
    The two compute the same cells bit for bit (docs/PERFORMANCE.md), so
    only the speed differs, until B14-B15 land.
    """
    from ..ops.cuda_df import DFCudaEngine
    from ..ops.cuda_sweep import CudaSweepEngine

    if mesh is not None:
        raise NotImplementedError(
            "mesh engines are not ported yet (ROADMAP A11); pass mesh=None")
    if engine not in ("auto", "single", "halo", "df"):
        raise ValueError(f"unknown engine {engine!r} (auto, single, halo, "
                         "df)")
    if engine == "df":
        return DFCudaEngine(cfg, tables,
                            **_filter_kwargs(DFCudaEngine.__init__, kw))
    hkw = _filter_kwargs(halo_cuda.HaloCudaEngine.__init__, kw)
    if engine == "halo":
        return halo_cuda.HaloCudaEngine(cfg, tables, **hkw)
    if engine == "auto" and (cfg.M // 2) * cfg.G < 8:
        try:
            return halo_cuda.HaloCudaEngine(cfg, tables, **hkw)
        except ValueError:
            pass  # infeasible (creep bound / odd N): plain engine
    return CudaSweepEngine(cfg, tables,
                           **_filter_kwargs(CudaSweepEngine.__init__, kw))
