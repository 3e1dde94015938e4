"""Profiling and tracing: wall-clock step metrics and device traces.

Port of radiative_transfer_tpu/utils/profiling.py. The reference has no
timing instrumentation at all (its solve loop, reference:
src/solver.cpp:590-823, prints only progress banners). Here per-step
wall-clock and the cell-angle-group updates/s rate are first-class:

* `StepMetrics`: accumulate per-chunk timings, report mean ms/step and
  updates/s (the CLI's --balance-every lines);
* `trace(logdir, device)`: a context manager around torch.profiler that
  writes a Chrome trace (chrome://tracing or https://ui.perfetto.dev) of
  the host and, on the card, of every kernel CUPTI sees;
* `measure_solve`: best-of-N wall-clock of a solve, warm-up excluded.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


def updates_per_step(cfg) -> int:
    """Cell-angle-group sub-updates in ONE full timestep: BDF2 runs 4
    sub-steps (solver.cpp:700-811), BE/CN one."""
    subs = 4 if cfg.ts_method == 3 else 1
    return subs * cfg.M * cfg.G * cfg.N


@dataclass
class StepMetrics:
    """Wall-clock accumulator for chunked solve loops."""

    updates_per_step: int
    steps: int = 0
    seconds: float = 0.0
    chunks: List[float] = field(default_factory=list)

    def add(self, steps: int, seconds: float) -> None:
        self.steps += steps
        self.seconds += seconds
        self.chunks.append(seconds)

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.seconds / max(self.steps, 1)

    @property
    def updates_per_s(self) -> float:
        return self.updates_per_step * self.steps / max(self.seconds, 1e-12)

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.seconds:.3f} s "
            f"({self.ms_per_step:.3f} ms/step, "
            f"{self.updates_per_s / 1e6:.1f} M updates/s)"
        )


def trace_path(logdir: str) -> str:
    """The Chrome trace `trace` writes for this process: one file a rank
    of the process group."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    return os.path.join(logdir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cuda"):
    """torch.profiler over the block, written as a Chrome trace to
    trace_path(logdir) on exit (a no-op when logdir is None). It records
    the host's operators and, when `device` is a CUDA device, every
    kernel on the card through CUPTI, the kernels the ctypes wrappers
    launch included. Yields the profiler (None when off)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(trace_path(logdir))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure_solve(run, state, repeats: int = 3):
    """Best-of-N wall-clock of `run(state)` with the warm-up (the kernels'
    first load and build) excluded. Every timed repeat runs from the SAME
    input, so the returned result is exactly one application of `run`;
    each ends in torch.cuda.synchronize() where there is a card. Returns
    (result, best_seconds)."""
    out = run(state)  # warm-up
    _sync()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = run(state)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return out, best
