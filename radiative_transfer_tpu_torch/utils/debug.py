"""Numeric guards: the functional replacement for the reference's asserts.

Port of radiative_transfer_tpu/utils/debug.py. The reference guards its
solve with hard `assert`s: per-step `assert(validate_correction())`
(reference: src/solver.cpp:609-612) and per-cell positivity asserts inside
the integrators (solver.cpp:402, 488, 585: `assert(res(0) > 0 && res(1) >
0)` in debug builds). The JAX package records such checks functionally
with checkify; here every check is an explicit finiteness or positivity
reduction on the device, read back once:

* `make_ends_checker(positivity)`: the per-chunk guard of the chunked
  solve loops (CLI --check), raising NumericCheckError with the check named;
* `checked_step(step)`: wrap a step function, returning (error or None,
  state);
* `assert_state_finite(state)`: host-side guard on every state leaf;
* `nan_debug()`: autograd's anomaly mode within a block.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_FINITE = ("check 'finite-intensity' failed: non-finite value in ends "
           "(solver.cpp:609-612 analogue)")
_POSITIVE = ("check 'positive-intensity' failed: non-positive edge "
             "intensity (solver.cpp:402 analogue)")


class NumericCheckError(RuntimeError):
    """A numeric guard failed; the message names the check (the port's
    counterpart of checkify's JaxRuntimeError)."""


def _failures(ends: torch.Tensor, positivity: bool) -> torch.Tensor:
    """(any non-finite, any non-positive) as one device tensor: one
    reduction, read back by a single host copy."""
    bad = [~torch.isfinite(ends).all()]
    if positivity:
        bad.append(~(ends > 0).all())
    return torch.stack(bad)


def checked_step(step: Callable, positivity: bool = False) -> Callable:
    """Wrap a State -> State step with explicit error checks.

    Returns a function State -> (NumericCheckError or None, State):

        err, state = checked_step(step)(state)
        if err is not None:
            raise err

    With positivity=True also enforces the reference's debug-build
    positivity assertion on both cell edges (solver.cpp:402); off by
    default because vacuum-boundary problems legitimately produce
    near-zero (and, at f32 roundoff, slightly negative) edge values.
    """
    messages = ("non-finite intensity in ends after step",
                "non-positive edge intensity (reference debug assert, "
                "solver.cpp:402)")

    def guarded(state):
        new = step(state)
        for failed, msg in zip(_failures(new.ends, positivity).tolist(),
                               messages):
            if failed:
                return NumericCheckError(msg), new
        return None, new

    return guarded


def make_ends_checker(positivity: bool = False) -> Callable:
    """Per-chunk numeric guard for the chunked solve loops (CLI --check).

    Returns check(ends, step=None) raising NumericCheckError with the
    failing check NAMED if the (M, G, N, 2) edge-intensity array (a
    tensor on any device, or a numpy array) is non-finite (or
    non-positive with positivity=True: the reference's debug-build
    assert, solver.cpp:402). Composes with the chunked solvers
    (utils/checkpoint.py, cli --balance-every): one device-side reduction
    and one read-back per chunk, no effect on the solve trajectory.
    """

    def check(ends, step: Optional[int] = None) -> None:
        failed = _failures(torch.as_tensor(ends), positivity).tolist()
        for bad, msg in zip(failed, (_FINITE, _POSITIVE)):
            if bad:
                where = f" at step {step}" if step is not None else ""
                raise NumericCheckError(f"{msg}{where}")

    return check


def assert_state_finite(state) -> None:
    """Host-side: raise FloatingPointError if any state leaf is non-finite
    (a transport.State, or an engine's FlatState)."""
    for name, leaf in zip(state._fields, state):
        finite = torch.isfinite(torch.as_tensor(leaf))
        if not bool(finite.all()):
            raise FloatingPointError(f"state.{name} contains "
                                     f"{int((~finite).sum())} non-finite "
                                     "values")


@contextlib.contextmanager
def nan_debug():
    """autograd's anomaly mode within the context (slow; debugging only),
    the previous setting restored on exit.

    It catches less than the JAX package's jax_debug_nans, which checks
    the output of every primitive it runs: anomaly mode checks only the
    gradients autograd computes (a backward function that returns NaN
    raises, with the traceback of the forward operation that made it).
    NaNs in a forward pass, and in the CUDA kernels the wrappers launch
    outside autograd, pass unseen: make_ends_checker guards those."""
    prev = torch.is_anomaly_enabled()
    prev_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_nan)
