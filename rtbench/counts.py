"""The benchmark's yardstick for work: peaks of the card, and the operations,
bytes and updates of one request, from the configuration and the steps
alone. Nothing here depends on how the program implements a step (its K,
blocks or kernels), so a roofline share counts the same work whatever runs
it.

The per-cell operation counts are those of the function each sweep computes,
counted once from the port's kernels (`csrc/sweep.cu` `substep_tile`,
`csrc/adjoint.cu` `phase_adj`) and frozen here: psi 2, source 3, the
right-hand side (BE 4, CN 10, BDF 22), b 4, carry 2, u 2, two edges 8. The
scan machinery (a^n products, shuffles, look-back) is not part of the
function and is not counted.
"""

from __future__ import annotations

# Peaks of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet,
# dense rates without sparsity): HBM3 bytes/s; FP32 and FP64 outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12

# Operations per (cell, direction, group) of one sub-step.
FLOPS_PER_CELL = {"BE": 25, "CN": 31, "BDF": 43}
# The correction source of the f64 algorithm where the deck sets
# use_correction: (cor1 psi + cor2) mu beta - cor3 (mu beta)^2 with its
# (direction, group) constants folded is a multiply-add on psi, and its
# scale into the source another: 4.
CORRECTION_FLOPS_PER_CELL = 4
# The adjoint of one sub-step (phase_adj): the cotangent solve and
# reversed-scan fix-up 14, the right-hand side recomputed (psi 2, source 3,
# BE 4, CN 10, BDF 22) and u 2, the cotangent right-hand sides with their
# history and shift terms (BE 8, CN 20, BDF 48), the coefficient-gradient
# sums 36.
ADJ_FLOPS_PER_CELL = {"BE": 75, "CN": 93, "BDF": 133}
# A BDF2 step is BE, CN, BE, BDF at dt/2: 4 sub-steps, 4 updates a cell.
BDF2_PHASES = ("BE", "CN", "BE", "BDF")
# The adjoint step adds 8 adds that route the phases' cotangents.
ADJ_ROUTING_FLOPS = 8


def phases(ts_method: int):
    return BDF2_PHASES if ts_method == 3 else (
        ("BE",) if ts_method == 1 else ("CN",))


def cells(deck: dict) -> int:
    """(cell, direction, group) triples of the whole slab."""
    return deck["M"] * deck["G"] * deck["N"]


def updates_per_step(deck: dict) -> int:
    """Cell-angle-group updates of one timestep: one a sub-step."""
    return len(phases(deck["ts_method"])) * cells(deck)


def step_flops(deck: dict) -> int:
    """Operations of one forward timestep of the f32 or f64 algorithm."""
    corr = CORRECTION_FLOPS_PER_CELL if deck.get("use_correction") else 0
    return cells(deck) * sum(FLOPS_PER_CELL[p] + corr
                             for p in phases(deck["ts_method"]))


def adjoint_step_flops(deck: dict) -> int:
    """Operations of one step of a value-and-gradient: the forward step
    once and the adjoint of each phase (a recompute of the forward in the
    backward is the program's choice and is not counted)."""
    ph = phases(deck["ts_method"])
    per = (sum(FLOPS_PER_CELL[p] for p in ph)
           + sum(ADJ_FLOPS_PER_CELL[p] for p in ph) + ADJ_ROUTING_FLOPS)
    return cells(deck) * per


def state_bytes(deck: dict, itemsize: int) -> int:
    """One (M, G, N, 2) edge array."""
    return 2 * cells(deck) * itemsize


def forward_bytes(deck: dict, itemsize: int) -> int:
    """A solve reads its input ends once and writes its state (ends, prev,
    half) once."""
    return 4 * state_bytes(deck, itemsize)


def grad_bytes(deck: dict) -> int:
    """A value-and-gradient reads its float32 input ends once and writes
    its gradient, (G,) float64, once."""
    return state_bytes(deck, 4) + 8 * deck["G"]


def request_work(deck: dict, traffic: dict) -> dict:
    """Updates, operations, bytes and the peak they are held to, for one
    request of `traffic` on `deck`."""
    S = traffic["steps"]
    if traffic["entry"] == "grad":
        return {"updates": S * updates_per_step(deck),
                "flops": S * adjoint_step_flops(deck),
                "bytes": grad_bytes(deck), "peak_flops": PEAK_F32_FLOPS}
    f64 = traffic["dtype"] == "float64"
    return {"updates": S * updates_per_step(deck),
            "flops": S * step_flops(deck),
            "bytes": forward_bytes(deck, 8 if f64 else 4),
            "peak_flops": PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS}


def bound_seconds(work: dict) -> float:
    """The least time the card could take: the larger of operations over
    peak operations and bytes over peak bandwidth."""
    return max(work["flops"] / work["peak_flops"],
               work["bytes"] / PEAK_BYTES)
