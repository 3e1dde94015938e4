"""The value-and-gradient requests' share of their roofline: the forward
and adjoint operations of each step (counts.adjoint_step_flops) at the
card's FP32 peak, or the input state and the gradient moved once at its
HBM bandwidth, the larger, over the device-busy seconds."""

from counts import bound_seconds


def read(run):
    if run.entry != "grad" or not run.trace or run.trace["busy_s"] <= 0:
        return None
    bound = bound_seconds(run.work) * run.requests / run.world
    return 100.0 * bound / run.trace["busy_s"]
