"""The f64-grade forward solves' share of their roofline: the operations of
the f64 algorithm (counts.step_flops, not those of a double-float
emulation) at the card's FP64 peak outside the tensor cores (34 TFLOP/s,
NVIDIA H100 SXM data sheet), or the float64 state read once and written
once at its HBM bandwidth, the larger, over the device-busy seconds, per
chip."""

from counts import bound_seconds


def read(run):
    if run.entry != "forward" or run.dtype != "float64" or not run.trace:
        return None
    if run.trace["busy_s"] <= 0:
        return None
    bound = bound_seconds(run.work) * run.requests / run.world
    return 100.0 * bound / run.trace["busy_s"]
