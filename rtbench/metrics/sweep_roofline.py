"""The f32 forward solves' share of their roofline: the bound of the
window's work (counts.request_work: operations of the f32 algorithm at the
card's FP32 peak, or the state read once and written once at its HBM
bandwidth, the larger) over the device-busy seconds (the union of every
kernel and copy in the trace), per chip."""

from counts import bound_seconds


def read(run):
    if run.entry != "forward" or run.dtype != "float32" or not run.trace:
        return None
    if run.trace["busy_s"] <= 0:
        return None
    bound = bound_seconds(run.work) * run.requests / run.world
    return 100.0 * bound / run.trace["busy_s"]
