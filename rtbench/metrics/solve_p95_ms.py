"""The 95th percentile over all of the window's requests of one request's
wall time, from its state being ready to its result on the host."""

from harness import percentile


def read(run):
    if not run.latencies:
        return None
    return percentile(run.latencies, 95) * 1e3
