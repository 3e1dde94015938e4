"""Seconds from process start to the first timed request: import, the
kernel library's load (its build on a checkout's first run), tables,
engine, and the warm-up request of the cell's own shapes."""


def read(run):
    return run.setup_s
