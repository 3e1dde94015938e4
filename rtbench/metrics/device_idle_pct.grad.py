"""The share of the traced window in which nothing ran on the device, for
value-and-gradient requests: 1 - device-busy / window."""


def read(run):
    if run.entry != "grad" or not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
