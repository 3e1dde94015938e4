"""The share of the traced window in which nothing ran on the device, for
forward solves: 1 - device-busy / window, averaged over the chips."""


def read(run):
    if run.entry != "forward" or not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
