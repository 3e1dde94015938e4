"""The forward-equivalent updates of every value-and-gradient the window
completed, over the window's seconds: the price of one fit iteration."""


def read(run):
    if run.entry != "grad":
        return None
    return run.requests * run.work["updates"] / run.window_s
