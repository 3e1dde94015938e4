"""All cell-angle-group updates that the window's solves completed (a BDF2
step is 4 M G N, summed over ranks), over the window's seconds."""


def read(run):
    if run.entry != "forward":
        return None
    return run.requests * run.work["updates"] / run.window_s
