"""Kernel launches a timestep in the engine's host loop: the sum over the
window of the program's wrapper counters (each wrapper's `.launches`),
rank 0's, over the timesteps its solves ran."""


def read(run):
    if run.entry != "forward" or run.steps == 0:
        return None
    return run.launches / run.steps
