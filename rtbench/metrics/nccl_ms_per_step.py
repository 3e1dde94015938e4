"""Device milliseconds of NCCL kernels in rank 0's trace of the window, a
timestep: the mesh exchanges' cost."""


def read(run):
    if run.world < 2 or not run.trace or run.steps == 0:
        return None
    return run.trace["nccl_s"] * 1e3 / run.steps
