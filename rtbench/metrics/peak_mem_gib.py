"""torch.cuda.max_memory_allocated over the window (after
reset_peak_memory_stats), the highest rank's, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
