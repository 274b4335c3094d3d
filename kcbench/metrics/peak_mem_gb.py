"""peak_mem_gb: torch.cuda.max_memory_allocated over the window, reset at
its start, in 1e9 bytes: the device memory a user has to provision. The
loops keep their inputs and what the judge keeps on the host, so the
card holds only what the port puts there: a job's read set, once the port
has moved it, and its own state."""

UNIT = "GB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.peak_window / 1e9 if run.peak_window else None
