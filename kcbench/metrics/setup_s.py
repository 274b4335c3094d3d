"""setup_s: from the process's start to the window's: imports, the kernel
libraries' load (and build, on a checkout's first run), the inputs made
on the card, and the warm-up (a whole job)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
