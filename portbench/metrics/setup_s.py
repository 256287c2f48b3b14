"""Seconds from the start of the process to the opening of the window:
imports, the port's kernels built (first run of a checkout) or loaded,
weights made, the pool allocated, and the traffic run until every client
has been answered."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
