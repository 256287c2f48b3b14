"""95th percentile, over every request submitted in the window, of the
time from its submission to its first token."""
from portbench.drivers.serve_closed_loop import percentile, ttfts_ms

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    return percentile(ttfts_ms(run), 95)
