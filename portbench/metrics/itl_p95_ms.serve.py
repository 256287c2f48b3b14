"""95th percentile of every gap between consecutive tokens of a request,
both ends inside the window (all requests' gaps together): the engine's
step cadence as a client sees it.  A per-layer reading where the tail
swings with the host's speed from run to run more than an end-to-end
bound can hold."""
from portbench.drivers.serve_closed_loop import gaps_ms, percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "engine", "tokens_per_s"


def read(run):
    return percentile(gaps_ms(run), 95)
