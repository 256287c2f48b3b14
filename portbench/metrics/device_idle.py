"""Share of the traced window in which no operation ran on the card, in
%."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "tokens_per_s"


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100 * (1 - run.trace["busy_s"] / run.trace["window_s"])
