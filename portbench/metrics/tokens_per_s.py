"""Tokens generated in the window over the window's seconds (every first
token of a prefill and every decoded token whose host stamp lies in the
window)."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    return run.window_tokens() / run.seconds
