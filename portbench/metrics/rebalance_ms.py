"""Mean milliseconds of a rebalance in the window: the growth of the
tiered cache's ``rebalance_seconds`` counter (the manager's analyze and
the quota enforcement) over the rebalances run."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_counter"
LAYER, MOVES = "tiered cache and ECI manager", "tokens_per_s"


def read(run):
    if not run.rebalances:
        return None
    return run.rebalance_s / run.rebalances * 1e3
