"""Mean host time of ``MultiTenantEngine._decode_batch`` over the calls
that ended in the window (a span the benchmark takes around the call)."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "engine", "tokens_per_s"


def read(run):
    d = [e - a for a, e, _ in run.decodes if run.in_window(e)]
    return sum(d) / len(d) * 1e3 if d else None
