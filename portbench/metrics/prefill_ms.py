"""Mean host time of ``MultiTenantEngine._prefill_one`` over the requests
prefilled in the window (a span the benchmark takes around the call)."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "engine", "ttft_p95_ms"


def read(run):
    d = [e - a for a, e, _ in run.prefills if run.in_window(e)]
    return sum(d) / len(d) * 1e3 if d else None
