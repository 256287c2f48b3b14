"""Mean host time of the prefill's page loop (the program's
``serve.prefill.pages`` span: prefix hashes, lookups, ECI events, page
writes, allocation and pins) over the spans that ended in the window.
None for a program without the span, for a window with none, and where
the program's ring has dropped spans of the window."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "tiered cache and ECI manager", "tokens_per_s"


def read(run):
    try:
        from repro_torch.core.profile import process_profile
    except ImportError:            # a program without the tracer
        return None
    s = process_profile().spans("serve.prefill.pages", int(run.t0 * 1e9),
                                int(run.t_end * 1e9))
    return float(s.ms.mean()) if s is not None and len(s) else None
