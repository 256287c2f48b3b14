"""Mean host time to enqueue one decode step (the program's
``serve.decode.forward`` span around ``_decode_step``, which waits on
nothing) over the spans that ended in the window.  None for a program
without the span, for a window with none, and where the program's ring
has dropped spans of the window."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "engine", "tokens_per_s"


def read(run):
    try:
        from repro_torch.core.profile import process_profile
    except ImportError:            # a program without the tracer
        return None
    s = process_profile().spans("serve.decode.forward", int(run.t0 * 1e9),
                                int(run.t_end * 1e9))
    return float(s.ms.mean()) if s is not None and len(s) else None
