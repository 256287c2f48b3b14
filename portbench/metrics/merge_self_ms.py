"""Device milliseconds a decode step spends in ``_merge_self``: the
program's ``serve.decode.merge_self`` device spans (CUDA events around
each layer's call, in the steps the program times: one in eight) of the decode steps that ended in the window, over the
number of timed steps among them (``serve.decode.head`` device spans with
a device time).  None for a program without the spans, for a window with
none, and where the program's ring has dropped spans of the window."""
import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "engine", "tokens_per_s"


def read(run):
    try:
        from repro_torch.core.profile import process_profile
    except ImportError:            # a program without the tracer
        return None
    prof = process_profile()
    steps = prof.spans("serve.decode", int(run.t0 * 1e9),
                       int(run.t_end * 1e9))
    if steps is None or not len(steps):
        return None
    # every layer's span of those steps ends inside the steps' extent
    lo, hi = int(steps.start[0]), int(steps.end[-1])
    merge = prof.spans("serve.decode.merge_self", lo, hi)
    head = prof.spans("serve.decode.head", lo, hi)
    if merge is None or head is None:
        return None
    timed = int((~np.isnan(head.device_ms)).sum())
    if not timed:
        return None
    return float(np.nansum(merge.device_ms)) / timed
