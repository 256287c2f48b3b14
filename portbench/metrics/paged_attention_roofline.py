"""The least time of the traced window's ``paged_attention`` calls (K and
V of every distinct attended pool position read once, q, out, tables and
lengths) over the device time of the kernel's two kernels in the trace,
in %."""
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "paged_attention kernel", "tokens_per_s"
KERNELS = ("paged_split_kernel", "paged_merge_kernel")


def read(run):
    if run.trace is None:
        return None
    t = sum(s for n, s in run.trace["ops"].items()
            if any(k in n for k in KERNELS))
    b = run.bound_s.get("paged_attention", 0.0)
    return 100 * b / t if t and b else None
