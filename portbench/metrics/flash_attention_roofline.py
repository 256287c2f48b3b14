"""The least time of the traced window's prefill ``flash_attention``
calls (causal FLOPs at the bf16 peak, or q, k, v and out at HBM
bandwidth, whichever is longer) over the kernel's device time in the
trace, in %."""
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "flash_attention kernel", "ttft_p95_ms"
KERNELS = ("fa_bf16_kernel", "fa_f32_kernel")


def read(run):
    if run.trace is None:
        return None
    t = sum(s for n, s in run.trace["ops"].items()
            if any(k in n for k in KERNELS))
    b = run.bound_s.get("flash_attention", 0.0)
    return 100 * b / t if t and b else None
