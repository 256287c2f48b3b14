"""Reading the device trace of a traced run.

``torch.profiler`` records, with its CUDA activity alone, every operation
the card ran (the port's hand-written kernels, launched through
``ctypes``, among them: the activity is taken from the device, whatever
launched it), on the host's wall clock.  The benchmark keeps its own host
spans around the calls into each layer on the same clock
(``time.time_ns``), so the profiler records no host operation and costs
the host little.  ``summarize`` reduces the two to the busy seconds of
the traced window, the device time of each operation, and the idle gaps,
each named by the innermost span that was open on the host at the gap's
middle.
"""
from __future__ import annotations

import bisect

import torch

__all__ = ["profiler", "summarize"]


def profiler(device: torch.device):
    """A profiler of the card's operations only (of the host's, where the
    run is on the CPU: the tests)."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU])


def _union(intervals: list[tuple[int, int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, window: tuple[int, int],
              spans: dict[str, list[tuple[int, int]]]) -> dict:
    """The traced ``window`` (wall-clock ns) in seconds: ``window_s``,
    ``busy_s`` (the union of device operations in it), ``ops`` (device
    seconds by operation name), ``idle`` (idle seconds by the host span
    open at each gap's middle: ``spans`` maps a name to its (start, end)
    intervals in ns, those of one name never overlapping), ``events``
    (device operations in the window) and ``outside`` (those wholly
    outside it)."""
    w0, w1 = window
    ops: dict[str, float] = {}
    busy_iv, outside = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = e.start_ns()
        a, b = max(s, w0), min(s + e.duration_ns(), w1)
        if b <= a:
            outside += 1
            continue
        ops[e.name()] = ops.get(e.name(), 0.0) + (b - a) * 1e-9
        busy_iv.append((a, b))
    busy = _union(busy_iv)
    by_name = {n: ([a for a, _ in iv], [b for _, b in iv])
               for n, iv in ((n, sorted(v)) for n, v in spans.items()) if iv}
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid, name, opened = (a + b) // 2, "other", -1
        for n, (st, en) in by_name.items():
            j = bisect.bisect_right(st, mid) - 1
            if j >= 0 and en[j] >= mid and st[j] > opened:
                name, opened = n, st[j]
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "ops": ops, "idle": idle, "events": len(busy_iv),
            "outside": outside}
