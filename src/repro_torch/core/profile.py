"""Per-stage wall time of the control loop (tape build, count, replay, ...)."""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StageProfile", "pstage"]


class StageProfile:
    """Accumulates wall time per named stage.

    On a CUDA device each stage is fenced with ``torch.cuda.synchronize``
    at entry and exit, so the time of the work the stage queued lands in
    that stage (the fences cost a sync each; leave the profile off where
    that matters).
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.fence = torch.device(device).type == "cuda"
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.fence:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.fence:
                torch.cuda.synchronize()
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)


def pstage(profile: StageProfile | None, name: str):
    """Time a stage when a profile is attached (a no-op otherwise)."""
    return (profile.stage(name) if profile is not None
            else contextlib.nullcontext())
