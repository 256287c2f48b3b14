"""Per-stage wall time and host-sync count of the control loop (tape
build, count, replay, the device window pipeline's ingest, dispatch and
fetch, ...)."""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StageProfile", "pstage"]


class StageProfile:
    """Accumulates wall time per named stage and counts host syncs.

    ``device`` is where the profiled work runs; left ``None`` it is bound
    by the first pipeline, manager or replay the profile is handed to
    (``bind``).  On a CUDA device each stage is fenced with
    ``torch.cuda.synchronize`` at entry and exit, so the time of the work
    the stage queued lands in that stage (the fences cost a sync each;
    leave the profile off where that matters).  A stage opened with
    ``fence=False`` times the host's span only: the device window
    pipeline times its fused dispatch that way, so its one sync a window
    stays the fetch.

    ``sync()`` marks one host synchronization (the device pipeline's
    fetch, or a fence of its staged mode); ``windows`` counts the windows
    a pipeline finished, and ``syncs_per_window`` is their ratio.  With
    ``staged=True`` the device pipeline runs its stages one at a time,
    each fenced and counted as a sync, to attribute wall time per stage;
    the default fused mode pays exactly one sync a window.
    """

    def __init__(self, device: str | torch.device | None = None,
                 staged: bool = False):
        self.device = None if device is None else torch.device(device)
        self.staged = bool(staged)
        self.times: dict[str, float] = {}
        self.syncs = 0
        self.windows = 0

    @property
    def fence(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def bind(self, device: str | torch.device) -> "StageProfile":
        """Take ``device`` as the profiled device unless one was given."""
        if self.device is None:
            self.device = torch.device(device)
        return self

    def sync(self, k: int = 1) -> None:
        self.syncs += k

    @contextlib.contextmanager
    def stage(self, name: str, fence: bool = True):
        fence = fence and self.fence
        if fence:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence:
                torch.cuda.synchronize()
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    @property
    def syncs_per_window(self) -> float:
        return self.syncs / max(self.windows, 1)

    def report(self) -> dict:
        return {"times_s": dict(self.times), "syncs": self.syncs,
                "windows": self.windows,
                "syncs_per_window": self.syncs_per_window}


def pstage(profile: StageProfile | None, name: str, fence: bool = True):
    """Time a stage when a profile is attached (a no-op otherwise)."""
    return (profile.stage(name, fence) if profile is not None
            else contextlib.nullcontext())
