"""The port's one tracer.

Two kinds of timing share ``StageProfile``:

* fenced stages of the control loop (tape build, count, replay, the
  device window pipeline's ingest, dispatch and fetch, ...): ``stage``,
  ``pstage``, ``sync``, ``windows``, ``report``;
* the serving path's spans, counters and window log: ``span`` (a host
  interval), ``device_span`` (a host interval and, on CUDA, the device
  time between two events on the current stream), ``count`` and
  ``log_window``.  None of them synchronizes.  Spans are stamped with
  ``time.perf_counter_ns`` and kept in a preallocated ring;
  ``wall_intervals`` puts them on ``time.time_ns``, the clock of
  ``torch.profiler``'s device events.

``process_profile()`` is the process's serving profile, which the
serving classes (``TieredKVCache``, ``MultiTenantEngine``) use when they
are given none.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

__all__ = ["StageProfile", "Spans", "process_profile", "pstage"]

SPAN_CAPACITY = 1 << 16      # spans the ring holds before it overwrites
WINDOW_LOG_ROWS = 1024       # window-log rows kept
EVENT_PAIRS = 64             # CUDA event pairs made at the first device span
DEVICE_EVERY = 8             # rounds of device spans, one timed on CUDA


class _NullSpan:
    """The span of a disabled profile: records nothing, lasts 0 ns."""
    __slots__ = ()
    ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """A host span of one name, reused for every interval of that name (so
    a name does not nest in itself).  ``ns`` is its last duration."""
    __slots__ = ("_prof", "_id", "_t0", "ns")

    def __init__(self, prof: "StageProfile", nid: int):
        self._prof, self._id, self._t0, self.ns = prof, nid, 0, 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self._t0
        self._prof._push(self._id, self._t0, t1, np.nan)
        return False


class _HostDeviceSpan(_Span):
    """``device_span`` off CUDA: the device time is the host time."""
    __slots__ = ()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self._t0
        self._prof._push(self._id, self._t0, t1, self.ns * 1e-6)
        return False


class _CudaSpan(_Span):
    """``device_span`` on CUDA: a host span, plus, in a timed round, two
    events on the current stream, resolved into device ms by
    ``StageProfile.resolve``."""
    __slots__ = ("_ev",)

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        prof = self._prof
        if prof._timed_round:
            if prof._stream is None:
                prof._stream = torch.cuda.current_stream()
            self._ev = prof._event_pair()
            self._ev[0].record(prof._stream)
        else:
            self._ev = None
        return self

    def __exit__(self, *exc):
        ev, prof = self._ev, self._prof
        if ev is not None:
            ev[1].record(prof._stream)
        t1 = time.perf_counter_ns()
        self.ns = t1 - self._t0
        seq = prof._push(self._id, self._t0, t1, np.nan)
        if ev is not None:
            prof._pending.append((seq, ev))
        return False


@dataclasses.dataclass
class Spans:
    """Spans of one name, by start: host stamps (``perf_counter_ns``) and
    device ms (NaN for a host span, or a device span not yet resolved)."""
    start: np.ndarray
    end: np.ndarray
    device_ms: np.ndarray

    def __len__(self) -> int:
        return len(self.end)

    @property
    def ms(self) -> np.ndarray:
        return (self.end - self.start) * 1e-6


class StageProfile:
    """Fenced stage times and host syncs of the control loop, and the
    serving path's unfenced spans and counters.

    ``device`` is where the staged work runs; left ``None`` it is bound
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

    Spans (``span``, ``device_span``) are never fenced.  Each is kept as
    (name, start, end, device ms) in a ring of ``SPAN_CAPACITY`` entries;
    ``overwritten`` counts the spans the ring has dropped.  With
    ``enabled`` set False spans return one shared null context and record
    nothing; counters (``count``) and the window log still count.  A
    device span's events cost the host tens of microseconds, so on CUDA
    they are recorded in one round of ``DEVICE_EVERY`` (``next_round``
    starts a round: the engine's decode step); the other rounds keep the
    host span alone.
    """

    def __init__(self, device: str | torch.device | None = None,
                 staged: bool = False):
        self.device = None if device is None else torch.device(device)
        self.staged = bool(staged)
        self.times: dict[str, float] = {}
        self.syncs = 0
        self.windows = 0
        self.enabled = True
        self.counters: dict[str, int] = {}
        self.window_log: collections.deque = collections.deque(
            maxlen=WINDOW_LOG_ROWS)
        self.overwritten = 0
        self._names: list[str] = []
        self._ids: dict[str, int] = {}
        self._spans: dict[tuple[str, int], _Span] = {}
        self._sid = np.empty(SPAN_CAPACITY, np.int32)
        self._start = np.empty(SPAN_CAPACITY, np.int64)
        self._end = np.empty(SPAN_CAPACITY, np.int64)
        self._dev = np.empty(SPAN_CAPACITY, np.float64)
        self._n = 0                      # spans ever recorded
        self._lost_end = -1              # latest end of an overwritten span
        self._events: list = []          # free CUDA event pairs
        self._pending: collections.deque = collections.deque()
        self._round = 0
        self._timed_round = True         # CUDA events in this round
        self._stream = None              # the timed round's stream

    # ---------------------------------------------- fenced control stages
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

    # ------------------------------------------- spans, counters, windows
    def _get(self, name: str, kind: int, cls) -> _Span:
        s = self._spans.get((name, kind))
        if s is None:
            nid = self._ids.get(name)
            if nid is None:
                nid = self._ids[name] = len(self._names)
                self._names.append(name)
            s = self._spans[(name, kind)] = cls(self, nid)
        return s

    def span(self, name: str):
        """An unfenced host span of ``name``, as a context manager."""
        if not self.enabled:
            return NULL_SPAN
        return self._get(name, 0, _Span)

    def device_span(self, name: str, device: torch.device | None = None):
        """A host span of ``name`` that also keeps the device's time of the
        work enqueued inside it: on CUDA (``device``, else the profile's)
        a pair of events on the current stream in a timed round (see
        ``next_round``), taken from a pool and resolved by ``resolve`` once
        the end event has completed, so no sync is added; elsewhere the
        host time."""
        if not self.enabled:
            return NULL_SPAN
        dev = device if device is not None else self.device
        if dev is not None and dev.type == "cuda":
            return self._get(name, 2, _CudaSpan)
        return self._get(name, 1, _HostDeviceSpan)

    def next_round(self) -> None:
        """Start a round of device spans: on CUDA their events are recorded
        in one round of ``DEVICE_EVERY``."""
        self._round += 1
        self._timed_round = self._round % DEVICE_EVERY == 0
        self._stream = None

    def _push(self, nid: int, t0: int, t1: int, dev_ms: float) -> int:
        n = self._n
        i = n % SPAN_CAPACITY
        if n >= SPAN_CAPACITY:
            self.overwritten += 1
            self._lost_end = max(self._lost_end, int(self._end[i]))
        self._sid[i] = nid
        self._start[i] = t0
        self._end[i] = t1
        self._dev[i] = dev_ms
        self._n = n + 1
        return n

    def _event_pair(self) -> tuple:
        if not self._events:
            self.resolve()
        if not self._events:
            self._events.extend(
                (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
                for _ in range(EVENT_PAIRS))
        return self._events.pop()

    def resolve(self) -> None:
        """Turn the device spans whose end event has completed into device
        ms, in order, and return their events to the pool.  Never waits."""
        pending = self._pending
        while pending:
            seq, (a, b) = pending[0]
            if not b.query():
                break
            pending.popleft()
            if seq >= self._n - SPAN_CAPACITY:
                self._dev[seq % SPAN_CAPACITY] = a.elapsed_time(b)
            self._events.append((a, b))

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def log_window(self, row: dict) -> None:
        """One row of per-window counters (the last ``WINDOW_LOG_ROWS``
        are kept)."""
        self.window_log.append(row)

    def _select(self, name: str, lo: int | None, hi: int | None) -> Spans:
        k = min(self._n, SPAN_CAPACITY)
        sel = self._sid[:k] == self._ids.get(name, -1)
        end = self._end[:k]
        if lo is not None:
            sel &= end >= lo
        if hi is not None:
            sel &= end <= hi
        idx = np.flatnonzero(sel)
        idx = idx[np.argsort(self._start[idx], kind="stable")]
        return Spans(self._start[idx], end[idx], self._dev[idx])

    def spans(self, name: str, lo: int | None = None,
              hi: int | None = None) -> Spans | None:
        """The kept spans of ``name`` that ended in ``[lo, hi]``
        (``perf_counter_ns``; open where None), by start; None when the
        ring has overwritten a span that ended at or after ``lo``, so the
        interval's spans are not all there."""
        self.resolve()
        if self.overwritten and (lo is None or self._lost_end >= lo):
            return None
        return self._select(name, lo, hi)

    def wall_intervals(self, name: str) -> list[tuple[int, int]]:
        """The kept spans of ``name`` as (start, end) on ``time.time_ns``,
        the clock of ``torch.profiler``'s events, through an anchor
        between the two clocks taken anew at each call."""
        off = time.time_ns() - time.perf_counter_ns()
        s = self._select(name, None, None)
        return [(int(a) + off, int(b) + off) for a, b in zip(s.start, s.end)]

    def spans_report(self, last_windows: int = 3) -> dict:
        """Mean host ms of each name's kept spans, mean device ms of the
        device spans, the counters and the last window-log rows."""
        self.resolve()
        k = min(self._n, SPAN_CAPACITY)
        sid, dur, dev = (self._sid[:k], (self._end[:k] - self._start[:k])
                         * 1e-6, self._dev[:k])
        host_ms, device_ms = {}, {}
        for nid, name in enumerate(self._names):
            sel = sid == nid
            if sel.any():
                host_ms[name] = float(dur[sel].mean())
                d = dev[sel]
                if not np.isnan(d).all():
                    device_ms[name] = float(np.nanmean(d))
        return {"span_ms": host_ms, "device_ms": device_ms,
                "counters": dict(self.counters),
                "windows": list(self.window_log)[-last_windows:]
                if last_windows else [],
                "spans_overwritten": self.overwritten}


def pstage(profile: StageProfile | None, name: str, fence: bool = True):
    """Time a stage when a profile is attached (a no-op otherwise)."""
    return (profile.stage(name, fence) if profile is not None
            else contextlib.nullcontext())


_PROCESS: list[StageProfile] = []


def process_profile() -> StageProfile:
    """The process's serving profile: unfenced, enabled, made at the first
    call."""
    if not _PROCESS:
        _PROCESS.append(StageProfile())
    return _PROCESS[0]
