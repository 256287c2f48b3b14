"""The port's tracer, ``core/profile.py``'s span side: the ring (its
capacity, its wrap and the count of spans it dropped), a disabled profile
(spans record nothing, counters still count), ``device_span`` on the
CPU, the window log's bound, and the clock shared with
``torch.profiler``: a CPU operation run inside a span lands inside that
span's ``wall_intervals``."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core.profile import (DEVICE_EVERY, NULL_SPAN,
                                      SPAN_CAPACITY, WINDOW_LOG_ROWS,
                                      StageProfile, process_profile)


def _spans(prof, name, k):
    stamps = []
    for _ in range(k):
        with prof.span(name):
            stamps.append(time.perf_counter_ns())
    return stamps


def test_ring_keeps_the_newest_spans_in_order():
    prof = StageProfile()
    _spans(prof, "a", 5)
    inside = _spans(prof, "b", 3)
    s = prof.spans("b")
    assert len(s) == 3 and prof.overwritten == 0
    assert np.all(s.start <= np.asarray(inside))
    assert np.all(np.asarray(inside) <= s.end)
    assert np.all(np.diff(s.start) > 0)
    assert np.isnan(s.device_ms).all()
    assert len(prof.spans("a")) == 5 and len(prof.spans("none")) == 0


def test_ring_wraps_and_counts_what_it_dropped():
    prof = StageProfile()
    first = _spans(prof, "a", 6)
    mid = time.perf_counter_ns()
    _spans(prof, "b", SPAN_CAPACITY + 6)
    assert prof.overwritten == 12
    # the 6 "a" and the first 6 "b" are gone: every name's spans, asked
    # from before the last one dropped, are refused
    assert prof.spans("b") is None
    assert prof.spans("a", first[0]) is None
    assert prof.spans("b", mid) is None
    kept = prof.spans("b", int(prof._lost_end) + 1)
    assert len(kept) == SPAN_CAPACITY
    assert len(prof.spans("a", int(prof._lost_end) + 1)) == 0
    # wall_intervals gives what the ring kept
    assert len(prof.wall_intervals("b")) == SPAN_CAPACITY


def test_disabled_spans_record_nothing_but_counters_count():
    prof = StageProfile()
    prof.enabled = False
    assert prof.span("a") is prof.span("b") is prof.device_span("c") \
        is NULL_SPAN
    with prof.span("a") as sp:
        pass
    assert sp.ns == 0
    prof.count("n")
    prof.count("n", 4)
    prof.log_window({"window": 1})
    assert prof.counters == {"n": 5}
    assert list(prof.window_log) == [{"window": 1}]
    assert prof._n == 0 and prof.spans_report()["span_ms"] == {}
    prof.enabled = True
    with prof.span("a"):
        pass
    assert len(prof.spans("a")) == 1


def test_device_span_on_the_cpu_keeps_the_host_time():
    prof = StageProfile()
    x = torch.randn(64, 64)
    for _ in range(3):
        with prof.device_span("mm", torch.device("cpu")):
            x = x @ x.T / 64
    s = prof.spans("mm")
    assert len(s) == 3
    np.testing.assert_allclose(s.device_ms, s.ms)
    rep = prof.spans_report()
    assert rep["device_ms"]["mm"] == pytest.approx(rep["span_ms"]["mm"])


def test_rounds_time_one_in_device_every():
    prof = StageProfile()
    assert prof._timed_round                  # before any round
    timed = []
    for _ in range(3 * DEVICE_EVERY):
        prof.next_round()
        timed.append(prof._timed_round)
    assert timed == ([False] * (DEVICE_EVERY - 1) + [True]) * 3
    # off CUDA a device span keeps the host time in every round
    for _ in range(3):
        prof.next_round()
        with prof.device_span("d", torch.device("cpu")):
            pass
    assert not np.isnan(prof.spans("d").device_ms).any()


def test_window_log_keeps_the_last_rows():
    prof = StageProfile()
    for i in range(WINDOW_LOG_ROWS + 5):
        prof.log_window({"window": i})
    assert len(prof.window_log) == WINDOW_LOG_ROWS
    assert prof.window_log[0]["window"] == 5
    assert [r["window"] for r in prof.spans_report(2)["windows"]] == \
        [WINDOW_LOG_ROWS + 3, WINDOW_LOG_ROWS + 4]


def test_stages_keep_their_behaviour_beside_spans():
    prof = StageProfile(staged=True)
    with prof.stage("count"):
        with prof.span("inner"):
            pass
    prof.sync()
    prof.windows += 1
    rep = prof.report()
    assert set(rep) == {"times_s", "syncs", "windows", "syncs_per_window"}
    assert set(rep["times_s"]) == {"count"} and rep["syncs"] == 1
    assert not prof.fence and len(prof.spans("inner")) == 1


def test_process_profile_is_one_unfenced_enabled_profile():
    prof = process_profile()
    assert prof is process_profile()
    assert prof.enabled and not prof.fence and prof.device is None


def test_profiler_cpu_op_lands_inside_its_span():
    """``torch.profiler``'s events are on ``time.time_ns``; a span's
    ``wall_intervals`` put it on that clock."""
    prof = StageProfile()
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as p:
        for _ in range(3):          # 1 ms of room on each side, 2 between
            time.sleep(0.002)
            with prof.span("mm"):
                time.sleep(0.001)
                torch.mm(a, b)
                time.sleep(0.001)
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in p.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    spans = prof.wall_intervals("mm")
    assert len(ops) == len(spans) == 3
    for (s0, s1), (o0, o1) in zip(spans, sorted(ops)):
        assert s0 <= o0 <= o1 <= s1, (s0, o0, o1, s1)
