"""The readers of the program's own spans (``prefill_pages_ms``,
``decode_launch_ms``): values in a traced run of the tiny tree, None
for a window with no span and for a ring that has dropped spans of the
window, and the program's ``serve.decode`` against the harness's own span
around the same calls."""
import time
import types

import pytest

import repro_torch.core.profile as profile_mod
from portbench import bench
from portbench.drivers import serve_closed_loop
from portbench.run import run_cell
from portbench.tests import tiny
from repro_torch.core.profile import (SPAN_CAPACITY, StageProfile,
                                      process_profile)

READERS = ("prefill_pages_ms", "decode_launch_ms")


def _read(name, run):
    return bench.metric_module(tiny.REPO, name).read(run)


def test_readers_report_in_a_traced_run(tmp_path, monkeypatch):
    monkeypatch.setattr(serve_closed_loop, "TRACE_SECONDS", 1.0)
    root = tiny.make_tree(tmp_path)
    out = run_cell(root, "tiny-dense.tiny", 2**33 + 17, 1.5, True, "cpu",
                   time.perf_counter())
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"


def test_program_decode_span_matches_the_harness_span(tmp_path):
    seen = {}

    def keep(eng):
        seen["eng"] = eng
    root = tiny.make_tree(tmp_path)
    t = time.perf_counter()
    run_cell(root, "tiny-dense.tiny", 2**32 + 5, 1.5, False, "cpu", t,
             fault=keep)
    # the run's window is not returned untraced: take the harness's own
    # spans of the window's steps and the program's spans of those calls
    decodes = seen["eng"].decodes
    assert len(decodes) >= 3
    lo, hi = int(decodes[0][0] * 1e9), int(decodes[-1][1] * 1e9)
    s = process_profile().spans("serve.decode", lo, hi)
    assert len(s) == len(decodes)
    ours = s.ms.mean()
    theirs = 1e3 * sum(e - a for a, e, _ in decodes) / len(decodes)
    assert ours == pytest.approx(theirs, rel=0.05)
    assert ours <= theirs


def _window(t0, t1):
    return types.SimpleNamespace(t0=t0, t_end=t1)


def test_readers_silent_for_an_empty_window():
    with process_profile().span("serve.decode"):
        pass
    run = _window(1.0, 2.0)                  # long before this process
    for name in READERS:
        assert _read(name, run) is None, name


def _steps(prof, n):
    for _ in range(n):
        with prof.span("serve.decode"):
            with prof.span("serve.decode.forward"):
                for _ in range(2):
                    with prof.device_span("serve.decode.attention"):
                        time.sleep(1e-4)
                with prof.device_span("serve.decode.head"):
                    pass
        with prof.span("serve.prefill.pages"):
            pass


def test_readers_silent_for_a_wrapped_ring(monkeypatch):
    prof = StageProfile()
    monkeypatch.setattr(profile_mod, "process_profile", lambda: prof)
    t0 = time.perf_counter()
    _steps(prof, 3)
    run = _window(t0, time.perf_counter())
    for _ in range(SPAN_CAPACITY):          # the window's 18 spans dropped
        with prof.span("filler"):
            pass
    assert prof.overwritten == 18
    for name in READERS:
        assert _read(name, run) is None, name
    big = StageProfile()
    monkeypatch.setattr(profile_mod, "process_profile", lambda: big)
    t0 = time.perf_counter()
    _steps(big, 3)
    run = _window(t0, time.perf_counter())
    assert all(_read(name, run) > 0 for name in READERS)
