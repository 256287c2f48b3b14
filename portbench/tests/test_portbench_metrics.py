"""The end-to-end metrics: a rate over all the work and all the time of
the window, and tails over every request or gap, not over chunks."""
import types

import numpy as np
import pytest

from portbench import bench
from portbench.drivers.serve_closed_loop import ServeRun
from portbench.tests.tiny import REPO


def _run(records, t0=10.0, seconds=10.0, prefills=(), decodes=()):
    return ServeRun(cfg={}, seconds=seconds, setup_s=3.5, t0=t0,
                    t_end=t0 + seconds, t_close=t0 + seconds + 0.1,
                    records=records, prefills=list(prefills),
                    decodes=list(decodes), rebalance_s=0.3, rebalances=3,
                    bound_s={}, trace=None, attempted=len(records),
                    failed=0, compared={}, device={}, notes={})


def _rec(submit, stamps):
    return types.SimpleNamespace(submit=submit, stamps=list(stamps))


def _read(name, run):
    return bench.metric_module(REPO, name).read(run)


def test_rate_counts_every_token_of_the_window():
    recs = [_rec(9.0, [9.5, 10.0, 12.0, 19.9, 20.05]),   # 3 in the window
            _rec(15.0, [15.1 + 0.1 * i for i in range(40)])]  # all 40
    assert _read("tokens_per_s", _run(recs)) == pytest.approx(43 / 10.0)


def test_itl_tail_over_every_gap():
    # one request with many short gaps, one with a few long ones: the tail
    # is of all gaps together, not a mean of per-request tails
    fast = _rec(10.0, 10.0 + 0.01 * np.arange(100))
    slow = _rec(10.0, [11.0, 12.0, 13.0, 14.0, 15.0, 16.0])
    gaps = np.concatenate([np.full(99, 10.0), np.full(5, 1000.0)])
    want = np.percentile(gaps, 95)
    assert _read("itl_p95_ms.serve", _run([fast, slow])) == \
        pytest.approx(want)


def test_itl_gaps_need_both_ends_in_the_window():
    r = _rec(5.0, [9.0, 10.5, 11.0, 21.0])      # only 10.5 -> 11.0 counts
    assert _read("itl_p95_ms.serve", _run([r])) == pytest.approx(500.0)


def test_ttft_over_requests_submitted_in_the_window():
    recs = [_rec(9.0, [9.9]), _rec(10.0, [10.2]), _rec(12.0, [12.4]),
            _rec(19.0, [19.6]), _rec(20.5, [20.6])]
    want = np.percentile([200.0, 400.0, 600.0], 95)
    assert _read("ttft_p95_ms", _run(recs)) == pytest.approx(want)


def test_span_means_over_calls_ending_in_the_window():
    run = _run([], prefills=[(9.0, 9.5, 100), (10.0, 10.2, 100),
                             (11.0, 11.4, 100)],
               decodes=[(12.0, 12.1, [5]), (21.0, 21.3, [5])])
    assert _read("prefill_ms", run) == pytest.approx(300.0)
    assert _read("decode_step_ms", run) == pytest.approx(100.0)
    assert _read("rebalance_ms", run) == pytest.approx(100.0)
    assert _read("setup_s", run) == 3.5


def test_trace_readers_stay_silent_without_a_trace():
    run = _run([])
    for name in ("device_idle", "paged_attention_roofline",
                 "flash_attention_roofline"):
        assert _read(name, run) is None
    run.trace = {"ops": {"x": 1.0}, "window_s": 4.0, "busy_s": 1.0}
    run.bound_s = {"paged_attention": 0.0, "flash_attention": 0.0}
    assert _read("paged_attention_roofline", run) is None
    assert _read("device_idle", run) == pytest.approx(75.0)
