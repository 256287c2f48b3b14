"""The port's online characterization, phase detector, scenario suite and
event-driven manager against the JAX reference.

* ``characterize_trace``/``characterize_windows``: every feature bit for
  bit (exact, from precomputed window distances, and SHARDS-sampled),
  and the distinct-address sets.
* ``PhaseDetector``: the same events (window, tenant, reason, score
  exactly) on the features of scenario windows.
* The scenario builders: traces, labels, change targets, join and retire
  windows equal.
* ``ECICacheManager(phase_detect=True)`` through ``replay_scenario``:
  event logs, ``windows_analyzed``/``windows_run``, decisions and
  per-tenant latencies, including analyzes that re-count a
  multi-window span (``reconfig_interval > 1``).
"""
import numpy as np
import pytest
import torch

import repro.data.scenarios as scen_ref
import repro_torch.data.scenarios as scen
from repro.core import make_manager as make_manager_ref
from repro.core.characterize import PhaseDetector as PhaseDetectorRef
from repro.core.characterize import characterize_trace as char_trace_ref
from repro.core.characterize import characterize_windows as char_windows_ref
from repro.core.reuse_distance import reuse_distances as rd_ref
from repro_torch.core import (PhaseDetector, Trace, characterize_trace,
                              characterize_windows, make_manager,
                              reuse_distances)

SIM = dict(t_fast=1.0, t_slow=20.0, flush_cost=10.0)
FIELDS = ("stride_hist", "seq_fraction", "read_fraction", "write_ratio",
          "working_set", "jaccard_drift", "reuse_intensity", "sample_rates")


def _port(tr):
    return Trace(torch.as_tensor(tr.addrs), torch.as_tensor(tr.is_read),
                 tr.name)


def _same_features(got, want):
    for f in FIELDS:
        assert getattr(got, f).tolist() == np.asarray(getattr(want, f)
                                                      ).tolist(), f
    assert len(got.address_sets) == len(want.address_sets)
    for a, b in zip(got.address_sets, want.address_sets):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def windows():
    """Four windows of four tenants of the correlated scenario (reference
    traces), every tenant changing phase at window 2."""
    run = scen_ref.correlated(n_tenants=4, n_windows=4, switch_at=2,
                              n_base=500, seed=3)
    return [[run.traces[w][t] for t in range(4)] for w in range(4)]


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_characterize_trace_matches_reference(windows, rate):
    prev_ref = prev_port = None
    for w in range(3):
        tr = windows[w][1]
        want = char_trace_ref(tr, prev_ref, rate=rate)
        got = characterize_trace(_port(tr), prev_port, rate=rate)
        _same_features(got, want)
        prev_ref, prev_port = want.address_sets[0], got.address_sets[0]


@pytest.mark.parametrize("mode", ["links", "dists", "mixed", "sampled"])
def test_characterize_windows_matches_reference(windows, mode):
    prev_ref = [None] * 4
    prev_port = [None] * 4
    for w in range(4):
        trs = list(windows[w])
        trs[2] = scen_ref.Trace(trs[2].addrs[:0], trs[2].is_read[:0],
                                "empty") if w == 1 else trs[2]
        dists_ref = [rd_ref(t, "trd").distances for t in trs]
        pick = {"links": [], "dists": [0, 1, 2, 3], "mixed": [0, 3],
                "sampled": [1]}[mode]
        dr = [dists_ref[k] if k in pick else None for k in range(4)]
        dp = [None if d is None else torch.as_tensor(d) for d in dr]
        rate = 0.4 if mode == "sampled" else None
        want = char_windows_ref(trs, prev_sets=prev_ref, dists=dr,
                                sample_rate=rate, tenant_ids=[5, 6, 7, 8])
        got = characterize_windows([_port(t) for t in trs],
                                   prev_sets=prev_port, dists=dp,
                                   sample_rate=rate,
                                   tenant_ids=[5, 6, 7, 8])
        _same_features(got, want)
        prev_ref, prev_port = want.address_sets, got.address_sets
    # one row of the batch is the naive oracle's
    one = characterize_trace(_port(windows[0][0]))
    row = characterize_windows([_port(windows[0][0])])
    _same_features(row, char_trace_ref(windows[0][0]))
    _same_features(one, char_trace_ref(windows[0][0]))


def test_characterize_port_distances_equal_reference_distances(windows):
    tr = windows[0][0]
    got = reuse_distances(_port(tr), "trd").distances
    np.testing.assert_array_equal(got.numpy(), rd_ref(tr, "trd").distances)


@pytest.mark.parametrize("name", sorted(scen_ref.SCENARIOS))
def test_phase_detector_matches_reference(name):
    run = scen_ref.SCENARIOS[name](seed=1)
    det_ref = PhaseDetectorRef(w_threshold=0.5)
    det = PhaseDetector(w_threshold=0.5)
    prev_ref, prev_port = {}, {}
    n_events = 0
    for w in range(run.n_windows):
        ids = [t for t in range(run.n_tenants)
               if run.traces[w][t] is not None]
        trs = [run.traces[w][t] for t in ids]
        fr = char_windows_ref(trs, [prev_ref.get(t) for t in ids],
                              tenant_ids=ids)
        fp = characterize_windows([_port(t) for t in trs],
                                  [prev_port.get(t) for t in ids],
                                  tenant_ids=ids)
        _same_features(fp, fr)
        for k, t in enumerate(ids):
            prev_ref[t], prev_port[t] = fr.address_sets[k], fp.address_sets[k]
        er = det_ref.update(fr, w, ids)
        ep = det.update(fp, w, ids)
        assert [(e.window, e.tenant, e.reason, e.score) for e in ep] == \
            [(e.window, e.tenant, e.reason, e.score) for e in er]
        n_events += len(ep)
    assert n_events > 0
    with pytest.raises(ValueError):
        PhaseDetector(hi=0.1, lo=0.2)


@pytest.mark.parametrize("name", sorted(scen_ref.SCENARIOS))
def test_scenario_builders_match_reference(name):
    want = scen_ref.SCENARIOS[name](seed=2)
    got = scen.SCENARIOS[name](seed=2)
    assert (got.name, got.n_windows, got.tenant_names, got.aggressor) == \
        (want.name, want.n_windows, want.tenant_names, want.aggressor)
    for f in ("labels", "changes", "join_windows", "retire_windows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.true_changes() == want.true_changes()
    for w in range(want.n_windows):
        for t in range(want.n_tenants):
            a, b = want.traces[w][t], got.traces[w][t]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.addrs.numpy(), a.addrs)
                np.testing.assert_array_equal(b.is_read.numpy(), a.is_read)
                np.testing.assert_array_equal(got.access_labels(w, t),
                                              want.access_labels(w, t))


def _event_log(mgr):
    return [(e.window, e.tenant, e.reason, e.score) for e in mgr.events]


def _same_replay(a, ima, b, imb):
    assert _event_log(b) == _event_log(a)
    sa, sb = a.summary(), b.summary()
    for k in ("windows_analyzed", "windows_run", "reconfig_events",
              "tenant_windows"):
        assert sb[k] == sa[k], k
    assert len(a.history) == len(b.history)
    for da, db in zip(a.history, b.history):
        assert db.sizes.tolist() == np.asarray(da.sizes).tolist()
        assert [p.value for p in db.policies] == \
            [p.value for p in da.policies]
        assert [(e.window, e.tenant, e.reason) for e in db.trigger] == \
            [(e.window, e.tenant, e.reason) for e in da.trigger]
    assert imb == ima
    la = scen_ref.per_tenant_latency(a, ima)
    lb = scen.per_tenant_latency(b, imb)
    assert lb == pytest.approx(la, rel=1e-12)


@pytest.mark.parametrize("scenario,interval", [
    ("churn", 4), ("churn", 10**9), ("diurnal", 3), ("bursty", 1)])
def test_event_driven_manager_matches_reference(scenario, interval,
                                                monkeypatch):
    run_ref = scen_ref.SCENARIOS[scenario](seed=0)
    run = scen.SCENARIOS[scenario](seed=0)
    kw = dict(c_min=50, initial_blocks=50, phase_detect=True,
              reconfig_interval=interval, **SIM)
    recounts = []
    orig = make_manager("eci", 1, ["x"], device="cpu").analyze.__func__

    def analyze(self, window_trd=None, trigger=()):
        recounts.append(window_trd is None)
        return orig(self, window_trd, trigger)
    monkeypatch.setattr("repro_torch.core.manager.ECICacheManager.analyze",
                        analyze)
    a, ima = scen_ref.replay_scenario(
        run_ref, lambda names: make_manager_ref("eci", 2000, names, **kw))
    b, imb = scen.replay_scenario(
        run, lambda names: make_manager("eci", 2000, names, device="cpu",
                                        **kw))
    _same_replay(a, ima, b, imb)
    assert b.windows_analyzed < b.windows_run or interval == 1
    if interval in (3, 4):
        assert any(recounts), "no analyze re-counted a multi-window span"


@pytest.mark.parametrize("scheme", ["eci", "static"])
def test_scan_flood_isolation_matches_reference(scheme):
    args = dict(n_victims=2, n_windows=5, flood_at=2, n_victim=600,
                n_benign=300, cycle_base=300, cycle_step=100, seed=4)
    run_ref, run = scen_ref.scan_flood(**args), scen.scan_flood(**args)
    kw = dict(c_min=32, initial_blocks=32, **SIM)
    for excl in (frozenset(), {run.aggressor}):
        a, ima = scen_ref.replay_scenario(
            run_ref, lambda n: make_manager_ref(scheme, 900, n, **kw),
            exclude=excl)
        b, imb = scen.replay_scenario(
            run, lambda n: make_manager(scheme, 900, n, device="cpu", **kw),
            exclude=excl)
        _same_replay(a, ima, b, imb)
