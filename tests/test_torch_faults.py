"""The port's fault injection and degradation ladder against the JAX
reference's host-pipeline ladder, on the CPU.

Every case of ``tests/test_faults.py`` the port can run, fed the same
numpy-seeded tapes and the same ``FaultPlan`` (built field for field in
both packages): the disabled plan, each fault kind (poison in its three
modes, truncate, straggler, tier loss with demotion, cooldown and
recovery, the in-rung retry, the host -> per-tenant step-down, every
rung dead -> last-known-good, curve NaN / inf / URD corruption caught by
the guard, the intolerant manager's actuated violation, the sampled
exact retry), ``FaultPlan.standard`` reconvergence, the hypothesis chaos
suite, the three ``FAULT_SCENARIOS``, the serving tiers' pool and
host-tier crashes and the engine's abort and requeue.  Decisions, both
kinds of event (``DegradeEvent``, ``ReconfigEvent``) in order,
summaries, per-tenant counts and LRU states (dirty bits included) are
held exactly, latency floats to rel 1e-12; ``corrupt_traces`` gives the
reference's tapes element for element; the guard and ingest cases of the
reference's file give the same violations and errors.

The reference's device rung cannot run on this host (ROADMAP §3, R1), so
the port's device rung (``pipeline="device"`` on the CPU) is held to the
reference's host pipeline under the same plan: the same decisions, one
``device_stepdowns`` and one extra ``stepdown`` event.  Two cases pin the
port's one deliberate difference: the ladder steps down on
``InjectedFault`` only, and any other error at a rung propagates.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.data.scenarios as scen_ref
import repro_torch.core.monitor as pt_monitor
import repro_torch.data.scenarios as scen
from oracle import examples
from repro.cache import BlockPool as RefBlockPool
from repro.cache import TieredKVCache as RefTieredKVCache
from repro.core import ECICacheManager as RefManager
from repro.core import FaultPlan as RefPlan
from repro.core import FaultSpec as RefSpec
from repro.core import Trace as RefTrace
from repro.core import TraceError as RefTraceError
from repro.core import validate_decision as ref_validate
from repro.core import validate_trace_arrays as ref_validate_arrays
from repro.core.manager import AnalyzerDecision as RefDecision
from repro.core.partitioner import PartitionResult as RefPartition
from repro.core.write_policy import WritePolicy as RefPolicy
from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.core import (ECICacheManager, FaultPlan, FaultSpec,
                              InjectedFault, Trace, TraceError, WritePolicy,
                              validate_decision, validate_trace_arrays)
from repro_torch.core.manager import AnalyzerDecision, DegradeEvent
from repro_torch.core.partitioner import PartitionResult

SIM = dict(t_fast=1.0, t_slow=20.0)
CPU = "cpu"


# ------------------------------------------------------------- helpers
def raw_tape(seed: int, n: int = 400, spread: int = 120):
    rng = np.random.default_rng(seed)
    return rng.integers(0, spread, n), rng.random(n) < 0.6


def plans(specs, seed=1):
    """The same plan in both packages: ``specs`` are FaultSpec kwargs."""
    return (RefPlan(tuple(RefSpec(**s) for s in specs), seed=seed),
            FaultPlan(tuple(FaultSpec(**s) for s in specs), seed=seed))


def port_plan(ref_plan):
    return FaultPlan(tuple(FaultSpec(**dataclasses.asdict(s))
                           for s in ref_plan.specs), seed=ref_plan.seed)


def run_windows(mgr, n_windows, n_tenants=3, base=100):
    ref = isinstance(mgr, RefManager)
    for w in range(n_windows):
        traces = []
        for i in range(n_tenants):
            a, r = raw_tape(base + 10 * w + i)
            traces.append(RefTrace(a, r, f"t{i}") if ref else
                          Trace(torch.as_tensor(a), torch.as_tensor(r),
                                f"t{i}"))
        mgr.run_window(traces)
    return mgr


def managers(plan_pair=(None, None), capacity=6000, names=("a", "b", "c"),
             ref_kw=None, **kw):
    kw.setdefault("c_min", 500)
    ref = RefManager(capacity, list(names), faults=plan_pair[0], **SIM,
                     **{**kw, **(ref_kw or {})})
    port = ECICacheManager(capacity, list(names), faults=plan_pair[1],
                           device=CPU, **SIM, **kw)
    return ref, port


def run_both(specs=(), n_windows=6, seed=1, n_tenants=3, base=100,
             **kw):
    ref, port = managers(plans(specs, seed) if specs is not None
                         else (None, None),
                         names=[f"t{i}" for i in range(n_tenants)], **kw)
    run_windows(ref, n_windows, n_tenants, base)
    run_windows(port, n_windows, n_tenants, base)
    return ref, port


def event_log(mgr) -> list:
    return [(type(e).__name__, *dataclasses.astuple(e)) for e in mgr.events]


def degrade_events(mgr, reason=None):
    evs = [e for e in mgr.events if type(e).__name__ == "DegradeEvent"]
    return evs if reason is None else [e for e in evs if e.reason == reason]


def decision_key(d) -> tuple:
    return (np.asarray(d.sizes).tolist(),
            None if d.sizes2 is None else np.asarray(d.sizes2).tolist(),
            [p.value for p in d.policies],
            None if d.policies2 is None else [p.value for p in d.policies2],
            bool(d.feasible), bool(d.quarantined), d.degraded,
            tuple(d.held), tuple(d.deferred), tuple(d.guard),
            [(e.window, e.tenant, e.reason) for e in d.trigger])


def same_summary(got: dict, want: dict, skip=()) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if k in skip:
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert got[k] == v, k


def assert_same(ref, port, skip_summary=()) -> None:
    """Decisions, events, summaries, per-tenant counts and LRU states."""
    assert len(ref.history) == len(port.history)
    for w, (dr, dp) in enumerate(zip(ref.history, port.history)):
        assert decision_key(dp) == decision_key(dr), w
        assert dp.partition.latency == pytest.approx(
            dr.partition.latency, rel=1e-12, abs=0, nan_ok=True), w
    assert event_log(port) == event_log(ref)
    same_summary(port.summary(), ref.summary(), skip_summary)
    for tr, tp in zip(ref.tenants, port.tenants):
        a, b = dataclasses.asdict(tr.result), dataclasses.asdict(tp.result)
        lat_a, lat_b = a.pop("total_latency"), b.pop("total_latency")
        assert a == b
        assert lat_b == pytest.approx(lat_a, rel=1e-12, abs=0)
        for cr, cp in ((tr.cache, tp.cache), (tr.cache2, tp.cache2)):
            ra, rd = cr.state_arrays()
            pa, pd = cp.state_arrays()
            np.testing.assert_array_equal(pa.numpy(), ra)
            np.testing.assert_array_equal(pd.numpy(), rd)
            assert cp.capacity == cr.capacity


# ===================================================== guard and ingest
def _ref_decision(sizes, policies=None, latency=0.0, hit_ratios=None,
                  sizes2=None, policies2=None):
    sizes = np.asarray(sizes)
    policies = policies or [RefPolicy.WB] * len(sizes)
    hr = (np.zeros(len(sizes)) if hit_ratios is None
          else np.asarray(hit_ratios, dtype=np.float64))
    return RefDecision(sizes, policies, True,
                       RefPartition(sizes, True, latency, hr),
                       sizes2=sizes2, policies2=policies2)


def _port_decision(sizes, policies=None, latency=0.0, hit_ratios=None,
                   sizes2=None, policies2=None):
    sizes = torch.as_tensor(np.asarray(sizes))
    policies = policies or [WritePolicy.WB] * len(sizes)
    hr = (torch.zeros(len(sizes), dtype=torch.float64) if hit_ratios is None
          else torch.as_tensor(np.asarray(hit_ratios, dtype=np.float64)))
    return AnalyzerDecision(sizes, policies, True,
                            PartitionResult(sizes, True, latency, hr),
                            sizes2=(None if sizes2 is None
                                    else torch.as_tensor(sizes2)),
                            policies2=policies2)


GUARD_CASES = {
    "clean": (dict(sizes=[10, 20, 30]), dict(capacity=100)),
    "over": (dict(sizes=[60, 60]), dict(capacity=100)),
    "negative": (dict(sizes=[-5, 10]), dict(capacity=100)),
    "nan": (dict(sizes=[np.nan, 10]), dict(capacity=100)),
    "inf": (dict(sizes=[np.inf, 10]), dict(capacity=100)),
    "l2_no_level": (dict(sizes=[10], sizes2=np.array([999])),
                    dict(capacity=100, capacity2=0)),
    "l2_over": (dict(sizes=[10], sizes2=np.array([999])),
                dict(capacity=100, capacity2=50)),
    "latency": (dict(sizes=[10], latency=np.nan), dict(capacity=100)),
    "hr_inf": (dict(sizes=[10], hit_ratios=[np.inf]), dict(capacity=100)),
    "hr_range": (dict(sizes=[10], hit_ratios=[1.5]), dict(capacity=100)),
    "floor": (dict(sizes=[5, 50]),
              dict(capacity=100, floors=np.array([20, 20]))),
    "floor_budget": (dict(sizes=[5, 50]),
                     dict(capacity=100, floors=np.array([20, 20]),
                          floor_budget=30)),
    "floor_corrupt": (dict(sizes=[5, 50]),
                      dict(capacity=100, floors=np.array([-7, 0]))),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_cases_match_reference(case):
    dkw, vkw = GUARD_CASES[case]
    pol2 = ({"policies2": [RefPolicy.WB]} if "sizes2" in dkw else {},
            {"policies2": [WritePolicy.WB]} if "sizes2" in dkw else {})
    want = ref_validate(_ref_decision(**dkw, **pol2[0]), **vkw)
    got = validate_decision(_port_decision(**dkw, **pol2[1]),
                            **{k: (torch.as_tensor(v) if k == "floors"
                                   else v) for k, v in vkw.items()})
    assert got.violations == want.violations
    assert got.ok == (case in ("clean", "l2_no_level", "floor_budget"))


@pytest.mark.parametrize("addrs,reads", [
    (np.array([[1]]), np.array([[True]])),
    (np.array([1, 2]), np.array([True])),
    (np.array([1.5]), np.array([True])),
    (np.array([-3]), np.array([True])),
    (np.array([1]), np.array([1.0])),
    (np.array([1, 2]), np.array([1, 2], np.int8)),
])
def test_ingest_validator_matches_reference(addrs, reads):
    with pytest.raises(RefTraceError) as want:
        ref_validate_arrays(addrs, reads, tenant=7, window=13)
    with pytest.raises(TraceError) as got:
        validate_trace_arrays(addrs, reads, tenant=7, window=13)
    assert (got.value.tenant, got.value.window) == (7, 13)
    assert str(got.value).endswith("(tenant=7, window=13)")
    assert type(want.value).__name__ == type(got.value).__name__


def test_manager_record_raises_with_coordinates():
    ref, port = run_both(None, n_windows=2)
    with pytest.raises(TraceError) as ei:
        port.record(1, np.array([-1]), np.array([True]))
    assert ei.value.tenant == 1 and ei.value.window == 2


def test_injected_fault_and_spec_validation():
    assert issubclass(InjectedFault, RuntimeError)
    with pytest.raises(ValueError):
        FaultSpec("bogus", window=0)
    with pytest.raises(ValueError):
        FaultSpec("poison", window=0, duration=0)
    with pytest.raises(ValueError, match="8 windows"):
        FaultPlan.standard(3, 7)


# ================================================== trace corruption
@pytest.mark.parametrize("specs", [
    [dict(kind="poison", window=2, tenant=0, param=0.0)],
    [dict(kind="poison", window=2, tenant=1, param=1.0)],
    [dict(kind="poison", window=2, tenant=2, param=2.0)],
    [dict(kind="truncate", window=2, tenant=0, param=0.5)],
    [dict(kind="truncate", window=2, tenant=1, param=0.0)],
    [dict(kind="poison", window=1, tenant=0, duration=3),
     dict(kind="poison", window=2, tenant=1, param=1.0),
     dict(kind="truncate", window=2, tenant=0, param=0.25),
     dict(kind="truncate", window=2, tenant=3)],
])
def test_corrupt_traces_gives_the_references_tapes(specs):
    ref, port = plans(specs, seed=5)
    raw = [raw_tape(40 + i, n=37 + 11 * i) for i in range(3)]
    raw.append((np.zeros(0, np.int64), np.zeros(0, bool)))
    for w in range(4):
        want = ref.corrupt_traces(
            [RefTrace(a, r, f"t{i}") for i, (a, r) in enumerate(raw)]
            + [None], w)
        got = port.corrupt_traces(
            [Trace(torch.as_tensor(a), torch.as_tensor(r), f"t{i}")
             for i, (a, r) in enumerate(raw)] + [None], w)
        assert got[-1] is None and want[-1] is None
        for g, t in zip(got[:-1], want[:-1]):
            assert g.name == t.name
            np.testing.assert_array_equal(g.addrs.numpy(), t.addrs)
            np.testing.assert_array_equal(g.is_read.numpy(), t.is_read)
            assert str(g.addrs.dtype).split(".")[-1] == str(t.addrs.dtype)
            assert str(g.is_read.dtype).split(".")[-1] == \
                str(t.is_read.dtype)


# ===================================== default-off bit-identity contract
def test_disabled_plan_is_bit_identical():
    _, base = managers()
    _, off = managers((None, FaultPlan((), seed=3)))
    ref, _ = managers((RefPlan((), seed=3), None))
    for m in (base, off, ref):
        run_windows(m, 8)
    assert off.fault_tolerant and not base.fault_tolerant
    same_summary(off.summary(), base.summary())
    assert [decision_key(d) for d in off.history] == \
        [decision_key(d) for d in base.history]
    for tb, to in zip(base.tenants, off.tenants):
        assert tb.cache.capacity == to.cache.capacity
        assert tb.policy is to.policy
    assert off.summary()["degrade_events"] == 0
    assert_same(ref, off)


# ====================== each fault kind against the reference's ladder
def test_poison_counts_once_and_quarantines_tenant_window():
    ref, port = run_both([dict(kind="poison", window=2, tenant=1)],
                         n_windows=5)
    assert_same(ref, port)
    s = port.summary()
    assert s["poisoned_windows"] == 1 and s["degrade_events"] == 1
    (ev,) = degrade_events(port, "poisoned")
    assert ev.window == 2 and ev.tenant == 1
    assert s["guard_violations_actuated"] == 0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_poison_modes_match_reference(mode):
    ref, port = run_both([dict(kind="poison", window=1, tenant=0,
                               param=float(mode), duration=2)], n_windows=5)
    assert_same(ref, port)
    assert port.summary()["poisoned_windows"] == 2


def test_truncate_matches_reference():
    ref, port = run_both([dict(kind="truncate", window=2, tenant=2,
                               param=0.5)], n_windows=4)
    assert_same(ref, port)
    assert port.summary()["accesses"] == 4 * 3 * 400 - 200


def test_straggler_counts_per_window_and_defers():
    ref, port = run_both([dict(kind="straggler", window=1, tenant=0,
                               duration=2)], n_windows=5)
    assert_same(ref, port)
    s = port.summary()
    assert s["straggler_windows"] == 2
    assert [e.window for e in degrade_events(port, "straggler")] == [1, 2]
    held = port.history[1]
    assert held.held == (0,) and 0 in held.deferred


def test_tier_loss_counts_once_with_dirty_blocks_and_recovery():
    ref, port = run_both([dict(kind="tier_loss", window=3, level=1,
                               duration=2)], n_windows=9)
    assert_same(ref, port)
    s = port.summary()
    assert s["tier_failures"] == 1
    (loss,) = degrade_events(port, "tier_loss")
    (rec,) = degrade_events(port, "tier_recover")
    assert loss.window == 3 and loss.level == 1 and rec.window == 5
    assert s["dirty_loss"] == loss.blocks > 0
    assert all(sz == 0 for sz in port.history[3].sizes.tolist())
    assert any(sz > 0 for sz in port.history[8].sizes.tolist())


def test_tier_loss_demotes_wb_for_cooldown_then_restores():
    ref, port = run_both([dict(kind="tier_loss", window=3, level=1)],
                         n_windows=9, demote_cooldown=2)
    assert_same(ref, port)
    pol = [d.policies[0] for d in port.history]
    assert pol[2] is WritePolicy.WB
    assert pol[3] is pol[4] is pol[5] is WritePolicy.WT
    assert pol[6] is WritePolicy.WB


def test_l2_tier_loss_matches_reference():
    """An ETICA manager losing its second level: the L2 budget is 0 and
    the greedy partitions both levels while it is down."""
    ref, port = run_both([dict(kind="tier_loss", window=2, level=2,
                               duration=2)], n_windows=7, capacity2=3000,
                         demote_cooldown=1)
    assert_same(ref, port)
    assert all(v == 0 for v in port.history[2].sizes2.tolist())
    assert port.summary()["tier_failures"] == 1


def test_pipeline_retry_succeeds_in_rung_without_stepdown():
    ref, port = run_both([dict(kind="pipeline", window=2, rung="host",
                               count=1)], n_windows=5, retry_limit=2)
    assert_same(ref, port)
    s = port.summary()
    assert s["host_stepdowns"] == 0 and s["lkg_decisions"] == 0
    assert s["degrade_events"] == 0


def test_pipeline_exhaustion_steps_down_to_per_tenant_rung():
    ref, port = run_both([dict(kind="pipeline", window=2, rung="host",
                               count=99)], n_windows=5, retry_limit=1)
    assert_same(ref, port)
    s = port.summary()
    assert s["host_stepdowns"] == 1
    (ev,) = degrade_events(port, "stepdown")
    assert ev.window == 2 and ev.rung == "host"
    assert not port.history[2].quarantined
    assert s["guard_violations_actuated"] == 0


def test_all_rungs_dead_falls_back_to_last_known_good():
    ref, port = run_both([dict(kind="pipeline", window=2, count=99)],
                         n_windows=5, retry_limit=0)
    assert_same(ref, port)
    s = port.summary()
    assert s["host_stepdowns"] == 1 and s["tenant_quarantines"] == 3
    assert s["lkg_decisions"] == 1
    dec = port.history[2]
    assert dec.quarantined and dec.degraded == "monitor_outage"
    assert dec.sizes.tolist() == port.history[1].sizes.tolist()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_curve_corruption_quarantined_by_guard(mode):
    ref, port = run_both([dict(kind="curve_nan", window=3, tenant=1,
                               param=float(mode))], n_windows=6)
    assert_same(ref, port)
    s = port.summary()
    assert s["guard_quarantines"] == 1 and s["lkg_decisions"] == 1
    assert s["guard_violations_observed"] >= 1
    assert s["guard_violations_actuated"] == 0
    dec = port.history[3]
    assert dec.quarantined and dec.degraded == "guard_quarantine"
    assert len(dec.guard) >= 1
    assert dec.policies[1] is port.history[2].policies[1]


def test_curve_corruption_on_the_per_tenant_rung():
    """The curve fault lands on a solo curve of the per-tenant rung (the
    reference's ``curves[k].heights[:]`` branch)."""
    ref, port = run_both([dict(kind="pipeline", window=3, rung="host",
                               count=99),
                          dict(kind="curve_nan", window=3, tenant=2)],
                         n_windows=5, retry_limit=0)
    assert_same(ref, port)
    assert port.summary()["guard_quarantines"] == 1


def test_intolerant_manager_counts_actuated_violations():
    ref, port = run_both([dict(kind="curve_nan", window=3, tenant=1)],
                         n_windows=6, fault_tolerant=False)
    assert_same(ref, port)
    s = port.summary()
    assert s["guard_violations_actuated"] == 1
    assert s["guard_quarantines"] == 0
    assert len(port.history[3].guard) >= 1


def test_sampled_violation_retries_exact_before_quarantine():
    ref, port = run_both([dict(kind="curve_nan", window=3, tenant=0)],
                         n_windows=6, sample_rate=0.3)
    assert_same(ref, port)
    s = port.summary()
    assert s["sampled_exact_retries"] == 1
    assert s["guard_quarantines"] == 1
    assert s["guard_violations_actuated"] == 0


# =========================================== the device rung (fault R1)
def _device_vs_host(specs, n_windows, **kw):
    """The port's device rung on the CPU against the reference's host
    pipeline under the same plan: the decisions are equal; the port adds
    one ``device`` step-down per window its device specs kill."""
    ref, port = managers(plans(specs), ref_kw=dict(pipeline="host"),
                         pipeline="device", **kw)
    run_windows(ref, n_windows)
    run_windows(port, n_windows)
    extra = [e for e in port.events
             if isinstance(e, DegradeEvent) and e.rung == "device"]
    rest = [(type(e).__name__, *dataclasses.astuple(e)) for e in port.events
            if not (isinstance(e, DegradeEvent) and e.rung == "device")]
    assert rest == event_log(ref)
    assert [decision_key(d) for d in port.history] == \
        [decision_key(d) for d in ref.history]
    same_summary(port.summary(), ref.summary(),
                 skip=("device_stepdowns", "degrade_events"))
    s, sr = port.summary(), ref.summary()
    assert s["device_stepdowns"] == len(extra)
    assert s["degrade_events"] == sr["degrade_events"] + len(extra)
    return port, extra


def test_device_rung_failure_steps_down_to_host():
    port, extra = _device_vs_host(
        [dict(kind="pipeline", window=2, rung="device", count=99)], 4,
        retry_limit=1)
    s = port.summary()
    assert s["device_stepdowns"] == 1 and s["host_stepdowns"] == 0
    assert [(e.window, e.reason) for e in extra] == [(2, "stepdown")]
    assert not port.history[2].quarantined


def test_device_rung_under_the_standard_plan():
    """The chip smoke's fault plan at a small size: the standard plan, an
    in-rung device retry at window 2 and a dead device rung at window 5
    (which lets the standard plan's host spec kill the host rung too)."""
    base = RefPlan.standard(3, 8, seed=0)
    specs = [dataclasses.asdict(s) for s in base.specs] + [
        dict(kind="pipeline", window=2, rung="device", count=1),
        dict(kind="pipeline", window=5, rung="device", count=99)]
    port, extra = _device_vs_host(specs, 10, demote_cooldown=2)
    s = port.summary()
    assert s["device_stepdowns"] == 1 and s["host_stepdowns"] == 1
    assert [(e.window, e.rung) for e in extra] == [(5, "device")]
    assert s["dirty_loss"] > 0 and s["poisoned_windows"] > 0
    assert s["straggler_windows"] > 0 and s["tier_failures"] > 0
    assert s["guard_violations_actuated"] == 0


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: unspecified launch failure"),
    ImportError("cannot import name 'enable_x64'"),
    torch.OutOfMemoryError("CUDA out of memory"),
])
def test_non_injected_error_at_the_device_rung_propagates(monkeypatch,
                                                           error):
    """A kernel that fails to build or launch is not a rung failure: the
    error reaches the caller with its traceback, no step-down."""
    def broken(*a, **k):
        raise error
    monkeypatch.setattr(pt_monitor, "monitor_window_device", broken)
    _, port = managers(fault_tolerant=True, pipeline="device")
    with pytest.raises(type(error), match=str(error)[:10]):
        run_windows(port, 1)
    assert port.summary()["device_stepdowns"] == 0
    assert not degrade_events(port)


def test_injected_fault_at_the_device_rung_steps_down(monkeypatch):
    calls = []

    def dead(*a, **k):
        calls.append(1)
        raise InjectedFault("device rung down")
    monkeypatch.setattr(pt_monitor, "monitor_window_device", dead)
    ref, port = managers(fault_tolerant=True, pipeline="device",
                         ref_kw=dict(pipeline="host"), retry_limit=1)
    run_windows(ref, 2)
    run_windows(port, 2)
    assert len(calls) == 4                  # 2 attempts a window
    assert port.summary()["device_stepdowns"] == 2
    assert [decision_key(d) for d in port.history] == \
        [decision_key(d) for d in ref.history]


def test_the_sampled_exact_retry_catches_nothing(monkeypatch):
    """The reference's ``except Exception: report = None`` around the
    exact retry is gone: an error there propagates."""
    import repro_torch.core.manager as pt_manager
    plan = FaultPlan((FaultSpec("curve_nan", window=1, tenant=0),), seed=1)
    port = ECICacheManager(6000, ["a", "b", "c"], c_min=500,
                           sample_rate=0.3, faults=plan, device=CPU, **SIM)
    run_windows(port, 1)
    real = pt_manager.analyze_windows

    def exact_fails(traces, **kw):
        if kw.get("sample_rate") is None:
            raise RuntimeError("exact pass failed")
        return real(traces, **kw)
    monkeypatch.setattr(pt_manager, "analyze_windows", exact_fails)
    with pytest.raises(RuntimeError, match="exact pass failed"):
        run_windows(port, 1, base=110)


def test_trace_error_in_the_ladder_propagates(monkeypatch):
    def bad(*a, **k):
        raise TraceError("bad tape", 0, 0)
    monkeypatch.setattr(pt_monitor, "monitor_window_device", bad)
    _, port = managers(fault_tolerant=True, pipeline="device")
    with pytest.raises(TraceError):
        run_windows(port, 1)


# ======================================================== reconvergence
def _final_state(mgr):
    return ([t.cache.capacity for t in mgr.tenants],
            [t.policy.value for t in mgr.tenants])


def test_standard_plan_reconverges_within_k():
    rplan = RefPlan.standard(3, 8, seed=1)
    k = rplan.reconverge_bound(demote_cooldown=2)
    n = rplan.last_fault_window() + k + 1
    ref, port = managers((rplan, port_plan(rplan)))
    run_windows(ref, n)
    run_windows(port, n)
    assert_same(ref, port)
    _, base = managers()
    run_windows(base, n)
    assert _final_state(base) == _final_state(port)
    assert port.summary()["guard_violations_actuated"] == 0


@settings(max_examples=examples(10), deadline=None)
@given(st.integers(0, 10**6))
def test_chaos_matches_reference_and_reconverges(seed):
    """Random fault schedules: the port's ladder takes the reference's
    every step (decisions, events, counters), never actuates garbage and
    reconverges to the fault-free run."""
    rplan = RefPlan.chaos(3, 12, seed=seed, max_faults=4)
    n = rplan.last_fault_window() + rplan.reconverge_bound(2) + 1
    ref, port = managers((rplan, port_plan(rplan)))
    run_windows(ref, n, base=seed % 1000)
    run_windows(port, n, base=seed % 1000)
    assert_same(ref, port)
    assert port.summary()["guard_violations_actuated"] == 0
    _, base = managers()
    run_windows(base, n, base=seed % 1000)
    assert _final_state(base) == _final_state(port)
    for d in port.history:
        if not d.quarantined:
            assert validate_decision(d, port.capacity, port.capacity2).ok


# ================================================== the fault scenarios
EXPECTED_FINGERPRINT = {"faulted_tier_loss": "dirty_loss",
                        "faulted_straggler_burst": "straggler_windows",
                        "faulted_poisoned_join": "poisoned_windows"}


@pytest.mark.parametrize("name", sorted(EXPECTED_FINGERPRINT))
def test_fault_scenarios_match_reference(name):
    """``benchmarks/bench_faults.py``'s settings (capacity 8192, c_min
    256, demote_cooldown 2, seed 0) through ``replay_scenario``."""
    want = scen_ref.FAULT_SCENARIOS[name](seed=0)
    got = scen.FAULT_SCENARIOS[name](seed=0)
    assert got.name == want.name and got.description == want.description
    assert got.plan == port_plan(want.plan)
    np.testing.assert_array_equal(np.asarray(got.run.join_windows),
                                  np.asarray(want.run.join_windows))
    kw = dict(c_min=256, initial_blocks=256, demote_cooldown=2, **SIM)
    ref, imr = scen_ref.replay_scenario(
        want.run, lambda names: RefManager(8192, names, faults=want.plan,
                                           **kw))
    port, imp = scen.replay_scenario(
        got.run, lambda names: ECICacheManager(8192, names, faults=got.plan,
                                               device=CPU, **kw))
    assert imp == imr
    assert_same(ref, port)
    s = port.summary()
    assert s[EXPECTED_FINGERPRINT[name]] > 0
    assert s["guard_violations_actuated"] == 0
    lat_r = scen_ref.per_tenant_latency(ref, imr)
    lat_p = scen.per_tenant_latency(port, imp)
    assert lat_p == pytest.approx(lat_r, rel=1e-12)


# ============================================== serving tiers + engine
def _tiered_pair(capacity=64, capacity2=128, n_pages=64):
    kw = dict(c_min=4, capacity2=capacity2, fault_tolerant=True,
              demote_cooldown=1, **SIM)
    rm = RefManager(capacity, ["a", "b"], **kw)
    pm = ECICacheManager(capacity, ["a", "b"], device=CPU, **kw)
    rt = RefTieredKVCache(RefBlockPool(n_pages, 16, 1, 1, 8,
                                       allocate_device=False), rm,
                          window_events=10**9)
    pt = TieredKVCache(BlockPool(n_pages, 16, 1, 1, 8,
                                 allocate_device=False), pm,
                       window_events=10**9)
    return rt, pt


def _tier_state(tk) -> tuple:
    s = dict(tk.summary())
    s.pop("rebalance_seconds")
    pool = tk.pool
    return (s, list(pool.free), dict(pool.by_key),
            {t: list(q) for t, q in pool.lru.items()},
            {t: list(q) for t, q in tk.host_lru.items()},
            {i: p.value for i, p in tk.policies.items()},
            [dataclasses.astuple(x) for x in tk.stats])


def test_pool_crash_drops_dirty_and_reroutes():
    rt, pt = _tiered_pair()
    for tk in (rt, pt):
        for k in range(20):
            tk.access_page(0, ("a", k), fresh=True)
            tk.access_page(1, ("b", k), fresh=True)
    out = pt.fail_tier(1)
    assert out == rt.fail_tier(1) == {"dropped": 40, "dirty": 40}
    assert _tier_state(pt) == _tier_state(rt)
    assert pt.tier_down(1) and not pt.pool.meta and not pt.pool.by_key
    assert len(pt.pool.free) == pt.pool.n_pages
    assert all(p is WritePolicy.WT for p in pt.policies.values())
    assert pt.manager.summary()["dirty_loss"] == 40
    for tk, wb in ((rt, RefPolicy.WB), (pt, WritePolicy.WB)):
        assert tk.access_page(0, ("a", 100), fresh=True) == "host"
        assert tk.access_page(0, ("a", 100), fresh=False) == "host"
        tk.policies[1] = wb              # a WB admission while L1 is down
        assert tk.access_page(1, ("b", 100), fresh=True) == "host"
    assert not pt.pool.meta
    assert _tier_state(pt) == _tier_state(rt)
    assert pt.fail_tier(1) == rt.fail_tier(1) == {"dropped": 0, "dirty": 0}
    pt.recover_tier(1)
    rt.recover_tier(1)
    assert not pt.tier_down(1)
    for tk in (rt, pt):
        for k in range(8):
            tk.access_page(1, ("b", k), fresh=k % 2 == 0)
        tk.rebalance()
    assert _tier_state(pt) == _tier_state(rt)
    assert event_log(pt.manager) == event_log(rt.manager)
    assert [decision_key(d) for d in pt.manager.history] == \
        [decision_key(d) for d in rt.manager.history]
    s = pt.summary()
    assert s["tier_failures"] == 1 and s["dropped_pages"] == 40
    assert s["dirty_loss"] == 40 and s["rerouted_writes"] == 1


def test_host_tier_crash_requires_managed_and_drops_pages():
    rt, pt = _tiered_pair()
    for tk in (rt, pt):
        for k in range(10):
            tk._host_insert(0, ("a", k))
    out = pt.fail_tier(2)
    assert out == rt.fail_tier(2)
    assert out["dropped"] == 10 and out["dirty"] == 0
    assert not pt._host_materialized(0, ("a", 1))
    pt._host_insert(0, ("a", 99))
    rt._host_insert(0, ("a", 99))
    assert sum(len(q) for q in pt.host_lru.values()) == 0
    assert _tier_state(pt) == _tier_state(rt)
    pt.recover_tier(2)
    rt.recover_tier(2)
    assert _tier_state(pt) == _tier_state(rt)
    assert event_log(pt.manager) == event_log(rt.manager)

    _, pt2 = _tiered_pair(capacity2=0)
    with pytest.raises(ValueError, match="managed host"):
        pt2.fail_tier(2)
    with pytest.raises(ValueError, match="unknown tier"):
        pt2.fail_tier(3)


# ------------------------------------------ the engine's abort and requeue
_init_jax = jax.jit(__import__("repro.models.model",
                               fromlist=["init_params"]).init_params,
                    static_argnums=0)


def _pool_crash_serve(engine_cls, request_cls, pool, tiered, cfg, params,
                      prompt):
    """tests/test_faults.py's sequence: a step, the crash, two steps
    down, the recovery, then the rest."""
    eng = engine_cls(cfg, params, tiered, page_size=8, max_pages_per_seq=16)
    eng.submit(request_cls(tenant=0, prompt=prompt, max_new_tokens=6))
    eng.step()
    trace = [(len(eng.active), len(eng.waiting), len(eng.completed))]
    tiered.fail_tier(1)
    eng.step()
    trace.append((len(eng.active), len(eng.waiting), eng.aborted_restarts))
    eng.step()
    trace.append((len(eng.active), len(eng.waiting), len(eng.completed)))
    tiered.recover_tier(1)
    eng.run(32)
    return eng, trace


@lru_cache(maxsize=None)
def _reference_requeue():
    from repro.configs import get_smoke_config
    from repro.models.attention import build_heads as ref_heads
    from repro.serve.engine import MultiTenantEngine, Request
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    params = _init_jax(cfg, jax.random.PRNGKey(0))
    _, hkv = ref_heads(cfg, 1)
    mgr = RefManager(128, ["t0"], c_min=8, initial_blocks=32,
                     fault_tolerant=True, **SIM)
    pool = RefBlockPool(256, 8, cfg.n_layers, hkv, cfg.head_dim,
                        dtype=jnp.float32)
    tiered = RefTieredKVCache(pool, mgr, window_events=10**9)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 16).astype(np.int32)
    eng, trace = _pool_crash_serve(MultiTenantEngine, Request, pool, tiered,
                                   cfg, params, prompt)
    return (jax.tree.map(np.asarray, params), prompt, trace,
            [list(r.generated) for r in eng.completed],
            eng.aborted_restarts, _tier_state(tiered), event_log(mgr))


def test_engine_aborts_and_requeues_over_pool_crash():
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.engine import MultiTenantEngine, Request
    params_np, prompt, trace, tokens, restarts, state, events = \
        _reference_requeue()
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    mgr = ECICacheManager(128, ["t0"], c_min=8, initial_blocks=32,
                          fault_tolerant=True, device=CPU, **SIM)
    pool = BlockPool(256, 8, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.float32, device=CPU)
    tiered = TieredKVCache(pool, mgr, window_events=10**9)
    eng, got = _pool_crash_serve(MultiTenantEngine, Request, pool, tiered,
                                 cfg, M.params_from_jax(params_np, CPU),
                                 prompt.copy())
    assert got == trace == [(1, 0, 0), (0, 1, 1), (0, 1, 0)]
    assert eng.aborted_restarts == restarts == 1
    assert [list(r.generated) for r in eng.completed] == tokens
    assert len(tokens) == 1 and len(tokens[0]) == 6
    assert _tier_state(tiered) == state
    assert event_log(mgr) == events
