"""The port's remaining comparison schemes against the JAX reference.

* ``static`` and ``reuse_intensity`` partitions on the cases of
  ``tests/test_baselines_budget.py`` (random small curves, the
  intensity-skew regression): sizes exactly, hit ratios bit for bit.
* ``make_manager("static" | "reuse_intensity")`` and
  ``GlobalLRUManager`` over 3 windows of 16 MSR tenants x 400 accesses,
  against the reference window by window: sizes, policies, per-tenant
  counts exactly, latencies to rel 1e-12, final LRU states.
"""
import numpy as np
import pytest
import torch

from repro.core import GlobalLRUManager as GlobalLRUManagerRef
from repro.core import Trace as TraceRef
from repro.core import build_hit_ratio_function as build_ref
from repro.core import make_manager as make_manager_ref
from repro.core import reuse_distances as reuse_distances_ref
from repro.core.baselines import SCHEMES as SCHEMES_REF
from repro.core.baselines import _reuse_intensity_partition as ri_ref
from repro.core.baselines import _static_partition as static_ref
from repro.data.traces import msr_trace as msr_trace_ref
from repro_torch.core import (SCHEMES, GlobalLRUManager, Trace,
                              build_hit_ratio_function, make_manager,
                              reuse_distances)
from repro_torch.core.baselines import (_reuse_intensity_partition,
                                        _static_partition)
from repro_torch.data.traces import MSR_PROFILES, msr_trace

SIM = dict(t_fast=1.0, t_slow=20.0, flush_cost=10.0)
NAMES16 = list(MSR_PROFILES)


def _curves(seed, n):
    """test_baselines_budget's random curves, built by both packages."""
    rng = np.random.default_rng(seed)
    ref, port = [], []
    for _ in range(n):
        ln = int(rng.integers(1, 80))
        addrs = rng.integers(0, max(int(rng.integers(1, 12)), 1),
                             ln).astype(np.int64)
        reads = rng.random(ln) < 0.7
        ref.append(build_ref(reuse_distances_ref(TraceRef(addrs, reads),
                                                 "urd")))
        port.append(build_hit_ratio_function(reuse_distances(
            Trace(torch.as_tensor(addrs), torch.as_tensor(reads)), "urd")))
    return ref, port


def _same_partition(got, want):
    assert got.sizes.tolist() == np.asarray(want.sizes).tolist()
    assert got.feasible == want.feasible
    assert got.hit_ratios.tolist() == np.asarray(want.hit_ratios).tolist()
    assert got.latency == pytest.approx(want.latency, rel=1e-12)


@pytest.mark.parametrize("seed,n,capacity,c_min", [
    (0, 1, 0, 0), (1, 3, 17, 5), (2, 8, 200, 60), (3, 5, 101, 0),
    (4, 7, 13, 30), (5, 2, 10, 5), (6, 8, 199, 9), (7, 4, 64, 16)])
def test_baseline_partitions_match_reference(seed, n, capacity, c_min):
    ref, port = _curves(seed, n)
    _same_partition(_static_partition(port, capacity, 1.0, 20.0),
                    static_ref(ref, capacity, 1.0, 20.0))
    got = _reuse_intensity_partition(port, capacity, 1.0, 20.0, c_min=c_min)
    _same_partition(got, ri_ref(ref, capacity, 1.0, 20.0, c_min=c_min))
    assert int(got.sizes.sum()) == capacity


def test_reuse_intensity_skew_regression_matches_reference():
    rng = np.random.default_rng(0)
    heavy = (rng.integers(0, 4, 400).astype(np.int64), np.ones(400, bool))
    light = (np.array([0, 1, 0], np.int64), np.ones(3, bool))
    ref = [build_ref(reuse_distances_ref(TraceRef(a, r), "urd"))
           for a, r in (heavy, light)]
    port = [build_hit_ratio_function(reuse_distances(
        Trace(torch.as_tensor(a), torch.as_tensor(r)), "urd"))
        for a, r in (heavy, light)]
    got = _reuse_intensity_partition(port, 10, 1.0, 20.0, c_min=5)
    _same_partition(got, ri_ref(ref, 10, 1.0, 20.0, c_min=5))
    assert got.sizes.tolist() == [5, 5]


def test_schemes_and_factory_checks():
    assert SCHEMES == SCHEMES_REF
    with pytest.raises(ValueError, match="unknown scheme"):
        make_manager("lfu", 100, NAMES16[:2], device="cpu")
    with pytest.raises(ValueError, match="capacity2"):
        make_manager("etica", 100, NAMES16[:2], device="cpu")


def _windows(w, pkg_trace):
    return [pkg_trace(nm, 400, seed=1000 * w + i)
            for i, nm in enumerate(NAMES16)]


def _same_results(ra, rb):
    for x, y in zip(ra, rb):
        for f in ("reads", "read_hits", "writes", "write_hits",
                  "cache_writes", "capacity", "policy"):
            assert getattr(x, f) == getattr(y, f), f
        assert y.total_latency == pytest.approx(x.total_latency, rel=1e-12)


def _same_state(ca, cb):
    xa, fa = ca.state_arrays()
    xb, fb = cb.state_arrays()
    np.testing.assert_array_equal(np.asarray(xa), xb.numpy())
    np.testing.assert_array_equal(np.asarray(fa), fb.numpy())


@pytest.mark.parametrize("scheme,capacity", [
    ("static", 1500), ("static", 12000), ("reuse_intensity", 1500),
    ("reuse_intensity", 6000)])
def test_scheme_managers_match_reference(scheme, capacity):
    kw = dict(c_min=50, initial_blocks=100, **SIM)
    a = make_manager_ref(scheme, capacity, NAMES16, **kw)
    b = make_manager(scheme, capacity, NAMES16, device="cpu", **kw)
    for w in range(3):
        a.run_window(_windows(w, msr_trace_ref))
        b.run_window(_windows(w, msr_trace))
        da, db = a.history[-1], b.history[-1]
        assert db.sizes.tolist() == np.asarray(da.sizes).tolist()
        assert [p.value for p in db.policies] == \
            [p.value for p in da.policies]
        assert db.feasible == da.feasible and db.guard == da.guard
        assert db.partition.hit_ratios.tolist() == \
            np.asarray(da.partition.hit_ratios).tolist()
        _same_results([t.result for t in a.tenants],
                      [t.result for t in b.tenants])
        for ta, tb in zip(a.tenants, b.tenants):
            _same_state(ta.cache, tb.cache)
    if scheme == "reuse_intensity":
        assert all(t.policy.value == "ro" for t in b.tenants)
    sa, sb = a.summary(), b.summary()
    assert sb == pytest.approx({k: sa[k] for k in sb}, rel=1e-12)


@pytest.mark.parametrize("capacity", [800, 6000])
def test_global_lru_manager_matches_reference(capacity):
    a = GlobalLRUManagerRef(capacity, NAMES16, **SIM)
    b = GlobalLRUManager(capacity, NAMES16, device="cpu", **SIM)
    for w in range(3):
        a.run_window(_windows(w, msr_trace_ref)[:-1] + [None])
        b.run_window(_windows(w, msr_trace)[:-1] + [None])
        _same_results(a.results, b.results)
        _same_state(a.cache, b.cache)
    assert b.summary() == pytest.approx(a.summary(), rel=1e-12)
    assert b.summary()["allocated_blocks"] == capacity
