"""The port's breakpoint-greedy partitioner against the JAX reference.

``repro_torch.core.greedy_allocate`` (the host heap walk and the
vectorized fast walk) is held against the reference's on the same
curves: sizes and feasibility exactly, hit ratios bit for bit, the
aggregate latency (a float64 sum over tenants, whose order torch and
numpy may take differently) to rel 1e-12.  The cases cover the feasible
fast path, tight and zero budgets, the ``c_min`` rescale when even the
minimums do not fit, ties (equal densities across tenants, and a chain
whose cheap first step blocks better successors), the partial grant
past the budget, a 64-tenant ``synthetic_mix`` and ``two_level_solve``
with the greedy as its partitioner.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from repro.core.mrc import HitRatioFunction as HitRatioFunctionRef
from repro.core.monitor import analyze_windows as analyze_windows_ref
from repro.core.partitioner import greedy_allocate as greedy_ref
from repro.core.partitioner import two_level_solve as two_level_ref
from repro_torch.core import (HitRatioFunction, Trace, analyze_windows,
                              greedy_allocate, two_level_solve)
from repro_torch.core.mrc import BatchedHitRatioFunctions
from repro_torch.data.traces import synthetic_mix

SIM = dict(t_fast=1.0, t_slow=20.0)


def _same(got, want):
    assert got.sizes.tolist() == np.asarray(want.sizes).tolist()
    assert got.feasible == want.feasible
    assert got.hit_ratios.tolist() == np.asarray(want.hit_ratios).tolist()
    assert got.latency == pytest.approx(want.latency, rel=1e-12)


def _curve_pair(edges, heights, n=1000):
    return (HitRatioFunctionRef(np.asarray(edges, np.int64),
                                np.asarray(heights, np.float64), n),
            HitRatioFunction(torch.tensor(edges, dtype=torch.int64),
                             torch.tensor(heights, dtype=torch.float64), n))


def _bench():
    """``benchmarks/bench_monitor_scale.py``, imported without keeping the
    XLA flag it sets for its own mesh rows."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("benchmarks.bench_monitor_scale")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _mix_curves(n_tenants, n, seed):
    port = synthetic_mix(n_tenants, n, seed=seed)
    ref = _bench().synthetic_mix(n_tenants, n, seed=seed)
    return (analyze_windows_ref(ref, "urd").curves,
            analyze_windows(port, "urd", device="cpu").curves)


@pytest.fixture(scope="module")
def mix64():
    return _mix_curves(64, 2000, seed=7)


def test_synthetic_mix_matches_the_benchmark():
    for a, b in zip(_bench().synthetic_mix(4, 500, seed=7),
                    synthetic_mix(4, 500, seed=7)):
        np.testing.assert_array_equal(b.addrs.numpy(), a.addrs)
        np.testing.assert_array_equal(b.is_read.numpy(), a.is_read)
        assert b.name == a.name


@pytest.mark.parametrize("method", ["fast", "heap"])
@pytest.mark.parametrize("c_min", [0, 50, 500])
@pytest.mark.parametrize("frac", [0.0, 0.35, 0.8, 1.0])
def test_greedy_matches_reference_on_a_64_tenant_mix(mix64, method, c_min,
                                                     frac):
    ref, port = mix64
    urd = int(sum(h.max_useful_size for h in ref))
    capacity = max(64 * c_min + 1, int(frac * urd)) if frac else 10
    _same(greedy_allocate(port, capacity, **SIM, c_min=c_min, method=method),
          greedy_ref(ref, capacity, **SIM, c_min=c_min, method=method))


def test_greedy_hand_cases():
    cases = {
        # equal densities across tenants: the tenant index breaks the tie
        "ties": ([([0, 4, 8], [0.0, 0.2, 0.4])] * 3, 10, 0),
        # a cheap first step blocks a better successor (the envelope)
        "envelope": ([([0, 10, 12], [0.0, 0.1, 0.5]),
                      ([0, 3, 6], [0.0, 0.2, 0.3])], 14, 0),
        # the first step past the budget is granted partially
        "partial": ([([0, 100], [0.0, 0.9]), ([0, 2, 50], [0.0, 0.5, 0.6])],
                    30, 0),
        # non-improving steps end a chain
        "flat": ([([0, 5, 9, 20], [0.0, 0.3, 0.3, 0.7]),
                  ([0, 7], [0.0, 0.4])], 15, 2),
        # the minimums do not fit: c_min is scaled down
        "rescale": ([([0, 40, 90], [0.0, 0.3, 0.6]),
                     ([0, 60], [0.0, 0.5]), ([0, 30], [0.0, 0.2])], 50, 35),
        # zero budget and an empty curve
        "zero": ([([0, 8], [0.0, 0.5]), ([0], [0.0])], 0, 0),
        # feasible: the URD sizes fit
        "feasible": ([([0, 8], [0.0, 0.5]), ([0, 3], [0.0, 0.25])], 11, 4),
    }
    for name, (curves, capacity, c_min) in cases.items():
        pairs = [_curve_pair(e, h) for e, h in curves]
        ref = [a for a, _ in pairs]
        port = [b for _, b in pairs]
        for method in ("fast", "heap"):
            want = greedy_ref(ref, capacity, **SIM, c_min=c_min,
                              method=method)
            got = greedy_allocate(port, capacity, **SIM, c_min=c_min,
                                  method=method)
            _same(got, want)
            got_b = greedy_allocate(BatchedHitRatioFunctions.from_curves(
                port), capacity, **SIM, c_min=c_min, method=method)
            assert got_b.sizes.tolist() == got.sizes.tolist(), name
        w = np.array([1.0, 2.5, 0.5][:len(curves)])
        _same(greedy_allocate(port, capacity, **SIM, c_min=c_min, weights=w),
              greedy_ref(ref, capacity, **SIM, c_min=c_min, weights=w))


@pytest.mark.parametrize("capacity2", [0, 3000, 40000])
def test_two_level_solve_with_the_greedy(mix64, capacity2):
    ref, port = mix64
    w1, w2 = two_level_ref(ref, 20000, capacity2, 1.0, 3.0, 20.0, c_min=50,
                           partition_fn=greedy_ref)
    g1, g2 = two_level_solve(port, 20000, capacity2, 1.0, 3.0, 20.0,
                             c_min=50, partition_fn=greedy_allocate)
    _same(g1, w1)
    if capacity2 <= 0:
        assert g2 is None and w2 is None
    else:
        _same(g2, w2)


def test_greedy_method_checks(mix64):
    """``method="device"`` (the device window pipeline's walk, no longer
    refused) gives the heap's allocation; an unknown method raises."""
    _, port = mix64
    dev = greedy_allocate(port, 100, **SIM, method="device")
    heap = greedy_allocate(port, 100, **SIM, method="heap")
    assert dev.sizes.tolist() == heap.sizes.tolist()
    assert torch.equal(dev.hit_ratios, heap.hit_ratios)
    with pytest.raises(ValueError):
        greedy_allocate(port, 100, **SIM, method="lp")


def test_max_hit_ratios(mix64):
    ref, port = mix64
    assert port.max_hit_ratios.tolist() == \
        np.asarray(ref.max_hit_ratios).tolist()
    assert [h.max_hit_ratio for h in port] == [h.max_hit_ratio for h in ref]
    empty = Trace(torch.zeros(0, dtype=torch.int64),
                  torch.zeros(0, dtype=torch.bool))
    assert analyze_windows([empty], device="cpu").curves[0].max_hit_ratio \
        == 0.0
