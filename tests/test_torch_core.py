"""Module-level differentials of the port's core against the JAX package.

Each ported module is fed the same numpy-seeded inputs as its reference
counterpart: trace classification, curves (``mrc``), the monitor
(precomputed and recounted distances), the PGD partitioner (its float32
relaxed optimum bit for bit against the reference's jitted loop), the
guard, the LRU state, the manager's refusal of knobs that leave the
ported slice, and its switch to SHARDS sampling.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import monitor as ref_monitor
from repro.core import partitioner as ref_part
from repro.core import trace as ref_trace
from repro.core.mrc import build_hit_ratio_functions as build_ref
from repro.data.traces import msr_trace as msr_trace_ref
from repro_torch.core import guard, make_manager, monitor, partitioner
from repro_torch.core import trace as pt_trace
from repro_torch.core.manager import AnalyzerDecision
from repro_torch.core.mrc import (BatchedHitRatioFunctions,
                                  build_hit_ratio_function,
                                  build_hit_ratio_functions)
from repro_torch.core.reuse_distance import (RDResult, max_rd,
                                             urd_cache_blocks)
from repro_torch.core.simulator import LRUCache
from repro_torch.core.write_policy import WritePolicy
from repro_torch.data.traces import msr_trace
from test_torch_oracle import assert_pgd_sizes_match, reference_relaxed

NAMES = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]


# ---------------------------------------------------------------- trace
@pytest.mark.parametrize("name", NAMES)
def test_trace_classification_matches_reference(name):
    a = msr_trace_ref(name, 700, seed=3)
    b = msr_trace(name, 700, seed=3)
    np.testing.assert_array_equal(b.addrs.numpy(), a.addrs)
    pr, nr = ref_trace.prev_next_occurrence(a.addrs)
    pp, npt = pt_trace.prev_next_occurrence(b.addrs)
    np.testing.assert_array_equal(pp.numpy(), pr)
    np.testing.assert_array_equal(npt.numpy(), nr)
    np.testing.assert_array_equal(pt_trace.classify_accesses(b).numpy(),
                                  ref_trace.classify_accesses(a))
    assert pt_trace.request_type_mix(b) == ref_trace.request_type_mix(a)


@pytest.mark.parametrize("addrs,is_read", [
    (np.zeros((2, 2), np.int64), np.zeros((2, 2), bool)),
    (np.zeros(3, np.int64), np.zeros(2, bool)),
    (np.zeros(3, np.float64), np.zeros(3, bool)),
    (np.array([1, -2, 3]), np.ones(3, bool)),
    (np.array([1, 2, 3]), np.array([0, 2, 1])),
    (np.array([1, 2, 3]), np.array([0.0, 1.0, 1.0])),
])
def test_validate_trace_arrays_rejects_like_reference(addrs, is_read):
    with pytest.raises(ref_trace.TraceError):
        ref_trace.validate_trace_arrays(addrs, is_read, 1, 2)
    with pytest.raises(pt_trace.TraceError) as e:
        pt_trace.validate_trace_arrays(addrs, is_read, 1, 2)
    assert "(tenant=1, window=2)" in str(e.value)
    pt_trace.validate_trace_arrays(np.arange(3), np.array([0, 1, 1]))


# ------------------------------------------------------------------ mrc
def _samples(seed, n_tenants=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 300, n_tenants)
    lens[0] = 0                                   # an empty tenant
    dist = np.concatenate([
        np.where(rng.random(ln) < 0.3, -1,
                 rng.integers(0, rng.integers(1, 200), ln)) for ln in lens])
    return dist, np.repeat(np.arange(n_tenants), lens), lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_curves_match_reference(seed):
    dist, tid, lens = _samples(seed)
    want = build_ref(dist, tid, len(lens), lens)
    got = build_hit_ratio_functions(torch.as_tensor(dist),
                                    torch.as_tensor(tid), len(lens),
                                    torch.as_tensor(lens))
    for f in ("edges", "heights", "offsets", "n_accesses"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f))
    q = np.random.default_rng(seed).integers(-3, 250, len(lens))
    np.testing.assert_array_equal(got.evaluate(torch.as_tensor(q)).numpy(),
                                  want.evaluate(q))
    for i in range(len(lens)):
        assert got[i].marginal_gain(int(q[i])) == \
            want[i].marginal_gain(int(q[i]))
        assert got[i](float(q[i]) + 0.5) == want[i](float(q[i]) + 0.5)
    again = BatchedHitRatioFunctions.from_curves(list(got))
    assert torch.equal(again.edges, got.edges)


def test_single_curve_and_urd_size():
    d = torch.tensor([-1, 4, 0, 4, -1, 9])
    h = build_hit_ratio_function(RDResult(d, "urd"))
    assert h.edges.tolist() == [0, 1, 5, 10]
    assert h.heights.tolist() == [0.0, 1 / 6, 3 / 6, 4 / 6]
    assert urd_cache_blocks(RDResult(d, "urd")) == 10
    assert max_rd(RDResult(d, "urd"), 50.0) == int(np.percentile([4, 0, 4, 9],
                                                                 50.0))
    assert urd_cache_blocks(RDResult(torch.tensor([-1, -1]), "urd")) == 0


# -------------------------------------------------------------- monitor
@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("percentile", [100.0, 90.0])
@pytest.mark.parametrize("precomputed", [True, False])
def test_analyze_windows_matches_reference(kind, percentile, precomputed):
    """With the batch engine's distances forwarded, and recounted here
    (every other tenant), on tapes with an empty window."""
    ta = [msr_trace_ref(nm, 0 if nm == "web_0" else 900, seed=i)
          for i, nm in enumerate(NAMES)]
    tb = [msr_trace(nm, 0 if nm == "web_0" else 900, seed=i)
          for i, nm in enumerate(NAMES)]
    pre_a = pre_b = None
    if precomputed:
        from repro.core.batch_sim import reuse_distances_fast
        rd = [reuse_distances_fast(t, "trd", backend="host").distances
              for t in ta]
        pre_a = [r if i % 2 else None for i, r in enumerate(rd)]
        pre_b = [torch.as_tensor(r) if r is not None else None
                 for r in pre_a]
    want = ref_monitor.analyze_windows(ta, kind=kind, percentile=percentile,
                                       precomputed_trd=pre_a,
                                       backend="host")
    got = monitor.analyze_windows(tb, kind=kind, percentile=percentile,
                                  precomputed_trd=pre_b, device="cpu")
    np.testing.assert_array_equal(got.urd_sizes.numpy(), want.urd_sizes)
    np.testing.assert_array_equal(got.write_ratios.numpy(),
                                  want.write_ratios)
    np.testing.assert_array_equal(got.curves.edges.numpy(),
                                  want.curves.edges)
    np.testing.assert_array_equal(got.curves.heights.numpy(),
                                  want.curves.heights)


# ---------------------------------------------------------- partitioner
@pytest.mark.parametrize("seed,n", [(0, 3), (1, 6), (2, 16)])
def test_pgd_relaxed_optimum_bitwise_against_reference(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(50, 400, n)
    dist = np.concatenate([
        np.where(rng.random(ln) < 0.3, -1,
                 rng.integers(0, rng.integers(5, 300), ln)) for ln in lens])
    tid = np.repeat(np.arange(n), lens)
    ha = build_ref(dist, tid, n, lens)
    hb = build_hit_ratio_functions(torch.as_tensor(dist),
                                   torch.as_tensor(tid), n,
                                   torch.as_tensor(lens))
    cap = int(ha.max_useful_sizes.sum() * 0.6)
    c_min = 5
    # the reference's jitted loop on the reference's own tables
    xs = np.zeros((n, 128), np.float32)
    ys = np.zeros((n, 128), np.float32)
    for i, h in enumerate(ha):
        e = h.edges.astype(np.float64)
        grid = np.linspace(0.0, max(float(e[-1]), 1.0), 128)
        xs[i], ys[i] = grid, np.interp(grid, e, h.heights)
    urd = ha.max_useful_sizes
    lo = np.minimum(np.full(n, float(c_min)), urd.astype(np.float32))
    c_ref = np.asarray(ref_part._pgd_core(n, 300)(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(lo),
        jnp.asarray(urd.astype(np.float32)), jnp.float32(cap),
        jnp.ones(n, jnp.float32), jnp.float32(1.0), jnp.float32(20.0),
        jnp.float32(0.05 * cap / n)))
    got = partitioner.pgd_solve(hb, cap, 1.0, 20.0, c_min=c_min)
    want = ref_part.pgd_solve(ha, cap, 1.0, 20.0, c_min=c_min)
    xt, yt = partitioner._interp_tables(hb)
    np.testing.assert_array_equal(xt.numpy(), xs)
    np.testing.assert_array_equal(yt.numpy(), ys)
    np.testing.assert_array_equal(got.relaxed.numpy(), c_ref)
    assert got.sizes.tolist() == want.sizes.tolist()
    assert not got.feasible and not want.feasible
    np.testing.assert_array_equal(got.hit_ratios.numpy(), want.hit_ratios)
    assert got.latency == pytest.approx(want.latency, rel=1e-12)
    feas = partitioner.pgd_solve(hb, 10**6, 1.0, 20.0, c_min=c_min)
    assert feas.feasible and feas.relaxed is None
    assert feas.sizes.tolist() == hb.max_useful_sizes.tolist()


def _pgd_case(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(50, 400, n)
    dist = np.concatenate([
        np.where(rng.random(ln) < 0.3, -1,
                 rng.integers(0, rng.integers(5, 300), ln)) for ln in lens])
    tid = np.repeat(np.arange(n), lens)
    ha = build_ref(dist, tid, n, lens)
    hb = build_hit_ratio_functions(torch.as_tensor(dist),
                                   torch.as_tensor(tid), n,
                                   torch.as_tensor(lens))
    return ha, hb, int(ha.max_useful_sizes.sum() * 0.6)


@pytest.mark.parametrize("seed,n", [(3, 48), (4, 256)])
def test_pgd_past_32_tenants_against_reference(seed, n):
    """Past 32 tenants the port sums over tenants as a pairwise tree, not
    in XLA's order: the relaxed optimum is held to a fraction of one
    step, and sizes are equal except where the tie rule allows."""
    ha, hb, cap = _pgd_case(seed, n)
    c_ref = reference_relaxed(ha, cap, 5)
    got = partitioner.pgd_solve(hb, cap, 1.0, 20.0, c_min=5)
    want = ref_part.pgd_solve(ha, cap, 1.0, 20.0, c_min=5)
    assert not got.feasible and not want.feasible
    step = 0.05 * cap / n * np.sqrt(n)                 # lr * sqrt(n)
    assert_pgd_sizes_match(ha, got.relaxed.numpy(), c_ref,
                           got.sizes.numpy(), want.sizes, step)
    same = got.sizes.numpy() == want.sizes
    np.testing.assert_array_equal(got.hit_ratios.numpy()[same],
                                  want.hit_ratios[same])
    # measured: at most rel 5.3e-4 over seeds 0-23 at 48 and 256 tenants
    assert got.latency == pytest.approx(want.latency,
                                        rel=1e-12 if same.all() else 1e-3)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_pgd_past_32_tenants_issues_no_per_tenant_loop():
    """One projection issues about as many torch ops at 256 tenants as at
    64 (the tree adds ~log2 n adds per sum); a loop over tenants would
    issue four times as many."""
    ops = {}
    for n in (64, 256):
        g = torch.Generator().manual_seed(n)
        c = torch.rand(n, generator=g) * 100
        lo, hi = torch.zeros(n), torch.full((n,), 80.0)
        with _OpCount() as cnt:
            partitioner._project_capacity_box(c, lo, hi,
                                              torch.tensor(20.0 * n))
        ops[n] = cnt.ops
    assert ops[256] < 1.5 * ops[64], ops


def test_two_level_solve_single_level_only():
    hb = build_hit_ratio_functions(torch.tensor([1, 2, -1]),
                                   torch.tensor([0, 0, 0]), 1,
                                   torch.tensor([3]))
    p1, p2 = partitioner.two_level_solve(hb, 100, 0, 1.0, 3.0, 20.0)
    assert p2 is None and p1.feasible
    with pytest.raises(NotImplementedError, match="two-level"):
        partitioner.two_level_solve(hb, 100, 10, 1.0, 3.0, 20.0)


# ---------------------------------------------------------------- guard
def _decision(sizes, hit=0.5, latency=1.0, policies=None):
    part = partitioner.PartitionResult(torch.as_tensor(sizes), True,
                                       latency, torch.tensor([hit]))
    return AnalyzerDecision(torch.as_tensor(sizes),
                            policies or [WritePolicy.WB] * len(sizes),
                            True, part)


@pytest.mark.parametrize("dec,floors,expect", [
    (_decision([5, 5]), None, ()),
    (_decision([60, 50]), None, ("L1 sizes exceed capacity",)),
    (_decision([-1, 5]), None, ("negative L1 size",)),
    (_decision([5, 5], hit=1.5), None, ("hit ratios outside",)),
    (_decision([5, 5], latency=float("nan")), None, ("non-finite",)),
    (_decision([5, 5], policies=["wb", WritePolicy.RO]), None,
     ("invalid L1 policy",)),
    (_decision([5, 1]), [5, 5], ("c_min floor violated for tenants [1]",)),
    (_decision([5, 1]), [60, 60], ()),           # floors do not fit
])
def test_guard_invariants(dec, floors, expect):
    rep = guard.validate_decision(dec, 100, floors=floors)
    assert rep.ok == (not expect)
    for want, got in zip(expect, rep.violations):
        assert want in got


# ---------------------------------------------------------- LRU + knobs
def test_lru_cache_state_and_resize():
    c = LRUCache(4)
    c.set_state_arrays(torch.tensor([7, 8, 9]), torch.tensor([1, 0, 1],
                                                             dtype=bool))
    assert len(c) == 3
    assert c.resize(2).tolist() == [7]
    assert c.state_arrays()[0].tolist() == [8, 9]
    assert c.resize(10).numel() == 0 and c.capacity == 10


@pytest.mark.parametrize("kw,match", [
    (dict(engine="lru"), "interpreter"),
    (dict(pipeline="device"), "pipeline"),
    (dict(capacity2=10), "two-level"),
    (dict(phase_detect=True), "phase_detect"),
    (dict(fault_tolerant=True), "fault"),
    (dict(pipeline="sharded"), "pipeline"),
])
def test_manager_refuses_knobs_off_the_slice(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        make_manager("eci", 100, NAMES, device="cpu", **kw)


def test_manager_retire_and_sampling_threshold():
    mgr = make_manager("eci", 200, NAMES[:3], c_min=10, device="cpu")
    mgr.run_window([msr_trace(nm, 200, seed=i)
                    for i, nm in enumerate(NAMES[:3])])
    mgr.run_window([None, msr_trace("hm_1", 200, seed=5),
                    msr_trace("prn_1", 200, seed=6)])
    assert [(e.window, e.tenant, e.reason) for e in mgr.events] == \
        [(1, 0, "retire")]
    assert mgr.summary()["reconfig_events"] == 1
    assert mgr.tenants[0].cache.capacity == 0
    assert mgr.history[-1].sizes[0] == 0
    assert mgr.summary()["tenant_windows"] == 5
    assert mgr.summary()["windows_analyzed"] == 2
    assert mgr.summary()["guard_violations_actuated"] == 0
    assert mgr.effective_sample_rate() is None
    big = make_manager("eci", 200, NAMES[:3], c_min=10, device="cpu",
                       auto_sample_tenants=3)
    assert big.effective_sample_rate() == "auto"
    big.run_window([msr_trace(nm, 50, seed=i)
                    for i, nm in enumerate(NAMES[:3])])
    assert big.summary()["windows_analyzed"] == 1
    fixed = make_manager("eci", 200, NAMES[:3], c_min=10, device="cpu",
                         sample_rate=0.5)
    assert fixed.effective_sample_rate() == 0.5
