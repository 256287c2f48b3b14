"""The port's device window pipeline against the reference's host path.

``repro_torch.core.device_pipeline`` (``analyze_windows(pipeline=
"device")``, ``DeviceWindowPipeline``, ``greedy_allocate(method=
"device")``, ``ECICacheManager(pipeline="device")``) runs here on
``device="cpu"``: the same numpy-made windows go through the reference's
host monitor, fast and heap walks and host manager, and through the
port's device pipeline.  The cases are those of the reference's
``tests/test_monitor_scale.py`` device section (whose own device program
cannot run here).  Every output is held exactly — curve edges and
heights, offsets, URD sizes, write ratios, sample rates, error bars,
allocations, hit ratios, policies — apart from the Eq. 2 aggregate
latency, a sum in another order, at rel 1e-12.  The same pipeline on the
card is held to the CPU bit for bit in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import ECICacheManager as ManagerRef
from repro.core import HitRatioFunction as HitRatioFunctionRef
from repro.core import Trace as TraceRef
from repro.core import analyze_windows as analyze_ref
from repro.core import greedy_allocate as greedy_ref
from repro_torch.core import (ECICacheManager, StageProfile, Trace,
                              analyze_windows, greedy_allocate)
from repro_torch.core.device_pipeline import (DeviceWindowPipeline,
                                              WindowDecision, ingest_window,
                                              monitor_window_device,
                                              transfer_sanitizer)
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.mrc import (BatchedHitRatioFunctions,
                                  HitRatioFunction)

CPU = "cpu"


def _rand_traces(seed, n_tenants=6, max_n=300, max_addr=40):
    """The reference test's random windows plus its degenerate shapes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tenants):
        n = int(rng.integers(0, max_n))
        a = rng.integers(0, max_addr, n).astype(np.int64)
        r = rng.random(n) < rng.uniform(0.1, 0.9)
        out.append((a, r))
    out.append((np.zeros(0, np.int64), np.zeros(0, bool)))         # empty
    out.append((np.arange(40, dtype=np.int64) % 4, np.zeros(40, bool)))
    out.append((np.arange(30, dtype=np.int64), np.ones(30, bool)))
    return out


def _device_traces(seed):
    """Adversarial window shapes for the device pipeline: empty windows,
    single-access segments, and lengths either side of a padded width
    (63/64/65), which the shape key must separate."""
    rng = np.random.default_rng(seed)
    out = _rand_traces(seed)
    out.append((np.array([7], np.int64), np.array([True])))
    out.append((np.array([7], np.int64), np.array([False])))
    for ln in (63, 64, 65):
        out.append((rng.integers(0, 12, ln).astype(np.int64),
                    rng.random(ln) < 0.5))
    return out


def _ref(raw):
    return [TraceRef(a, r, f"t{i}") for i, (a, r) in enumerate(raw)]


def _port(raw):
    return [Trace(torch.as_tensor(a), torch.as_tensor(r), f"t{i}")
            for i, (a, r) in enumerate(raw)]


def _eq(got, want):
    np.testing.assert_array_equal(torch.as_tensor(got).cpu().numpy(),
                                  np.asarray(want))


def _assert_monitor_equal(ref, got):
    for f in ("edges", "heights", "offsets", "n_accesses"):
        _eq(getattr(got.curves, f), getattr(ref.curves, f))
    for f in ("urd_sizes", "write_ratios", "sample_rates", "expected_errors"):
        _eq(getattr(got, f), getattr(ref, f))
    assert got.kind == ref.kind


# ----------------------------------------- monitor == reference host path
@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_pipeline_bit_identical(kind, seed):
    """The device pipeline reproduces the host monitor bit for bit, with
    one host sync (the fetch) in its one window."""
    raw = _device_traces(seed)
    ref = analyze_ref(_ref(raw), kind)
    prof = StageProfile()
    got = analyze_windows(_port(raw), kind, pipeline="device", profile=prof,
                          device=CPU)
    _assert_monitor_equal(ref, got)
    assert prof.windows == 1 and prof.syncs == 1
    assert prof.syncs_per_window == 1.0
    assert set(prof.times) == {"ingest", "dispatch", "fetch"}


@pytest.mark.parametrize("rate", [0.5, "auto"])
def test_device_pipeline_sampled_bit_identical(rate):
    """The sampled branch: scaled distances (half to even), HT heights,
    kept-access write ratios and the error bars from the kept distinct
    addresses."""
    raw = _device_traces(7)
    ref = analyze_ref(_ref(raw), "urd", sample_rate=rate, window_seed=11)
    got = analyze_windows(_port(raw), "urd", sample_rate=rate,
                          window_seed=11, pipeline="device", device=CPU)
    _assert_monitor_equal(ref, got)
    # "auto" keeps these short windows whole (rate 1, no error bar)
    assert (float(got.expected_errors.max()) > 0.0) == (rate == 0.5)


def test_device_pipeline_all_empty_window():
    raw = [(np.zeros(0, np.int64), np.zeros(0, bool))] * 3
    ref = analyze_ref(_ref(raw), "urd")
    prof = StageProfile()
    got = analyze_windows(_port(raw), "urd", pipeline="device", profile=prof,
                          device=CPU)
    _assert_monitor_equal(ref, got)
    assert prof.syncs == 0 and prof.windows == 1   # no device work


def test_device_pipeline_rejects_percentile():
    with pytest.raises(ValueError, match="percentile"):
        analyze_windows(_port(_rand_traces(0)), "urd", percentile=90.0,
                        pipeline="device", device=CPU)
    with pytest.raises(NotImplementedError, match="item 4"):
        analyze_windows(_port(_rand_traces(0)), "urd", pipeline="sharded",
                        device=CPU)
    with pytest.raises(ValueError, match="pipeline"):
        analyze_windows(_port(_rand_traces(0)), "urd", pipeline="tpu",
                        device=CPU)


def test_device_pipeline_refuses_mesh_and_launch_hook():
    """``mesh=`` (item 4) is refused; ``launch_hook`` (item 3b, ported) is
    called once a window after ingest, before the dispatch and before an
    all-empty window's trivial result, and a raising hook stops the
    window."""
    with pytest.raises(NotImplementedError, match="item 4"):
        DeviceWindowPipeline(100, mesh=object(), device=CPU)
    raw = _rand_traces(1)
    a = torch.as_tensor(np.concatenate([x for x, _ in raw]))
    r = torch.as_tensor(np.concatenate([y for _, y in raw]))
    lens = [len(x) for x, _ in raw]
    bounds = np.concatenate([[0], np.cumsum(lens)]).tolist()
    calls, prof = [], StageProfile(CPU)
    got = monitor_window_device(
        a, r, bounds, lens, profile=prof,
        launch_hook=lambda: calls.append(prof.windows), device=CPU)
    want = monitor_window_device(a, r, bounds, lens, device=CPU)
    assert calls == [1]                     # after ingest's window count
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert torch.equal(got[0].heights, want[0].heights)
    empty = torch.zeros(0, dtype=torch.int64)
    monitor_window_device(empty, empty.bool(), [0, 0], [0],
                          launch_hook=lambda: calls.append("empty"),
                          device=CPU)
    assert calls == [1, "empty"]

    def dead():
        raise RuntimeError("launch refused")
    with pytest.raises(RuntimeError, match="launch refused"):
        monitor_window_device(a, r, bounds, lens, launch_hook=dead,
                              device=CPU)


def test_ingest_shape_key_and_layout():
    """The shape key is (width groups, tenants, sampled, kind), from the
    host-side lengths; the padded store's rows start where the layout
    puts each tenant."""
    raw = _device_traces(3)
    lens = [len(a) for a, _ in raw]
    bounds = np.concatenate([[0], np.cumsum(lens)]).tolist()
    a = torch.as_tensor(np.concatenate([x for x, _ in raw]))
    r = torch.as_tensor(np.concatenate([y for _, y in raw]))
    ing = ingest_window(a, r, bounds, lens, device=CPU)
    wg, n, sampled, kind = ing.key
    assert (n, sampled, kind) == (len(raw), False, "urd")
    assert [w for w, _, _ in wg] == sorted({w for w, _, _ in wg},
                                           reverse=True)
    assert wg[-1][2] == ing.total == sum(
        max(1 << (ln - 1).bit_length(), 64) for ln in lens if ln)
    gtid, grank = ing.dev["gtid"], ing.dev["grank"]
    for i, ln in enumerate(lens):
        rows = gtid == i
        if ln:
            assert int(grank[rows].min()) == 0
            assert int(torch.nonzero(rows)[0]) == int(ing.row_start[i])
        else:
            assert not bool(rows.any())
    assert ingest_window(torch.zeros(0, dtype=torch.int64),
                         torch.zeros(0, dtype=torch.bool), [0, 0, 0],
                         [0, 0], device=CPU) is None


# ---------------------------------------- the device walk == the heap walk
def _random_curves(seed):
    """The reference test's curve strategy, from numpy: 1-6 tenants of
    1-5 steps (sizes 1-20, height steps 0.01-0.3, capped at 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 7))):
        k = int(rng.integers(1, 6))
        sizes = np.cumsum(rng.integers(1, 21, k))
        heights = np.minimum(np.cumsum(rng.uniform(0.01, 0.3, k)), 1.0)
        out.append((np.concatenate([[0], sizes]).astype(np.int64),
                    np.concatenate([[0.0], heights])))
    return out, int(rng.integers(0, 121)), int(rng.integers(0, 13))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_greedy_device_bit_identical_to_heap(seed, weighted):
    """``greedy_allocate(method="device")`` replays the reference heap's
    grant order exactly (sizes, hit ratios, feasibility)."""
    curves, capacity, c_min = _random_curves(seed)
    hs_ref = [HitRatioFunctionRef(e, h, 1000) for e, h in curves]
    hs = [HitRatioFunction(torch.as_tensor(e), torch.as_tensor(h), 1000)
          for e, h in curves]
    w = np.linspace(0.5, 2.0, len(curves)) if weighted else None
    heap = greedy_ref(hs_ref, capacity, 1.0, 20.0, c_min=c_min, weights=w,
                      method="heap")
    dev = greedy_allocate(hs, capacity, 1.0, 20.0, c_min=c_min, weights=w,
                          method="device")
    _eq(dev.sizes, heap.sizes)
    _eq(dev.hit_ratios, heap.hit_ratios)
    assert dev.feasible == heap.feasible
    assert dev.latency == pytest.approx(heap.latency, rel=1e-12)


def test_greedy_device_on_a_monitor_store():
    """The device walk on a whole window's curve store (tenants with no
    breakpoints, several widths) equals the reference's fast and heap
    walks at capacities from the scale-down branch to feasible."""
    raw = _device_traces(4)
    mon_ref = analyze_ref(_ref(raw), "urd")
    mon = analyze_windows(_port(raw), "urd", device=CPU)
    total = int(mon_ref.urd_sizes.sum())
    for cap in (5, total // 3, total - 1, total):
        want = greedy_ref(mon_ref.curves, cap, 1.0, 20.0, c_min=6,
                          method="heap")
        got = greedy_allocate(mon.curves, cap, 1.0, 20.0, c_min=6,
                              method="device")
        _eq(got.sizes, want.sizes)
        _eq(got.hit_ratios, want.hit_ratios)
        assert got.feasible == want.feasible


# ------------------------------------------------------ fused decisions
@pytest.mark.parametrize("frac", [0.1, 0.6, 2.0])
def test_device_decision_pipeline_matches_host(frac):
    """The whole window decision equals the reference's host monitor and
    fast walk, including the feasible and scale-down branches."""
    raw = _device_traces(5)
    mon = analyze_ref(_ref(raw), "urd")
    cap = max(int(mon.urd_sizes.sum() * frac), 1)
    part = greedy_ref(mon.curves, cap, 1.0, 20.0, c_min=4, method="fast")
    pipe = DeviceWindowPipeline(capacity=cap, c_min=4, device=CPU)
    prof = StageProfile()
    dec = pipe.run(_port(raw), profile=prof)
    assert isinstance(dec, WindowDecision)
    assert dec.feasible == part.feasible
    _eq(dec.urd_sizes, mon.urd_sizes)
    _eq(dec.sizes, part.sizes)
    _eq(dec.hit_ratios, part.hit_ratios)
    _eq(dec.write_ratios, mon.write_ratios)
    for f in ("edges", "heights", "offsets"):
        _eq(getattr(dec.curves, f), getattr(mon.curves, f))
    assert dec.latency == pytest.approx(part.latency, rel=1e-12)
    assert prof.syncs_per_window == 1.0


def test_scale_down_branch_matches_host():
    """Even the minimums do not fit: every tenant's minimum is scaled
    down by the same float64 floor as the host walk."""
    raw = _device_traces(6)
    mon = analyze_ref(_ref(raw), "urd")
    for cap in (1, 7, 30):
        part = greedy_ref(mon.curves, cap, 1.0, 20.0, c_min=9,
                          method="fast")
        dec = DeviceWindowPipeline(cap, c_min=9, device=CPU).run(_port(raw))
        _eq(dec.sizes, part.sizes)
        _eq(dec.hit_ratios, part.hit_ratios)


def test_weighted_decision_matches_host():
    raw = _device_traces(8)
    mon = analyze_ref(_ref(raw), "trd")
    w = np.linspace(0.25, 3.0, len(raw))
    cap = int(mon.urd_sizes.sum() * 0.4)
    part = greedy_ref(mon.curves, cap, 2.0, 30.0, c_min=3, weights=w,
                      method="heap")
    dec = DeviceWindowPipeline(cap, t_fast=2.0, t_slow=30.0, c_min=3,
                               kind="trd", weights=w, device=CPU
                               ).run(_port(raw))
    _eq(dec.sizes, part.sizes)
    _eq(dec.hit_ratios, part.hit_ratios)
    assert dec.latency == pytest.approx(part.latency, rel=1e-12)


def test_staged_profile_counts_a_sync_a_stage():
    """``staged=True`` runs the stages one at a time, each a sync; the
    decision does not change."""
    raw = _device_traces(9)
    pipe = DeviceWindowPipeline(capacity=150, c_min=3, device=CPU)
    fused = pipe.run(_port(raw))
    prof = StageProfile(staged=True)
    staged = pipe.run(_port(raw), profile=prof)
    _eq(staged.sizes, fused.sizes)
    _eq(staged.hit_ratios, fused.hit_ratios)
    assert prof.syncs == 4 and prof.windows == 1
    assert {"count", "curve", "write_ratio", "partition"} <= set(prof.times)
    rep = prof.report()
    assert rep["syncs_per_window"] == 4.0 and rep["windows"] == 1
    mprof = StageProfile(staged=True)
    analyze_windows(_port(raw), "urd", pipeline="device", profile=mprof,
                    device=CPU)
    assert mprof.syncs == 3


def test_device_run_stream_double_buffered():
    """The double-buffered stream returns the same decisions as windows
    run one at a time (an empty window interleaved), one sync a window
    with device work."""
    empty = [(np.zeros(0, np.int64), np.zeros(0, bool))] * 3
    wins = [_device_traces(s) for s in (0, 1)] + [empty] + \
        [_device_traces(2)]
    pipe = DeviceWindowPipeline(capacity=300, c_min=3, device=CPU)
    prof = StageProfile()
    stream = pipe.run_stream([_port(w) for w in wins], profile=prof)
    solo = [pipe.run(_port(w)) for w in wins]
    assert len(stream) == len(wins)
    for a, b in zip(stream, solo):
        _eq(a.sizes, b.sizes)
        _eq(a.urd_sizes, b.urd_sizes)
        _eq(a.hit_ratios, b.hit_ratios)
        assert a.feasible == b.feasible and a.latency == b.latency
    assert prof.windows == 4 and prof.syncs == 3
    assert stream[2].latency == 20.0 * 3 and bool(stream[2].feasible)


def test_transfer_sanitizer_is_a_noop_on_the_cpu():
    raw = _device_traces(10)
    pipe = DeviceWindowPipeline(capacity=200, c_min=3,
                                transfer_sanitize=True, device=CPU)
    plain = DeviceWindowPipeline(capacity=200, c_min=3, device=CPU)
    _eq(pipe.run(_port(raw)).sizes, plain.run(_port(raw)).sizes)
    with transfer_sanitizer(True, CPU):
        assert torch.ones(3).sum().item() == 3.0


# ---------------------------------------------------------- the manager
def _manager_windows(seed, tenants=5, windows=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(windows):
        win = []
        for _ in range(tenants):
            n = int(rng.integers(20, 250))
            win.append((rng.integers(0, 50, n).astype(np.int64),
                        rng.random(n) < 0.6))
        out.append(win)
    return out


@pytest.mark.parametrize("capacity", [600, 150])
def test_manager_device_pipeline_matches_host(capacity):
    """``ECICacheManager(pipeline="device")`` decides as the reference's
    host manager window for window (the host side reuses the replay's
    distances, the device side recounts), and as the port's host
    manager in everything it records."""
    names = [f"t{i}" for i in range(5)]
    ref = ManagerRef(capacity, names, c_min=8, pipeline="host")
    dev = ECICacheManager(capacity, names, c_min=8, pipeline="device",
                          device=CPU)
    host = ECICacheManager(capacity, names, c_min=8, device=CPU)
    for win in _manager_windows(17):
        ref.run_window(_ref(win))
        dev.run_window(_port(win))
        host.run_window(_port(win))
    for a, b, c in zip(ref.history, dev.history, host.history):
        assert [p.value for p in a.policies] == [p.value for p in b.policies]
        _eq(b.sizes, a.sizes)
        assert b.feasible == a.feasible
        assert b.partition.latency == pytest.approx(a.partition.latency,
                                                    rel=1e-12)
        assert b.sizes.tolist() == c.sizes.tolist() and b.guard == c.guard
    for tb, tc in zip(dev.tenants, host.tenants):
        assert tb.result == tc.result
        _eq(tb.h_fn.edges, tc.h_fn.edges)
        _eq(tb.h_fn.heights, tc.h_fn.heights)
    assert dev.summary() == host.summary()


def test_manager_device_pipeline_sampled_and_percentile():
    """The sampled branch through the manager, and a percentile below
    100, which the manager serves with the host pipeline."""
    names = [f"t{i}" for i in range(4)]
    wins = _manager_windows(23, tenants=4, windows=2)
    for kw in (dict(sample_rate=0.5), dict(percentile=90.0)):
        ref = ManagerRef(400, names, c_min=6, **kw)
        dev = ECICacheManager(400, names, c_min=6, pipeline="device",
                              device=CPU, **kw)
        host = ECICacheManager(400, names, c_min=6, device=CPU, **kw)
        for win in wins:
            ref.run_window(_ref(win))
            dev.run_window(_port(win))
            host.run_window(_port(win))
        for a, b, c in zip(ref.history, dev.history, host.history):
            _eq(b.sizes, a.sizes)
            assert [p.value for p in a.policies] == \
                [p.value for p in b.policies]
            assert torch.equal(b.sample_rates, c.sample_rates)
        assert dev.summary() == host.summary()


def test_manager_refuses_sharded_and_faults_naming_items():
    """The sharded pipeline stays refused (item 4), with faults too; the
    fault ladder (item 3b) is ported and builds under both pipelines."""
    names = ["a", "b"]
    plan = FaultPlan((FaultSpec("pipeline", window=0, rung="device"),))
    with pytest.raises(NotImplementedError, match="item 4"):
        ECICacheManager(100, names, pipeline="sharded", device=CPU)
    with pytest.raises(NotImplementedError, match="item 4"):
        ECICacheManager(100, names, pipeline="sharded", faults=plan,
                        device=CPU)
    with pytest.raises(NotImplementedError, match="item 4"):
        ECICacheManager(100, names, pipeline="sharded", fault_tolerant=True,
                        device=CPU)
    mgr = ECICacheManager(100, names, pipeline="device", faults=plan,
                          device=CPU)
    assert mgr.fault_tolerant and mgr.faults is plan
    assert ECICacheManager(100, names, fault_tolerant=True,
                           device=CPU).fault_tolerant
    with pytest.raises(ValueError, match="pipeline"):
        ECICacheManager(100, names, pipeline="tpu", device=CPU)


# --------------------------------------------------- deep differential
@pytest.mark.parametrize("seed", range(12))
def test_device_pipeline_differential_deep(seed):
    """Randomized window shapes through both pipelines: exact and
    sampled, urd and trd."""
    rng = np.random.default_rng(1000 + seed)
    rate = [None, 0.4][seed % 2]
    kind = ["urd", "trd"][(seed // 2) % 2]
    raw = []
    for _ in range(int(rng.integers(1, 10))):
        n = int(rng.integers(0, 200))
        raw.append((rng.integers(0, 30, n).astype(np.int64),
                    rng.random(n) < rng.uniform(0, 1)))
    ref = analyze_ref(_ref(raw), kind, sample_rate=rate, window_seed=seed)
    got = analyze_windows(_port(raw), kind, sample_rate=rate,
                          window_seed=seed, pipeline="device", device=CPU)
    _assert_monitor_equal(ref, got)


def test_profile_binds_to_its_first_device():
    prof = StageProfile()
    assert prof.device is None and not prof.fence
    prof.bind("cpu").bind("cuda")
    assert prof.device == torch.device("cpu") and not prof.fence
    explicit = StageProfile("cuda")
    assert explicit.bind("cpu").device == torch.device("cuda")
    assert explicit.fence
    b = BatchedHitRatioFunctions.from_padded(
        torch.tensor([3, 5, 0, 2]),
        torch.tensor([0.5, 1.0, 0.0, 0.25], dtype=torch.float64),
        torch.tensor([2, 0, 1]), torch.tensor([0, 0, 3]),
        torch.tensor([4, 0, 8]))
    assert b.edges.tolist() == [0, 3, 5, 0, 0, 2]
    assert b.offsets.tolist() == [0, 3, 4, 6]
    assert b.n_accesses.tolist() == [4, 1, 8]
