"""The port's sharded window pipeline against the reference's host path.

``repro_torch.core.shard_pipeline`` (``monitor_window_sharded``,
``analyze_windows(pipeline="sharded")``, ``DeviceWindowPipeline(mesh=)``,
``ECICacheManager(pipeline="sharded")``) runs here on ``device="cpu"`` at
1, 2 and 8 logical shards (a ``ShardMesh`` repeating the CPU; the default
mesh reaches 2 and 8 through the ``shard_mesh`` fixture, which stands in
for ``control_plane_mesh`` as the reference's conftest forces 8 host
devices).  The cases are those of the reference's
``tests/test_shard_pipeline.py``.

The oracle is the reference's *host* path (its host monitor, fast and
heap walks and host manager), which the reference pins bit-identical to
its sharded outputs: the reference's own sharded and device programs
cannot run on this host's jax (ROADMAP §3, fault R1).  The placement
functions are pure numpy there and run: the port's copies are held to
them element by element.  Every per-tenant output is held exactly — curve
edges, heights and offsets, URD sizes, write ratios, sample rates, error
bars, allocations, hit ratios, policies — and the Eq. 2 aggregate
latency, a sum in another order, to rel 1e-12.  The same pipeline on the
card is held to the CPU and to ``pipeline="device"`` bit for bit in
``tests/test_torch_gpu.py``.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from oracle import examples
from repro.core import ECICacheManager as ManagerRef
from repro.core import Trace as TraceRef
from repro.core import analyze_windows as analyze_ref
from repro.core import greedy_allocate as greedy_ref
from repro.core.shard_pipeline import shard_assignment as assignment_ref
from repro.core.shard_pipeline import uniform_shard_layout as layout_ref
from repro_torch.core import (DeviceWindowPipeline, ECICacheManager,
                              StageProfile, Trace, analyze_windows)
from repro_torch.core import shard_pipeline
from repro_torch.core.shard_pipeline import (ShardIngest,
                                             ingest_window_sharded,
                                             monitor_window_sharded,
                                             shard_assignment,
                                             uniform_shard_layout)
from repro_torch.distributed import ShardMesh, control_plane_mesh

CPU = "cpu"
SHARD_COUNTS = (1, 2, 8)


def _mesh(k):
    return ShardMesh((torch.device(CPU),) * k)


@pytest.fixture(params=SHARD_COUNTS)
def shard_mesh(request, monkeypatch):
    """The default mesh at 1, 2 and 8 logical CPU shards: stands in for
    ``control_plane_mesh`` where the sharded pipeline looks it up, and
    records each lookup's device."""
    out = types.SimpleNamespace(mesh=_mesh(request.param), calls=[])

    def fake(n_shards=None, device=None):
        out.calls.append(torch.device(device))
        return out.mesh
    monkeypatch.setattr(shard_pipeline, "control_plane_mesh", fake)
    return out


def _rand_traces(seed, n_tenants=6, max_n=300, max_addr=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tenants):
        n = int(rng.integers(0, max_n))
        out.append((rng.integers(0, max_addr, n).astype(np.int64),
                    rng.random(n) < rng.uniform(0.1, 0.9)))
    return out


def _shard_traces(seed):
    """The reference's adversarial shapes: an empty window, single-access
    segments and lengths either side of a padded width (63/64/65 land in
    different width blocks: cross-shard width groups and the uniform
    layout's per-width row capacities)."""
    rng = np.random.default_rng(seed)
    out = _rand_traces(seed)
    out.append((np.zeros(0, np.int64), np.zeros(0, bool)))
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


def _window(raw):
    lens = [len(a) for a, _ in raw]
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64).tolist()
    a = torch.as_tensor(np.concatenate([x for x, _ in raw]) if sum(lens)
                        else np.zeros(0, np.int64))
    r = torch.as_tensor(np.concatenate([y for _, y in raw]) if sum(lens)
                        else np.zeros(0, bool))
    return a, r, bounds, lens


def _eq(got, want):
    np.testing.assert_array_equal(torch.as_tensor(got).cpu().numpy(),
                                  np.asarray(want))


def _assert_curves_equal(got, ref):
    for f in ("edges", "heights", "offsets", "n_accesses"):
        _eq(getattr(got, f), getattr(ref, f))


def _assert_monitor_equal(ref, got):
    _assert_curves_equal(got.curves, ref.curves)
    for f in ("urd_sizes", "write_ratios", "sample_rates", "expected_errors"):
        _eq(getattr(got, f), getattr(ref, f))
    assert got.kind == ref.kind


# ------------------------------------------------- sharded == host monitor
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("kind", ["urd", "trd"])
def test_sharded_monitor_bit_identical(kind, n_shards):
    """The exact path at every mesh width on the adversarial shapes, one
    sync (the fetch) in its one window, under the sanitizer."""
    raw = _shard_traces(0)
    ref = analyze_ref(_ref(raw), kind)
    prof = StageProfile()
    curves, urd, wr, cold = monitor_window_sharded(
        *_window(raw), mesh=_mesh(n_shards), kind=kind, profile=prof,
        transfer_sanitize=True)
    _assert_curves_equal(curves, ref.curves)
    _eq(urd, ref.urd_sizes)
    _eq(wr, ref.write_ratios)
    # cold accesses: each tenant's distinct addresses
    _eq(cold, [len(np.unique(a)) for a, _ in raw])
    assert prof.windows == 1 and prof.syncs == 1
    assert set(prof.times) == {"ingest", "dispatch", "fetch"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["urd", "trd"])
def test_analyze_windows_sharded_default_mesh(kind, seed, shard_mesh):
    """``analyze_windows(pipeline="sharded")`` over the default mesh
    reproduces the host monitor bit for bit, one sync a window."""
    raw = _shard_traces(seed)
    ref = analyze_ref(_ref(raw), kind)
    prof = StageProfile()
    got = analyze_windows(_port(raw), kind, pipeline="sharded", profile=prof,
                          device=CPU)
    _assert_monitor_equal(ref, got)
    assert prof.windows == 1 and prof.syncs_per_window == 1.0
    assert shard_mesh.calls == [torch.device(CPU)]


def test_sharded_more_shards_than_tenants():
    """8 shards, 2 tenants: most shards carry only the uniform layout's
    pad rows and must add exact zeros."""
    raw = _rand_traces(3, n_tenants=2, max_n=120)
    ref = analyze_ref(_ref(raw), "urd")
    mesh = _mesh(8)
    a, r, bounds, lens = _window(raw)
    ing = ingest_window_sharded(a, r, bounds, lens, mesh=mesh)
    assert len(ing.shards) == 8
    for view in ing.shards:          # the same structure on every shard
        assert view.wg == ing.shards[0].wg and view.total == view.wg[-1][2]
    empty = [v for v in ing.shards if bool((v.dev["gtid"] == 2).all())]
    assert len(empty) >= 6
    curves, urd, wr, _ = monitor_window_sharded(a, r, bounds, lens,
                                                mesh=mesh)
    _assert_curves_equal(curves, ref.curves)
    _eq(urd, ref.urd_sizes)
    _eq(wr, ref.write_ratios)


def test_sharded_single_tenant_per_shard(monkeypatch):
    """8 equal-width tenants over 8 shards: LPT gives every shard exactly
    one segment (the fully distributed corner)."""
    monkeypatch.setattr(shard_pipeline, "control_plane_mesh",
                        lambda n_shards=None, device=None: _mesh(8))
    rng = np.random.default_rng(11)
    raw = [(rng.integers(0, 30, 100).astype(np.int64), rng.random(100) < 0.6)
           for _ in range(8)]
    ref = analyze_ref(_ref(raw), "urd")
    got = analyze_windows(_port(raw), "urd", pipeline="sharded", device=CPU)
    _assert_monitor_equal(ref, got)
    widths = [128] * 8                            # 100 pads to 128
    assert sorted(shard_assignment(widths, 8).tolist()) == list(range(8))
    ing = ingest_window_sharded(*_window(raw), mesh=_mesh(8))
    assert [int(v.dev["row_tids"][0]) for v in ing.shards] == list(range(8))
    assert ing.shards[0].total == 128


def test_sharded_all_empty_window(shard_mesh):
    """An all-empty window takes the trivial result: parity, no sync."""
    raw = [(np.zeros(0, np.int64), np.zeros(0, bool))] * 3
    ref = analyze_ref(_ref(raw), "urd")
    prof = StageProfile()
    got = analyze_windows(_port(raw), "urd", pipeline="sharded",
                          profile=prof, device=CPU)
    _assert_monitor_equal(ref, got)
    assert prof.syncs == 0 and prof.windows == 1
    assert ingest_window_sharded(*_window(raw), mesh=shard_mesh.mesh) is None


@pytest.mark.parametrize("rate", [0.5, "auto"])
def test_sharded_sampled_bit_identical(rate, shard_mesh):
    """The SHARDS-filtered sub-tape across the mesh: the same salts and
    kept segments, scaled distances, HT heights and error bars."""
    raw = _shard_traces(7)
    ref = analyze_ref(_ref(raw), "urd", sample_rate=rate, window_seed=11)
    got = analyze_windows(_port(raw), "urd", sample_rate=rate,
                          window_seed=11, pipeline="sharded", device=CPU)
    _assert_monitor_equal(ref, got)
    assert (float(got.expected_errors.max()) > 0.0) == (rate == 0.5)


def test_sharded_rejects_percentile():
    with pytest.raises(ValueError, match="percentile"):
        analyze_windows(_port(_rand_traces(0)), "urd", percentile=90.0,
                        pipeline="sharded", device=CPU)


def test_control_plane_mesh_devices():
    """On the CPU, ``n_shards`` logical shards (default 1); with no device
    the mesh asks for the card, and raises where none is visible."""
    assert control_plane_mesh(device=CPU) == _mesh(1)
    assert control_plane_mesh(8, device=CPU).size == 8
    assert control_plane_mesh(0, device=CPU).size == 1
    mesh = _mesh(2)
    assert hash(mesh) == hash(ShardMesh(("cpu", "cpu"))) and mesh.size == 2
    with pytest.raises(ValueError, match="at least one device"):
        ShardMesh(())
    if torch.cuda.is_available():
        cards = control_plane_mesh()
        assert cards.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in cards.devices)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            control_plane_mesh()


def test_ingest_key_trash_slot_and_store():
    """The key is (shard width groups, shards, tenants, sampled, kind,
    mesh); surplus rows carry the trash tenant n and the pad sentinels;
    ``row_start`` addresses each tenant's row in the concatenated store."""
    raw = _shard_traces(3)
    n = len(raw)
    a, r, bounds, lens = _window(raw)
    mesh = _mesh(2)
    ing = ingest_window_sharded(a, r, bounds, lens, mesh=mesh, kind="trd")
    assert isinstance(ing, ShardIngest) and ing.device == torch.device(CPU)
    shard_wg, k, n_key, sampled, kind, mesh_key = ing.key
    assert (k, n_key, sampled, kind, mesh_key) == (2, n, False, "trd", mesh)
    S = shard_wg[-1][2]
    assert ing.store.total == 2 * S and ing.store.n == n + 1
    assert ing.store.wg == tuple((w, s * S + lo, s * S + hi) for s in (0, 1)
                                 for w, lo, hi in shard_wg)
    gtid = ing.store.dev["gtid"]
    grank = ing.store.dev["grank"]
    for i, ln in enumerate(lens):
        rows = torch.nonzero(gtid == i).flatten()
        if ln:
            assert int(rows[0]) == int(ing.row_start[i])
            assert int(grank[rows[0]]) == 0
            assert rows.numel() == max(1 << (ln - 1).bit_length(), 64)
        else:
            assert rows.numel() == 0
    for view in ing.shards:
        d = view.dev
        pad = d["gtid"] == n
        assert bool((d["gprev"][pad] == -1).all())
        assert bool((d["gocc"][pad] == 0).all())
        assert torch.equal(d["gnxt"][pad], torch.arange(S)[pad])
        assert view.n == n + 1 and d["rates"].shape == (n + 1,)
    _eq(ing.cold, [len(np.unique(x)) for x, _ in raw])


# --------------------------------------------- decision pipeline + stream
@pytest.mark.parametrize("frac", [0.1, 0.6, 2.0])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_decision_pipeline_matches_device(n_shards, frac):
    """``DeviceWindowPipeline(mesh=)`` decides as the single-device
    pipeline and as the reference's fast walk on the host curves (the
    budget cut runs once, over the concatenated store), in the scale-down,
    walk and feasible branches, one sync a window under the sanitizer."""
    raw = _shard_traces(5)
    mon = analyze_ref(_ref(raw), "urd")
    cap = max(int(mon.urd_sizes.sum() * frac), 1)
    part = greedy_ref(mon.curves, cap, 1.0, 20.0, c_min=4, method="fast")
    solo = DeviceWindowPipeline(cap, c_min=4, device=CPU)
    shrd = DeviceWindowPipeline(cap, c_min=4, mesh=_mesh(n_shards),
                                transfer_sanitize=True)
    assert shrd.device == torch.device(CPU)
    prof = StageProfile()
    a, b = solo.run(_port(raw)), shrd.run(_port(raw), profile=prof)
    assert prof.syncs_per_window == 1.0 and prof.windows == 1
    assert b.feasible == a.feasible == part.feasible
    for f in ("sizes", "urd_sizes", "hit_ratios", "write_ratios"):
        _eq(getattr(b, f), getattr(a, f))
    _assert_curves_equal(b.curves, a.curves)
    _eq(b.sizes, part.sizes)
    _eq(b.hit_ratios, part.hit_ratios)
    _eq(b.urd_sizes, mon.urd_sizes)
    assert b.latency == pytest.approx(part.latency, rel=1e-12)


def test_sharded_weighted_decision_matches_host():
    """Weights gain the trash slot at weight 0: the weighted walk and the
    latency equal the reference's heap walk."""
    raw = _shard_traces(8)
    mon = analyze_ref(_ref(raw), "trd")
    w = np.linspace(0.25, 3.0, len(raw))
    cap = int(mon.urd_sizes.sum() * 0.4)
    part = greedy_ref(mon.curves, cap, 2.0, 30.0, c_min=3, weights=w,
                      method="heap")
    dec = DeviceWindowPipeline(cap, t_fast=2.0, t_slow=30.0, c_min=3,
                               kind="trd", weights=w, mesh=_mesh(8)
                               ).run(_port(raw))
    _eq(dec.sizes, part.sizes)
    _eq(dec.hit_ratios, part.hit_ratios)
    assert dec.latency == pytest.approx(part.latency, rel=1e-12)


def test_sharded_run_stream_double_buffered(shard_mesh):
    """The double-buffered stream over the mesh equals windows run one at
    a time, an empty window interleaved; one sync a window with work."""
    empty = [(np.zeros(0, np.int64), np.zeros(0, bool))] * 3
    wins = [_shard_traces(s) for s in (0, 1)] + [empty] + [_shard_traces(2)]
    pipe = DeviceWindowPipeline(capacity=300, c_min=3, mesh=shard_mesh.mesh,
                                transfer_sanitize=True)
    prof = StageProfile()
    stream = pipe.run_stream([_port(w) for w in wins], profile=prof)
    solo = [pipe.run(_port(w)) for w in wins]
    single = [DeviceWindowPipeline(300, c_min=3, device=CPU).run(_port(w))
              for w in wins]
    assert len(stream) == len(wins)
    for a, b, c in zip(stream, solo, single):
        for f in ("sizes", "urd_sizes", "hit_ratios"):
            _eq(getattr(a, f), getattr(b, f))
            _eq(getattr(a, f), getattr(c, f))
        assert a.feasible == b.feasible and a.latency == b.latency
    assert prof.windows == 4 and prof.syncs == 3
    assert stream[2].latency == 20.0 * 3 and bool(stream[2].feasible)


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
def test_manager_sharded_pipeline_matches_host(capacity, shard_mesh):
    """``ECICacheManager(pipeline="sharded")`` decides as the reference's
    host manager window for window, and as the port's host manager in
    everything it records."""
    names = [f"t{i}" for i in range(5)]
    ref = ManagerRef(capacity, names, c_min=8, pipeline="host")
    shrd = ECICacheManager(capacity, names, c_min=8, pipeline="sharded",
                           device=CPU)
    host = ECICacheManager(capacity, names, c_min=8, device=CPU)
    for win in _manager_windows(17):
        ref.run_window(_ref(win))
        shrd.run_window(_port(win))
        host.run_window(_port(win))
    assert len(shard_mesh.calls) == 3          # one default mesh an analyze
    for a, b, c in zip(ref.history, shrd.history, host.history):
        assert [p.value for p in a.policies] == [p.value for p in b.policies]
        _eq(b.sizes, a.sizes)
        assert b.feasible == a.feasible
        assert b.partition.latency == pytest.approx(a.partition.latency,
                                                    rel=1e-12)
        assert b.sizes.tolist() == c.sizes.tolist() and b.guard == c.guard
    for tb, tc in zip(shrd.tenants, host.tenants):
        assert tb.result == tc.result
        _eq(tb.h_fn.edges, tc.h_fn.edges)
        _eq(tb.h_fn.heights, tc.h_fn.heights)
    assert shrd.summary() == host.summary()


def test_manager_sharded_pipeline_sampled(shard_mesh):
    """The sampled branch through the sharded manager, against the
    reference's host manager and the port's (its sample rates too)."""
    names = [f"t{i}" for i in range(4)]
    ref = ManagerRef(400, names, c_min=6, sample_rate=0.5)
    shrd = ECICacheManager(400, names, c_min=6, sample_rate=0.5,
                           pipeline="sharded", device=CPU)
    host = ECICacheManager(400, names, c_min=6, sample_rate=0.5, device=CPU)
    for win in _manager_windows(23, tenants=4, windows=2):
        ref.run_window(_ref(win))
        shrd.run_window(_port(win))
        host.run_window(_port(win))
    for a, b, c in zip(ref.history, shrd.history, host.history):
        _eq(b.sizes, a.sizes)
        assert [p.value for p in a.policies] == [p.value for p in b.policies]
        assert torch.equal(b.sample_rates, c.sample_rates)
    assert shrd.summary() == host.summary()


# --------------------------------------------------- placement invariants
def _widths_strategy():
    return st.lists(st.integers(0, 10), min_size=1, max_size=40)


@settings(max_examples=examples(60), deadline=None)
@given(_widths_strategy(), st.sampled_from([1, 2, 3, 8]))
def test_shard_assignment_invariants(exps, n_shards):
    """The reference's functions element by element; a true partition,
    per-shard descending self-aligned layout, and the largest shard load
    within 2x of the optimum."""
    widths = np.sort(2 ** np.array(exps, np.int64))[::-1]
    assign = shard_assignment(widths, n_shards)
    want = assignment_ref(widths, n_shards)
    _eq(assign, want)
    lay = uniform_shard_layout(widths, assign, n_shards)
    lr = layout_ref(widths, want, n_shards)
    for f in ("uwidths", "rcap", "entry_base", "row_index"):
        _eq(getattr(lay, f), getattr(lr, f))
    assert (lay.size, lay.rows, lay.shard_wg) == (lr.size, lr.rows,
                                                  lr.shard_wg)
    assign, base = assign.numpy(), lay.entry_base.numpy()
    assert ((assign >= 0) & (assign < n_shards)).all()
    assert (base % widths == 0).all() and (base >= 0).all()
    assert (base + widths <= lay.size).all()
    for s in range(n_shards):
        rows = np.flatnonzero(assign == s)
        w_s = widths[rows]
        assert (np.diff(w_s) <= 0).all()
        order = np.argsort(base[rows], kind="stable")
        lo = base[rows][order]
        assert (lo[:-1] + w_s[order][:-1] <= lo[1:]).all()
    loads = np.bincount(assign, weights=widths, minlength=n_shards)
    opt_lb = max(int(np.ceil(widths.sum() / n_shards)), int(widths.max()))
    assert int(loads.max()) <= 2 * opt_lb


@pytest.mark.slow
@settings(max_examples=examples(10), deadline=None)
@given(st.integers(0, 10**6), st.sampled_from([None, 0.4]),
       st.sampled_from(["urd", "trd"]), st.sampled_from([2, 8]))
def test_sharded_differential_deep(seed, rate, kind, n_shards):
    """Nightly depth: randomized window shapes, host vs the sharded mesh."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(int(rng.integers(1, 10))):
        n = int(rng.integers(0, 200))
        raw.append((rng.integers(0, 30, n).astype(np.int64),
                    rng.random(n) < rng.uniform(0, 1)))
    ref = analyze_ref(_ref(raw), kind, sample_rate=rate, window_seed=seed)
    if rate is None:
        curves, urd, wr, _ = monitor_window_sharded(
            *_window(raw), mesh=_mesh(n_shards), kind=kind)
        _assert_curves_equal(curves, ref.curves)
        _eq(urd, ref.urd_sizes)
        _eq(wr, ref.write_ratios)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(shard_pipeline, "control_plane_mesh",
                       lambda n_shards_=None, device=None: _mesh(n_shards))
            got = analyze_windows(_port(raw), kind, sample_rate=rate,
                                  window_seed=seed, pipeline="sharded",
                                  device=CPU)
        _assert_monitor_equal(ref, got)
