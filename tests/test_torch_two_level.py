"""The port's two-level (ETICA) hierarchy against the JAX reference.

Every piece is fed the same numpy-seeded inputs as its reference
counterpart and held to it exactly unless stated:

* the plain versions of the two new CUDA kernels — the port's
  ``cache_sim_levels_ref``, ``live_counts_ref`` and ``live_counts_delta``
  (and the wrappers ``cache_sim_levels_scan``/``live_count_scan``, which
  take them on CPU tensors) — against ``repro.kernels.cache_sim.ref``,
  with rows whose ``nxt[j] <= j`` held to the dense definition, and
  (``slow``) against the Pallas kernels in interpret mode; the CUDA levels
  kernel's decomposition, ``cache_sim_levels_tiled_ref``, against the
  Pallas ``cache_sim_levels_scan`` in interpret mode at several tile
  widths, with rows of cap1 > captot, cap1 = 0 and captot = 0; the CUDA
  live count's one-pass decomposition, ``live_counts_onepass_ref``,
  against the reference's dense ``live_counts_ref`` and its Pallas
  ``live_count_scan`` in interpret mode, at n = 1, a tile +- 1 and
  several tiles, with thousands of deaths on one word;
* ``simulate_many`` with two levels against the reference's
  ``simulate_many`` and ``simulate`` (and the port's own ``simulate``),
  cold and over warm multi-window chains, over WB/WT/RO x clean/dirty
  L2, ``C1 == 0``, ``C2 == 0`` (bit-identical to one level) and RO under
  pressure; latencies exactly against the reference's engine;
* ``_ro_token_replay_levels``, ``rebalance_levels``, the shifted curves
  (bit for bit), ``two_level_solve``, ``assign_write_policy_levels``,
  the guard with ``capacity2``, and the degenerate windows' ``fallback``;
* the ``etica`` manager live against ``repro.core.make_manager("etica",
  ...)`` (sizes, sizes2, policies, counts, final states of both levels,
  summary; aggregate partition latency to rel 1e-12), and the port's
  ``engine="batch"`` against its ``engine="lru"``.

The CUDA kernels themselves are held against these plain versions on
the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.batch_sim as pt_batch_sim
from repro.core import Trace as TraceRef
from repro.core import WritePolicy as WPRef
from repro.core import assign_write_policy_levels as levels_policy_ref
from repro.core import build_hit_ratio_function as build_ref
from repro.core import make_manager as make_manager_ref
from repro.core import simulate as simulate_ref
from repro.core import simulate_many as simulate_many_ref
from repro.core import two_level_solve as two_level_solve_ref
from repro.core.batch_sim import _ro_token_replay_levels as token_levels_ref
from repro.core.mrc import build_hit_ratio_functions as build_batched_ref
from repro.core.reuse_distance import reuse_distances as reuse_distances_ref
from repro.core.simulator import LRUCache as LRURef
from repro.core.simulator import rebalance_levels as rebalance_ref
from repro.core.trace import prev_next_occurrence as links_ref
from repro.data.traces import msr_trace as msr_trace_ref
from repro.kernels.cache_sim import ops as ref_ops
from repro.kernels.cache_sim import ref as ref_jax
from repro.kernels.cache_sim.kernel import \
    cache_sim_levels_scan as levels_scan_tpu
from repro.kernels.cache_sim.kernel import live_count_scan as live_scan_tpu
from repro_torch.core import (LRUCache, Trace, WritePolicy,
                              assign_write_policy_levels, guard,
                              make_manager, rebalance_levels, simulate,
                              simulate_batch, simulate_many, two_level_solve)
from repro_torch.core.batch_sim import _ro_token_replay_levels
from repro_torch.core.manager import AnalyzerDecision
from repro_torch.core.mrc import (build_hit_ratio_function,
                                  build_hit_ratio_functions)
from repro_torch.core.partitioner import PartitionResult
from repro_torch.core.reuse_distance import RDResult
from repro_torch.data.traces import msr_trace
from repro_torch.kernels.cache_sim import ops
from repro_torch.kernels.cache_sim.kernel import (cache_sim_levels_scan,
                                                  live_count_scan)
from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                               cache_sim_levels_tiled_ref,
                                               live_counts_delta,
                                               live_counts_onepass_ref,
                                               live_counts_ref)

POL = ["wb", "wt", "ro"]
FIELDS = ("reads", "read_hits", "read_hits_l2", "writes", "write_hits",
          "write_hits_l2", "cache_writes", "cache_writes_l2", "capacity",
          "capacity2", "policy", "policy2", "fallback")
NAMES = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]
SIM = dict(t_fast=1.0, t_slow=20.0, flush_cost=10.0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _links(n, seed, blocks=3):
    """Severed multi-tenant links from numpy (independent of the port):
    prev, nxt clamped to the block end, and a read mask."""
    rng = np.random.default_rng(seed)
    cuts = (np.sort(rng.choice(np.arange(1, n), size=min(blocks - 1, n - 1),
                               replace=False)) if n > 1 else np.zeros(0))
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    prev = np.full(n, -1, np.int64)
    nxt = np.zeros(n, np.int64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        p, x = links_ref(rng.integers(0, max(3, (e - s) // 4), e - s))
        prev[s:e] = np.where(p >= 0, p + s, -1)
        nxt[s:e] = np.minimum(x + s, e)
    return prev, nxt, rng.random(n) < 0.6


def _states(c):
    a, d = c.state_arrays()
    if a is None:
        return [], []
    return np.asarray(a).tolist(), np.asarray(d).tolist()


def _assert_results(r_ref, r_pt, exact_latency=True, fields=FIELDS):
    for f in fields:
        assert getattr(r_ref, f) == getattr(r_pt, f), \
            (f, getattr(r_ref, f), getattr(r_pt, f))
    if exact_latency:
        assert r_ref.total_latency == r_pt.total_latency
    else:
        assert r_pt.total_latency == pytest.approx(r_ref.total_latency,
                                                   rel=1e-9, abs=1e-9)


# ------------------------------------------------ plain kernel versions
@pytest.mark.parametrize("n", [1, 2, 63, 257, 700])
def test_levels_and_live_refs_match_reference(n):
    prev, nxt, reads = _links(n, n)
    rng = np.random.default_rng(100 + n)
    cap1 = rng.integers(0, 6, n)
    captot = cap1 + rng.integers(0, 6, n)
    cap1[: n // 4] = 0                           # cap1 = 0 rows
    captot[n // 4: n // 2] = cap1[n // 4: n // 2]    # cap1 = captot rows
    j32 = lambda a: jnp.asarray(np.asarray(a), jnp.int32)  # noqa: E731
    p32 = lambda a: _t(a).to(torch.int32)                  # noqa: E731
    for occ in (np.ones(n, np.int64), reads.astype(np.int64)):
        want = [np.asarray(x) for x in ref_jax.cache_sim_levels_ref(
            j32(prev), j32(nxt), j32(occ), j32(cap1), j32(captot))]
        args = [p32(a) for a in (prev, nxt, occ, cap1, captot)]
        for got in (cache_sim_levels_ref(*args),
                    cache_sim_levels_scan(*args)):
            assert got[0].dtype == got[1].dtype == torch.int32
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
        want_live = np.asarray(ref_jax.live_counts_ref(j32(nxt), j32(occ)))
        for got in (live_counts_ref(p32(nxt), p32(occ)),
                    live_counts_delta(p32(nxt), p32(occ)),
                    live_count_scan(p32(nxt), p32(occ))):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want_live)
        np.testing.assert_array_equal(
            np.asarray(ref_jax.live_counts_delta(j32(nxt), j32(occ))),
            want_live)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_counts_follow_the_definition_on_dead_rows(seed):
    """Rows with ``nxt[j] <= j`` (a pad row's -1, ``nxt = j``) never
    count: the port's O(n) form follows the dense definition there, which
    the reference's clipped delta form does not."""
    n = 300
    rng = np.random.default_rng(seed)
    pos = np.arange(n)
    nxt = pos + rng.integers(1, 40, n)
    dead = rng.random(n) < 0.3
    nxt[dead] = rng.choice([-1, 0, 1], dead.sum()) * pos[dead] \
        - (rng.random(dead.sum()) < 0.5)
    nxt[rng.random(n) < 0.1] = n                 # alive to the end
    occ = (rng.random(n) < 0.7).astype(np.int64)
    want = np.asarray(ref_jax.live_counts_ref(jnp.asarray(nxt, jnp.int32),
                                              jnp.asarray(occ, jnp.int32)))
    a, o = _t(nxt).to(torch.int32), _t(occ).to(torch.int32)
    np.testing.assert_array_equal(live_counts_ref(a, o).numpy(), want)
    np.testing.assert_array_equal(live_counts_delta(a, o).numpy(), want)
    np.testing.assert_array_equal(live_count_scan(a, o).numpy(), want)


def test_level_ops_match_reference_ops():
    prev, nxt, reads = _links(900, 7)
    rng = np.random.default_rng(8)
    cap1 = rng.integers(0, 8, 900)
    captot = cap1 + rng.integers(0, 8, 900)
    want = ref_ops.residency_levels_accel(prev, nxt, cap1, captot,
                                          use_kernel=False)
    got = ops.residency_levels(_t(prev), _t(nxt), _t(cap1), _t(captot))
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), w)
    got = ops.residency_levels(_t(prev), _t(nxt), _t(cap1), _t(captot),
                               occ=_t(np.ones(900, np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for occ in (reads, np.arange(900) < 120):
        live = ops.ro_live_counts(_t(nxt), _t(occ))
        assert live.dtype == torch.int64
        np.testing.assert_array_equal(
            live.numpy(), ref_ops.ro_live_counts_accel(nxt, occ))


def test_level_kernels_check_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cache_sim_levels_scan(z, z, z, z, z[:3])
    with pytest.raises(ValueError):
        live_count_scan(z, z[:2])


@pytest.mark.slow
def test_levels_ref_matches_pallas_interpret():
    prev, nxt, reads = _links(400, 12)
    rng = np.random.default_rng(12)
    cap1 = rng.integers(0, 5, 400)
    captot = cap1 + rng.integers(0, 5, 400)
    j32 = lambda a: jnp.asarray(np.asarray(a), jnp.int32)  # noqa: E731
    for occ in (np.ones(400), reads):
        want = levels_scan_tpu(j32(prev), j32(nxt), j32(occ), j32(cap1),
                               j32(captot), interpret=True)
        got = cache_sim_levels_ref(*[_t(a).to(torch.int32) for a in
                                     (prev, nxt, occ, cap1, captot)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
@pytest.mark.parametrize("tile", [4, 16, 256])
def test_levels_tiled_decomposition_matches_pallas_interpret(tile, occ_kind):
    """``cache_sim_levels_scan``'s CUDA decomposition (the exact tiled
    count, then both compares) equals the reference's Pallas kernel in
    interpret mode and the dense version, for any capacities: rows with
    cap1 > captot, cap1 = 0 and captot = 0 among the rest."""
    n = 900
    prev, nxt, reads = _links(n, 40 + tile)
    rng = np.random.default_rng(tile)
    a, b = rng.integers(0, 24, n), rng.integers(0, 24, n)
    kind = rng.integers(0, 5, n)
    cap1 = np.select([kind == 0, kind == 2], [0, np.maximum(a, b)], a)
    captot = np.select([kind == 1, kind == 2], [0, np.minimum(a, b)], b)
    assert (cap1 > captot).any() and (cap1 == 0).any() and (captot == 0).any()
    occ = np.ones(n, np.int64) if occ_kind == "ones" else reads
    j32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)  # noqa: E731
    want = levels_scan_tpu(j32(prev), j32(nxt), j32(occ), j32(cap1),
                           j32(captot), interpret=True)
    args = [_t(x).to(torch.int32) for x in (prev, nxt, occ, cap1, captot)]
    got = cache_sim_levels_tiled_ref(*args, tile)
    for g, d, w in zip(got, cache_sim_levels_ref(*args), want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(d.numpy(), np.asarray(w))


def _live_tape(n, seed):
    """nxt and a read mask (numpy): ``_links``'s tape plus rows with
    ``nxt = -1`` and ``nxt = j`` (never live) and ``nxt >= n`` (live to
    the end), and, past 2,000 rows, 1,500 rows before the middle all dying
    at the middle word."""
    _, nxt, reads = _links(n, seed)
    rng = np.random.default_rng(seed)
    pos = np.arange(n)
    pick = rng.integers(0, 5, n)
    nxt = np.where(pick == 0, -1, np.where(pick == 1, pos, nxt))
    nxt = np.where(pick == 2, n + rng.integers(0, 3, n), nxt)
    if n > 2000:
        nxt[n // 2 - 1500:n // 2] = n // 2
    return nxt, reads


LIVE_CASES = [(1, 4096), (4095, 4096), (4096, 4096), (4097, 4096),
              (12293, 4096), (1, 16), (15, 16), (16, 16), (17, 16),
              (700, 16), (300, 1)]


@pytest.mark.parametrize("n,tile", LIVE_CASES)
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_live_onepass_ref_matches_reference(n, tile, occ_kind):
    """``live_count_scan``'s decomposition, tile by tile with the deaths
    carried forward, equals the reference's dense oracle: one row, a
    tile +- 1, several tiles (of the kernel's 4096 rows and of 16 and 1),
    rows that never or always live, and a word where 1,500 tokens die."""
    nxt, reads = _live_tape(n, n + tile)
    occ = np.ones(n, np.int32) if occ_kind == "ones" else reads
    want = np.asarray(ref_jax.live_counts_ref(jnp.asarray(nxt, jnp.int32),
                                              jnp.asarray(occ, jnp.int32)))
    got = live_counts_onepass_ref(_t(nxt).to(torch.int32),
                                  _t(occ).to(torch.int32), tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,tile", [(300, 16), (512, 4096)])
def test_live_onepass_ref_matches_pallas_interpret(n, tile):
    nxt, reads = _live_tape(n, 7 * n)
    want = np.asarray(live_scan_tpu(jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(reads, jnp.int32),
                                    interpret=True))
    got = live_counts_onepass_ref(_t(nxt).to(torch.int32),
                                  _t(reads).to(torch.int32), tile)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.slow
def test_live_counts_match_pallas_interpret():
    _, nxt, reads = _links(400, 13)
    want = np.asarray(live_scan_tpu(jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(reads, jnp.int32),
                                    interpret=True))
    a, o = _t(nxt).to(torch.int32), _t(reads).to(torch.int32)
    np.testing.assert_array_equal(live_counts_ref(a, o).numpy(), want)
    np.testing.assert_array_equal(live_counts_delta(a, o).numpy(), want)


# ------------------------------------------------ simulate_many, 2 levels
class _Chain:
    """Caches of both packages (reference batch, reference interpreter,
    port batch, port interpreter) replayed window by window, compared
    after each."""

    def __init__(self, caps1, caps2):
        mk = lambda cls, cs: [cls(int(c)) for c in cs]  # noqa: E731
        self.rb1, self.rb2 = mk(LRURef, caps1), mk(LRURef, caps2)
        self.ri1, self.ri2 = mk(LRURef, caps1), mk(LRURef, caps2)
        self.pb1, self.pb2 = mk(LRUCache, caps1), mk(LRUCache, caps2)
        self.pi1, self.pi2 = mk(LRUCache, caps1), mk(LRUCache, caps2)

    def run(self, windows, p1, p2, flush, t_fast2=None):
        kw2 = {} if t_fast2 is None else {"t_fast2": t_fast2}
        rb = simulate_many_ref(
            [TraceRef(a, r) for a, r in windows],
            policies=[WPRef(p) for p in p1], caches=self.rb1,
            policies2=[WPRef(p) for p in p2], caches2=self.rb2,
            flush_cost=flush, **kw2)
        ri = [simulate_ref(TraceRef(a, r), c1.capacity, WPRef(q1),
                           flush_cost=flush, cache=c1,
                           capacity2=c2.capacity, policy2=WPRef(q2),
                           cache2=c2, **kw2)
              for (a, r), c1, c2, q1, q2 in zip(windows, self.ri1, self.ri2,
                                                p1, p2)]
        pt = [Trace(_t(a), _t(r)) for a, r in windows]
        pb = simulate_many(pt, policies=[WritePolicy(p) for p in p1],
                           caches=self.pb1,
                           policies2=[WritePolicy(p) for p in p2],
                           caches2=self.pb2, flush_cost=flush,
                           device="cpu", **kw2)
        pi = [simulate(tr, c1.capacity, WritePolicy(q1), flush_cost=flush,
                       cache=c1, capacity2=c2.capacity,
                       policy2=WritePolicy(q2), cache2=c2, **kw2)
              for tr, c1, c2, q1, q2 in zip(pt, self.pi1, self.pi2, p1, p2)]
        for k in range(len(windows)):
            _assert_results(rb[k], pb[k])              # engines: exact
            _assert_results(ri[k], pi[k])              # interpreters: exact
            _assert_results(rb[k], pi[k], exact_latency=False,
                            fields=FIELDS[:-1])   # engine vs interpreter
            for a, b in ((self.rb1, self.pb1), (self.rb2, self.pb2),
                         (self.ri1, self.pi1), (self.ri2, self.pi2),
                         (self.rb1, self.pi1), (self.rb2, self.pi2)):
                assert _states(a[k]) == _states(b[k])
        return pb


def _windows(rng, tenants, max_n=40, max_addr=8):
    out = []
    for _ in range(tenants):
        n = int(rng.integers(0, max_n))
        out.append((rng.integers(0, max_addr, n).astype(np.int64),
                    rng.random(n) < 0.6))
    return out


@pytest.fixture
def level_replays(monkeypatch):
    """Counts the port's two-level eviction-token replays."""
    calls = []
    orig = pt_batch_sim._ro_token_replay_levels

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(pt_batch_sim, "_ro_token_replay_levels", counted)
    return calls


@pytest.mark.parametrize("p1", POL)
@pytest.mark.parametrize("p2", ["wb", "ro"])
def test_two_level_cold_and_warm_chains_match_reference(p1, p2):
    """Cold, then warm over three windows: per-level counts, latency and
    both levels' final states equal the reference's engine and both
    interpreters, for a dirty-accepting (WB) and a clean (RO) L2."""
    rng = np.random.default_rng(POL.index(p1) * 7 + (p2 == "ro"))
    for _ in range(12):
        T = int(rng.integers(1, 4))
        chain = _Chain(rng.integers(1, 5, T), rng.integers(1, 5, T))
        for w in range(3):
            chain.run(_windows(rng, T), [p1] * T, [p2] * T,
                      float(rng.choice([0.0, 10.0])))


def test_two_level_mixed_policies_and_capacities_match_reference():
    """Random per-tenant policies per window (so warm dirty L2 meets a
    clean policy), capacities 0..4 per level, both t_fast2 defaults."""
    rng = np.random.default_rng(5)
    for it in range(40):
        T = int(rng.integers(1, 4))
        chain = _Chain(rng.integers(0, 5, T), rng.integers(0, 5, T))
        for w in range(3):
            chain.run(_windows(rng, T),
                      [POL[i] for i in rng.integers(0, 3, T)],
                      [POL[i] for i in rng.integers(0, 3, T)],
                      float(rng.choice([0.0, 10.0])),
                      t_fast2=(4.0 if it % 2 else None))


@pytest.mark.parametrize("p1", POL)
def test_l1_zero_makes_l2_the_level(p1):
    """``C1 == 0``: L2 is the only level (hits at t_fast2, L2 cache
    writes; the RO level split puts every hit in L2)."""
    rng = np.random.default_rng(11 + POL.index(p1))
    for _ in range(15):
        chain = _Chain([0, 0], rng.integers(1, 6, 2))
        for w in range(3):
            res = chain.run(_windows(rng, 2), [p1, p1], ["wb", "ro"], 10.0)
            assert all(r.read_hits == 0 for r in res)


@pytest.mark.parametrize("policy", POL)
def test_capacity2_zero_is_single_level(policy):
    """``C2 == 0`` reproduces the single-level call bit for bit, in both
    of the port's engines."""
    rng = np.random.default_rng(21 + POL.index(policy))
    for _ in range(25):
        cap = int(rng.integers(0, 6))
        (a, r), = _windows(rng, 1)
        t = Trace(_t(a), _t(r))
        for eng in (simulate, simulate_batch):
            ca, cb = LRUCache(cap), LRUCache(cap)
            kw = {} if eng is simulate else {"device": "cpu"}
            r_old = eng(t, cap, WritePolicy(policy), flush_cost=10.0,
                        cache=ca, **kw)
            r_new = eng(t, cap, WritePolicy(policy), flush_cost=10.0,
                        cache=cb, capacity2=0, policy2=WritePolicy.RO, **kw)
            _assert_results(r_old, r_new)
            assert r_new.read_hits_l2 == r_new.cache_writes_l2 == 0
            assert _states(ca) == _states(cb)


@pytest.mark.parametrize("p2", ["wb", "ro"])
def test_ro_under_pressure_matches_reference(p2, level_replays):
    """Small capacities and few addresses push RO tenants past the guard
    (``L - U2 > C1``), warm chains seeded by a WB window first: the
    token replay with levels runs, and the level split comes from each
    token's level."""
    rng = np.random.default_rng(31 + (p2 == "ro"))
    for _ in range(15):
        chain = _Chain(rng.integers(1, 4, 2), rng.integers(1, 4, 2))
        for w in range(3):
            pol = "wb" if w == 0 else "ro"
            res = chain.run(_windows(rng, 2, max_n=60, max_addr=5),
                            [pol, pol], [p2, p2], 10.0)
            assert all(r.fallback == 0 for r in res
                       if r.reads + r.writes)
    assert level_replays


def test_ro_token_replay_levels_matches_reference():
    rng = np.random.default_rng(41)
    for it in range(80):
        n_l2, n_l1 = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        c1, c2 = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        n_l2, n_l1 = min(n_l2, c2), min(n_l1, c1)
        body = rng.integers(0, 5, int(rng.integers(1, 80)))
        addrs = np.concatenate([np.arange(100, 100 + n_l2 + n_l1), body])
        rd = np.concatenate([np.ones(n_l2 + n_l1, bool),
                             rng.random(body.size) < 0.7])
        prev, nxt = links_ref(addrs)
        nxt = np.minimum(nxt, addrs.size)
        force = np.zeros(addrs.size, bool)
        force[:n_l2 + n_l1] = np.arange(n_l2 + n_l1) % 2 == 0
        clean2 = bool(it % 2)
        want = token_levels_ref(rd, prev, nxt, force, c1, c2, n_l2, clean2)
        got = _ro_token_replay_levels(_t(rd), _t(prev), _t(nxt), _t(force),
                                      c1, c2, n_l2, clean2)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[2].dtype == torch.int8
        assert got[3:] == want[3:]


def test_promotion_demotion_and_clean_l2_flush():
    """r(a) r(b) r(a) at C1 = C2 = 1: the second r(a) is an L2 hit whose
    promotion demotes b; and a clean L2 flushes a dirty victim when it
    is demoted, keeping L2 content clean."""
    t = Trace(torch.tensor([0, 1, 0]), torch.ones(3, dtype=torch.bool))
    r = simulate_batch(t, 1, capacity2=1, t_fast2=4.0, device="cpu")
    assert (r.read_hits, r.read_hits_l2) == (0, 1)
    assert (r.cache_writes, r.cache_writes_l2) == (3, 2)
    assert r.total_latency == 2 * 20.0 + 4.0
    c1, c2 = LRUCache(1), LRUCache(1)
    t = Trace(torch.tensor([0, 1]), torch.tensor([False, True]))
    r = simulate_batch(t, 1, cache=c1, cache2=c2, policy2=WritePolicy.RO,
                       flush_cost=5.0, device="cpu")
    assert r.total_latency == 1.0 + 20.0 + 5.0
    assert _states(c2) == ([0], [False])


def test_rebalance_levels_matches_reference():
    a = (np.array([7, 8], np.int64), np.array([True, False]))
    b = (np.array([1, 2, 3], np.int64), np.array([False, True, False]))
    for cap1 in (1, 2, 3, 4, 6):
        r1, r2 = LRURef(cap1), LRURef(4)
        p1, p2 = LRUCache(cap1), LRUCache(4)
        r1.set_state_arrays(*a)
        r2.set_state_arrays(*b)
        p1.set_state_arrays(*map(_t, a))
        p2.set_state_arrays(*map(_t, b))
        rebalance_ref(r1, r2)
        rebalance_levels(p1, p2)
        assert _states(p1) == _states(r1) and _states(p2) == _states(r2)


def test_degenerate_windows_count_as_fallback():
    """An empty two-level window and warm L2 behind a dead level go
    through the interpreter, flagged; a pressure window does not."""
    empty = Trace(torch.zeros(0, dtype=torch.int64),
                  torch.zeros(0, dtype=torch.bool))
    r = simulate_batch(empty, 2, WritePolicy.RO, capacity2=2, device="cpu")
    r_ref = simulate_many_ref([TraceRef(np.zeros(0, np.int64),
                                        np.zeros(0, bool))], [2],
                              [WPRef.RO], capacities2=[2])[0]
    assert r.fallback == r_ref.fallback == 1
    c1, c2 = LRUCache(2), LRUCache(0)
    c2.set_state_arrays(torch.tensor([7]), torch.tensor([True]))
    t = Trace(torch.tensor([7, 8]), torch.ones(2, dtype=torch.bool))
    r = simulate_batch(t, 2, WritePolicy.RO, cache=c1, cache2=c2,
                       flush_cost=3.0, device="cpu")
    rc1, rc2 = LRURef(2), LRURef(0)
    rc2.set_state_arrays(np.array([7], np.int64), np.array([True]))
    r_ref = simulate_many_ref([TraceRef(np.array([7, 8], np.int64),
                                        np.ones(2, bool))], None,
                              [WPRef.RO], caches=[rc1], caches2=[rc2],
                              flush_cost=3.0)[0]
    _assert_results(r_ref, r)
    assert r.fallback == 1
    assert _states(c1) == _states(rc1) and _states(c2) == _states(rc2)
    t = Trace(torch.arange(6), torch.ones(6, dtype=torch.bool))
    assert simulate_batch(t, 1, WritePolicy.RO, capacity2=1,
                          device="cpu").fallback == 0


# ------------------------------------------------ curves and the solver
def _curves(seed, n=6, length=1200):
    """URD curves of the same traces in both packages (the port builds
    its curve from the reference's distances: its own URD scan is a
    later slice)."""
    ref, pt = [], []
    for i, nm in enumerate(NAMES[:n]):
        rd = reuse_distances_ref(msr_trace_ref(nm, length, seed=seed + i),
                                 "urd")
        ref.append(build_ref(rd))
        pt.append(build_hit_ratio_function(RDResult(_t(rd.distances),
                                                    "urd")))
    return ref, pt


def test_shifted_curves_bit_for_bit():
    ref, pt = _curves(4)
    for h_r, h_p in zip(ref, pt):
        np.testing.assert_array_equal(h_p.edges.numpy(), h_r.edges)
        m = h_r.max_useful_size
        for base in (0, 1, 5, m // 3, m // 2, m, m + 10):
            s_r, s_p = h_r.shifted(base), h_p.shifted(base)
            np.testing.assert_array_equal(s_p.edges.numpy(), s_r.edges)
            assert s_p.heights.numpy().tobytes() == s_r.heights.tobytes()
            assert s_p.n_accesses == s_r.n_accesses
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 300, 9)
    dist = np.concatenate([np.where(rng.random(k) < 0.3, -1,
                                    rng.integers(0, 200, k)) for k in lens])
    tid = np.repeat(np.arange(9), lens)
    b_r = build_batched_ref(dist, tid, 9, np.maximum(lens, 1))
    b_p = build_hit_ratio_functions(_t(dist), _t(tid), 9,
                                    _t(np.maximum(lens, 1)))
    for bases in (np.zeros(9, np.int64), rng.integers(0, 250, 9),
                  np.full(9, 10**6)):
        s_r, s_p = b_r.shifted(bases), b_p.shifted(_t(bases))
        np.testing.assert_array_equal(s_p.edges.numpy(), s_r.edges)
        np.testing.assert_array_equal(s_p.offsets.numpy(), s_r.offsets)
        assert s_p.heights.numpy().tobytes() == s_r.heights.tobytes()
        for i in range(9):                        # batched == per curve
            one = b_p[i].shifted(int(bases[i]))
            assert torch.equal(s_p[i].edges, one.edges)
            assert torch.equal(s_p[i].heights, one.heights)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_level_solve_matches_reference(seed):
    """Both PGD stages on batched curves: sizes of both levels, and the
    level-2 relaxed optimum bit for bit."""
    rng = np.random.default_rng(seed)
    n = 8
    lens = rng.integers(100, 500, n)
    dist = np.concatenate([np.where(rng.random(k) < 0.3, -1,
                                    rng.integers(0, rng.integers(20, 200), k))
                           for k in lens])
    tid = np.repeat(np.arange(n), lens)
    b_r = build_batched_ref(dist, tid, n, lens)
    b_p = build_hit_ratio_functions(_t(dist), _t(tid), n, _t(lens))
    cap = int(b_r.max_useful_sizes.sum() * 0.4)
    cap2 = int(b_r.max_useful_sizes.sum() * 0.3)
    p1r, p2r = two_level_solve_ref(b_r, cap, cap2, 1.0, 4.0, 20.0, c_min=5)
    p1p, p2p = two_level_solve(b_p, cap, cap2, 1.0, 4.0, 20.0, c_min=5)
    assert p1p.sizes.tolist() == list(p1r.sizes)
    assert p2p.sizes.tolist() == list(p2r.sizes)
    assert not p2p.feasible and int(p2p.sizes.sum()) <= cap2
    assert p2p.latency == pytest.approx(p2r.latency, rel=1e-12)
    p1b, p2b = two_level_solve(b_p, cap, 0, 1.0, 4.0, 20.0, c_min=5)
    assert p2b is None and torch.equal(p1b.sizes, p1p.sizes)
    # the per-curve list route gives the batched route's answer
    p1l, p2l = two_level_solve(list(b_p), cap, cap2, 1.0, 4.0, 20.0,
                               c_min=5)
    assert p2l.sizes.tolist() == p2p.sizes.tolist()


def test_assign_write_policy_levels_matches_reference():
    for seed in range(12):
        nm = NAMES[seed % len(NAMES)]
        t_r = msr_trace_ref(nm, 300, seed=seed)
        t_p = msr_trace(nm, 300, seed=seed)
        for thr in ((0.5, 0.3), (0.5, 0.2), (0.9, 0.1), (0.0, 0.0)):
            want = levels_policy_ref(t_r, *thr)
            got = assign_write_policy_levels(t_p, *thr)
            assert [p.value for p in got] == [p.value for p in want]


@pytest.mark.parametrize("sizes2,policies2,expect", [
    ([10, 20], [WritePolicy.WB, WritePolicy.RO], ()),
    ([100, 20], [WritePolicy.WB] * 2, ("L2 sizes exceed capacity",)),
    ([-1, 2], [WritePolicy.WB] * 2, ("negative L2 size",)),
    ([float("nan"), 2], [WritePolicy.WB] * 2, ("non-finite L2 size",)),
    ([1, 2], ["ro", WritePolicy.WB], ("invalid L2 policy",)),
])
def test_guard_checks_the_second_level(sizes2, policies2, expect):
    part = PartitionResult(torch.tensor([5, 5]), False, 1.0,
                           torch.tensor([0.5, 0.5], dtype=torch.float64))
    dec = AnalyzerDecision(torch.tensor([5, 5]), [WritePolicy.WB] * 2,
                           False, part, sizes2=torch.tensor(sizes2),
                           policies2=policies2)
    rep = guard.validate_decision(dec, 100, 50)
    assert rep.violations == tuple(
        v for v in rep.violations if any(e in v for e in expect))
    assert len(rep.violations) == len(expect)
    assert guard.validate_decision(dec, 100).ok == (
        "L1" not in " ".join(rep.violations))


# ------------------------------------------------ the etica manager
def _assert_same_managers(a, b, exact_latency=True):
    for da, db in zip(a.history, b.history):
        assert db.sizes.tolist() == list(da.sizes)
        assert db.sizes2.tolist() == list(da.sizes2)
        assert [p.value for p in db.policies] == \
            [p.value for p in da.policies]
        assert [p.value for p in db.policies2] == \
            [p.value for p in da.policies2]
        assert da.feasible == db.feasible
        assert da.guard == db.guard
        assert db.partition.latency == pytest.approx(da.partition.latency,
                                                     rel=1e-12)
        if da.partition2 is None:
            assert db.partition2 is None
        else:
            assert db.partition2.latency == pytest.approx(
                da.partition2.latency, rel=1e-12)
    for ta, tb in zip(a.tenants, b.tenants):
        _assert_results(ta.result, tb.result, exact_latency)
        assert _states(ta.cache) == _states(tb.cache)
        assert _states(ta.cache2) == _states(tb.cache2)
    sa, sb = a.summary(), b.summary()
    assert sb == pytest.approx({k: sa[k] for k in sb}, rel=1e-12)


@pytest.mark.parametrize("seed,cap1,cap2,w_threshold,pgd2", [
    (0, 150, 200, 0.5, True), (1, 300, 900, 0.5, False),
    (2, 30, 60, 0.0, True)])
def test_etica_manager_matches_reference(seed, cap1, cap2, w_threshold,
                                         pgd2, level_replays):
    """Infeasible L1 windows, and L2 windows infeasible (``pgd2``: PGD
    runs in both stages) or not; the last mix is all RO under pressure
    (``w_threshold=0``), where the two-level token replay runs and no
    window falls back to the interpreter."""
    kw = dict(capacity2=cap2, c_min=10, initial_blocks=30, t_fast2=4.0,
              w_threshold=w_threshold, **SIM)
    a = make_manager_ref("etica", cap1, NAMES, **kw)
    b = make_manager("etica", cap1, NAMES, device="cpu", **kw)
    for w in range(3):
        seeds = [97 * w + i + seed for i in range(len(NAMES))]
        a.run_window([msr_trace_ref(nm, 800, seed=s)
                      for nm, s in zip(NAMES, seeds)])
        b.run_window([msr_trace(nm, 800, seed=s)
                      for nm, s in zip(NAMES, seeds)])
    _assert_same_managers(a, b)
    assert not any(d.feasible for d in b.history)
    assert all(d.partition2.feasible != pgd2 for d in b.history)
    s = b.summary()
    assert s["ro_fallback_windows"] == 0
    assert s["allocated_blocks_l2"] > 0 and s["cache_writes_l2"] > 0
    assert s["read_hit_ratio_l2"] > 0
    if w_threshold == 0.0:
        assert all(t.policy is WritePolicy.RO for t in b.tenants)
        assert level_replays


def test_etica_batch_engine_equals_lru_engine():
    kw = dict(capacity2=400, c_min=10, initial_blocks=30, t_fast2=4.0,
              device="cpu", **SIM)
    mb = make_manager("etica", 150, NAMES[:4], engine="batch", **kw)
    ml = make_manager("etica", 150, NAMES[:4], engine="lru", **kw)
    for w in range(3):
        traces = [msr_trace(nm, 600, seed=97 * w + i)
                  for i, nm in enumerate(NAMES[:4])]
        mb.run_window(traces)
        ml.run_window(traces)
    _assert_same_managers(mb, ml, exact_latency=False)
    assert int(mb.history[-1].sizes2.sum()) > 0


def test_eci_lru_engine_matches_reference():
    """The single-level manager on the interpreter: engine="lru" in both
    packages."""
    kw = dict(c_min=10, initial_blocks=30, engine="lru", **SIM)
    a = make_manager_ref("eci", 200, NAMES, **kw)
    b = make_manager("eci", 200, NAMES, device="cpu", **kw)
    for w in range(2):
        a.run_window([msr_trace_ref(nm, 500, seed=7 * w + i)
                      for i, nm in enumerate(NAMES)])
        b.run_window([msr_trace(nm, 500, seed=7 * w + i)
                      for i, nm in enumerate(NAMES)])
    _assert_same_managers(a, b)
    assert b.summary()["allocated_blocks_l2"] == 0


def test_etica_needs_capacity2():
    with pytest.raises(ValueError, match="capacity2"):
        make_manager("etica", 100, NAMES, device="cpu")
    with pytest.raises(ValueError, match="capacity2"):
        make_manager_ref("etica", 100, NAMES)
    with pytest.raises(ValueError, match="engine"):
        make_manager("eci", 100, NAMES, device="cpu", engine="interp")
