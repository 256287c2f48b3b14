"""The port's serving side against the JAX reference, on the CPU.

* ``tests/test_serving.py``'s eleven tests, run against the port with
  ``device="cpu"``: the same setups and assertions (the engine ones on
  the qwen3 smoke config in bf16 over a float32 pool, as there).
* Seeded random sequences of ``allocate`` / ``lookup`` / ``pin`` /
  ``unpin`` / ``enforce_quota`` / ``release_tenant`` on metadata-only
  pools, and of ``access_page`` / ``rebalance`` / ``finish_tenant`` on
  tiered caches with ``capacity2`` 0 and > 0: after every step the free
  list, LRU orders, ``by_key``, pins, stats, ``host_lru`` and
  ``summary()`` (all but ``rebalance_seconds``) equal the reference's,
  and so do the managers' decisions.
* The engine against the reference's on qwen3's smoke config in float32,
  and on qwen2-moe's (the MoE serving path: each prefill request one
  routing group, each decode row its own), parameters carried across by
  ``params_from_jax``, the same numpy-made prompts (one ending mid-page,
  two sharing a prefix): generated tokens exactly equal; summaries,
  quotas, policies, pool stats and decisions equal; pool pages within
  1e-5.  Three distinct padded prompt lengths at most, so that the
  reference jits few shapes.
* The engine and the tiered cache traced into a profile of their own
  (``core/profile.py``): tokens, states and decisions still equal the
  reference's; one ``serve.prefill`` span a request and one
  ``serve.decode`` a step, each covered by its children, with a
  ``serve.decode.attention`` device span and a ``serve.decode.self_fold``
  count a layer (the in-flight token folded into ``paged_attention``);
  the requests' stamps
  in order; the window log's deltas summing to the ``TierStats`` totals;
  ``rebalance_seconds`` the sum of the ``cache.rebalance`` spans.
* The first token comes from the *padded* last position (the reference's
  ``engine.py:121-122`` and ``:84``), which the port keeps.
* ``core.stack_distances`` and ``trace.total_cache_writes_wb`` against
  the reference; the parts not ported raise naming their ROADMAP item;
  ``python -m repro_torch.launch.serve --device cpu`` serves its requests.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core as ref_core
from repro.cache import BlockPool as RefBlockPool
from repro.cache import TieredKVCache as RefTieredKVCache
from repro.core import ECICacheManager as RefManager
from repro.core import WritePolicy as RefWritePolicy
from repro.core.trace import Trace as RefTrace
from repro.models import model as RM
from repro.serve.engine import MultiTenantEngine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch import configs
from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.core import (ECICacheManager, StageProfile, Trace,
                              WritePolicy, stack_distances,
                              total_cache_writes_wb)
from repro_torch.data.traces import msr_trace
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models.attention import build_heads
from repro_torch.serve.engine import (MultiTenantEngine, Request,
                                      prefill_with_kv)

ARCH = "qwen3_0_6b"


# ------------------------------------------- tests/test_serving.py, ported
def _engine(n_pages=256, window_events=10**9, capacity=128, page=8,
            tenants=("t0", "t1")):
    cfg = configs.get_smoke_config(ARCH)
    params = M.init_params(cfg, seed=0, device="cpu")
    hq, hkv = build_heads(cfg)
    pool = BlockPool(n_pages, page, cfg.n_layers, hkv, cfg.head_dim,
                     dtype=torch.float32, device="cpu")
    mgr = ECICacheManager(capacity, list(tenants), c_min=8,
                          initial_blocks=32, device="cpu")
    tiered = TieredKVCache(pool, mgr, window_events=window_events)
    return MultiTenantEngine(cfg, params, tiered, page_size=page,
                             max_pages_per_seq=16), pool, tiered, cfg, params


def test_prefix_reuse_across_requests():
    eng, pool, tiered, cfg, _ = _engine()
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    for _ in range(3):
        eng.submit(Request(tenant=0, prompt=prefix.copy(), max_new_tokens=2))
    eng.run(16)
    assert pool.stats["reused"] >= 4            # 2 shared pages x 2 reuses
    assert tiered.stats[0].hbm_hits >= 4


def test_paged_decode_matches_dense_decode():
    eng, pool, tiered, cfg, params = _engine()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    eng.submit(Request(tenant=0, prompt=prompt, max_new_tokens=4))
    eng.run(16)
    paged_tokens = eng.completed[0].generated

    cache = M.init_decode_cache(cfg, 1, 64, device="cpu")
    out = None
    for t in range(len(prompt)):
        out, cache = M.decode_step(params, cfg,
                                   torch.as_tensor(prompt[t:t + 1]), cache)
    dense_tokens = [int(out[0, :cfg.vocab_size].argmax())]
    for _ in range(3):
        out, cache = M.decode_step(
            params, cfg, torch.tensor([dense_tokens[-1]]), cache)
        dense_tokens.append(int(out[0, :cfg.vocab_size].argmax()))
    assert paged_tokens == dense_tokens


def test_ro_policy_bypasses_admissions():
    eng, pool, tiered, cfg, _ = _engine()
    tiered.policies[1] = WritePolicy.RO
    rng = np.random.default_rng(2)
    eng.submit(Request(tenant=1,
                       prompt=rng.integers(0, cfg.vocab_size, 24
                                           ).astype(np.int32),
                       max_new_tokens=2))
    eng.run(8)
    assert tiered.stats[1].bypassed_writes > 0
    assert tiered.stats[1].hbm_writes == 0      # nothing admitted on write


def test_quota_enforcement_and_pinning():
    pool = BlockPool(64, 8, 2, 2, 16, allocate_device=False)
    for i in range(10):
        pid, _ = pool.allocate(0, key=("t0", i), quota=None)
        assert pid is not None
    pool.pin(next(iter(pool.lru[0])))           # pin the LRU page
    evicted = pool.enforce_quota(0, 4)
    assert pool.resident(0) == 4                # quota met
    assert len(evicted) == 6
    # the pinned page survived even though it was LRU-first
    assert any(pool.meta[p].pinned for p in pool.lru[0])


def test_pool_eviction_frees_keys():
    pool = BlockPool(4, 8, 1, 2, 16, allocate_device=False)
    pids = [pool.allocate(0, key=("k", i))[0] for i in range(4)]
    assert pool.lookup(("k", 0)) == pids[0]
    pool.allocate(0, key=("k", 9))              # full: evicts the LRU page
    assert len(pool.free) == 0
    assert pool.stats["evicted"] == 1


def test_release_tenant():
    pool = BlockPool(16, 8, 1, 2, 16, allocate_device=False)
    for i in range(5):
        pool.allocate(3, key=("x", i))
    assert pool.resident(3) == 5
    n = pool.release_tenant(3)
    assert n == 5 and pool.resident(3) == 0
    assert len(pool.free) == 16


def _tiered(n_pages=32, capacity=16, capacity2=0, window_events=10**9,
            tenants=("t0", "t1")):
    pool = BlockPool(n_pages, 8, 2, 2, 16, allocate_device=False)
    mgr = ECICacheManager(capacity, list(tenants), c_min=2,
                          initial_blocks=8, capacity2=capacity2,
                          device="cpu")
    return pool, mgr, TieredKVCache(pool, mgr, window_events=window_events)


def test_managed_host_demote_then_promote():
    """HBM victims land in the managed host tier; a later read is a host
    hit that promotes the page back into the pool."""
    pool, mgr, tiered = _tiered(n_pages=4, capacity2=64)
    for i in range(4):
        assert tiered.access_page(0, ("k", i), fresh=True) == "hbm"
    # pool full: admitting one more evicts the LRU page ("k", 0) -> demote
    tiered.access_page(0, ("k", 4), fresh=True)
    assert tiered.stats[0].demotions == 1
    assert ("k", 0) in tiered.host_lru[0]
    served = tiered.access_page(0, ("k", 0), fresh=False)
    assert served == "host"
    assert tiered.stats[0].host_hits == 1
    assert tiered.stats[0].promotions == 1
    assert ("k", 0) not in tiered.host_lru[0]       # exclusive levels
    assert pool.lookup(("k", 0)) is not None
    # unmanaged mode keeps the legacy "host retains everything" behaviour
    pool2, _, t2 = _tiered(n_pages=4, capacity2=0)
    for i in range(5):
        t2.access_page(0, ("k", i), fresh=True)
    assert t2.stats[0].demotions == 0
    assert t2.access_page(0, ("k", 0), fresh=False) == "host"


def test_managed_host_eviction_is_a_real_miss():
    """Pages falling off the managed host tier must be recomputed."""
    pool, mgr, tiered = _tiered(n_pages=4, capacity2=8)
    tiered.host_quotas[0] = 2
    for i in range(4):
        tiered.access_page(0, ("k", i), fresh=True)
    for i in range(4, 8):                 # 4 more admissions -> 4 demotions
        tiered.access_page(0, ("k", i), fresh=True)
    assert tiered.stats[0].demotions == 4
    assert tiered.stats[0].host_evictions == 2      # quota 2: oldest fell off
    assert len(tiered.host_lru[0]) == 2
    assert tiered.access_page(0, ("k", 0), fresh=False) == "miss"
    assert tiered.stats[0].misses == 1


def test_finish_tenant_redistributes_quota():
    """Retired tenants are excluded from partitioning and their freed
    space is redistributed at the next rebalance()."""
    pool, mgr, tiered = _tiered(n_pages=64, capacity=20, capacity2=30)
    # both tenants demand more than half the pool: infeasible regime
    for t in range(2):
        for i in range(40):
            tiered.access_page(t, (t, i), fresh=True)
        for i in range(40):
            tiered.access_page(t, (t, i), fresh=False)
    tiered.rebalance()
    before = dict(tiered.quotas)
    assert sum(v for v in before.values() if v) <= 20
    share_before = before[1]

    demo_before = tiered.stats[0].demotions
    hev_before = tiered.stats[0].host_evictions
    tiered.finish_tenant(0)
    assert pool.resident(0) == 0
    assert not mgr.tenants[0].active
    assert len(tiered.host_lru[0]) == 0
    # retiring pages are releases, not demotions: stats stay clean
    assert tiered.stats[0].demotions == demo_before
    assert tiered.stats[0].host_evictions == hev_before
    for i in range(40):
        tiered.access_page(1, (1, i), fresh=False)
    tiered.rebalance()
    d = mgr.history[-1]
    assert d.sizes[0] == 0                          # excluded from Alg. 1
    assert d.sizes2 is None or d.sizes2[0] == 0
    assert tiered.quotas[1] >= share_before         # freed space flows over
    assert tiered.quotas[0] == 0
    # retired tenant stays excluded and untouched on further rebalances
    for i in range(10):
        tiered.access_page(1, (1, 100 + i), fresh=True)
    tiered.rebalance()
    assert mgr.tenants[0].cache.capacity == 0
    assert mgr.tenants[0].cache2.capacity == 0


def test_monitor_batching_grows_and_flushes():
    pool, mgr, tiered = _tiered(window_events=10**9)
    # shrink the preallocated buffers so one doubling is exercised cheaply
    tiered._ev_tenant = np.empty(16, np.int32)
    tiered._ev_addr = np.empty(16, np.int64)
    tiered._ev_read = np.empty(16, bool)
    for i in range(20):
        tiered.access_page(i % 2, ("g", i), fresh=True)
    assert tiered._ev_addr.size == 32               # doubled once
    assert tiered._n_ev == 20
    tiered.rebalance()
    assert tiered._n_ev == 0
    assert tiered.rebalance_seconds > 0.0
    assert len(mgr.history) == 1                    # analyzer consumed them


def test_rebalance_applies_quotas():
    eng, pool, tiered, cfg, _ = _engine(window_events=4, capacity=16)
    rng = np.random.default_rng(3)
    for t in range(2):
        eng.submit(Request(tenant=t,
                           prompt=rng.integers(0, cfg.vocab_size, 32
                                               ).astype(np.int32),
                           max_new_tokens=3))
    eng.run(16)
    s = tiered.summary()
    for t, q in s["quotas"].items():
        if q is not None:
            assert pool.resident(t) <= max(q, pool.resident(t))  # no crash
    assert len(tiered.manager.history) >= 1     # analyzer ran


# ----------------------------------------- state held against the reference
def _pool_state(pool) -> tuple:
    return (list(pool.free),
            {t: list(q) for t, q in pool.lru.items()},
            dict(pool.by_key),
            {p: (m.tenant, m.key, m.dirty, m.pinned)
             for p, m in pool.meta.items()},
            dict(pool.stats))


def _summary(tiered) -> dict:
    s = dict(tiered.summary())
    s.pop("rebalance_seconds")
    return s


def _tiered_state(tiered) -> tuple:
    return (_pool_state(tiered.pool), _summary(tiered),
            {t: list(q) for t, q in tiered.host_lru.items()},
            [dataclasses.astuple(s) for s in tiered.stats],
            dict(tiered.host), tiered._n_ev)


def _decisions(mgr) -> list:
    return [(np.asarray(d.sizes).tolist(), [p.value for p in d.policies],
             bool(d.feasible),
             None if d.sizes2 is None else np.asarray(d.sizes2).tolist(),
             None if d.policies2 is None else [p.value for p in d.policies2],
             tuple(d.guard))
            for d in mgr.history]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_pool_random_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    ours = BlockPool(24, 8, 1, 2, 16, allocate_device=False)
    theirs = RefBlockPool(24, 8, 1, 2, 16, allocate_device=False)
    evicted = ([], [])
    ours.on_evict = lambda pid, m: evicted[0].append((pid, m.tenant, m.key))
    theirs.on_evict = lambda pid, m: evicted[1].append((pid, m.tenant, m.key))
    for step in range(400):
        op = rng.integers(0, 7)
        t = int(rng.integers(0, 3))
        key = ("k", t, int(rng.integers(0, 40)))
        pid = int(rng.integers(0, 24))
        if op <= 2:
            quota = None if rng.random() < 0.3 else int(rng.integers(0, 10))
            dirty = bool(rng.random() < 0.5)
            got = ours.allocate(t, key, quota=quota, dirty=dirty)
            want = theirs.allocate(t, key, quota=quota, dirty=dirty)
        elif op == 3:
            got, want = ours.lookup(key), theirs.lookup(key)
        elif op == 4:
            fn = "pin" if rng.random() < 0.6 else "unpin"
            got, want = getattr(ours, fn)(pid), getattr(theirs, fn)(pid)
        elif op == 5:
            quota = int(rng.integers(0, 8))
            got = ours.enforce_quota(t, quota)
            want = theirs.enforce_quota(t, quota)
        else:
            got, want = ours.release_tenant(t), theirs.release_tenant(t)
        assert got == want, (step, op)
        assert _pool_state(ours) == _pool_state(theirs), (step, op)
        assert [ours.resident(i) for i in range(3)] == \
            [theirs.resident(i) for i in range(3)]
    assert evicted[0] == evicted[1]


@pytest.mark.parametrize("capacity2", [0, 24])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_random_accesses_match_reference(seed, capacity2):
    """Random reads and writes over skewed keys (some re-read, some not),
    RO and WB tenants, explicit and window-triggered rebalances and one
    tenant finishing: every step's state and the managers' decisions
    equal the reference's."""
    rng = np.random.default_rng(seed)
    kw = dict(c_min=2, initial_blocks=8, capacity2=capacity2)
    ours_pool = BlockPool(20, 8, 2, 2, 16, allocate_device=False)
    theirs_pool = RefBlockPool(20, 8, 2, 2, 16, allocate_device=False)
    ours = TieredKVCache(ours_pool, ECICacheManager(16, ["a", "b", "c"],
                                                    device="cpu", **kw),
                         window_events=64)
    theirs = RefTieredKVCache(theirs_pool, RefManager(16, ["a", "b", "c"],
                                                      **kw),
                              window_events=64)
    ours.policies[2] = WritePolicy.RO
    theirs.policies[2] = RefWritePolicy.RO
    for step in range(300):
        t = int(rng.integers(0, 3))
        if step == 200:
            ours.finish_tenant(1)
            theirs.finish_tenant(1)
        if step >= 200 and t == 1:
            t = 0
        key = (t, int(rng.zipf(1.5) % 30))
        fresh = bool(rng.random() < 0.4)
        assert ours.access_page(t, key, fresh) == \
            theirs.access_page(t, key, fresh), step
        if rng.random() < 0.02:
            ours.rebalance()
            theirs.rebalance()
        assert _tiered_state(ours) == _tiered_state(theirs), step
    assert len(ours.manager.history) >= 3
    assert _decisions(ours.manager) == _decisions(theirs.manager)


# --------------------------------------- the engine against the reference's
_init_jax = jax.jit(RM.init_params, static_argnums=0)
# three lengths at page 8: 24 (prefix + 8, ending on a page edge), 29
# (prefix + 13, ending mid-page) and 16 (two whole pages, the prefix
# alone), each twice
PROMPT_LENS = (24, 29, 16, 29, 16, 24)
ENGINE_CASES = {
    # name: (arch, capacity, capacity2, window_events, RO tenant)
    "wb": (ARCH, 64, 0, 12, None),
    "two_level_ro": (ARCH, 24, 48, 10, 1),
    "moe_wb": ("qwen2_moe_a2_7b", 64, 0, 12, None),
}


def _prompts(vocab: int) -> list[tuple[int, np.ndarray]]:
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    out = []
    for i, n in enumerate(PROMPT_LENS):
        tail = rng.integers(0, vocab, n - 16).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if n > 16 else shared.copy()
        out.append((i % 2, prompt))
    return out


def _serve(engine_cls, request_cls, cfg, params, pool, tiered, prompts,
           new_tokens):
    eng = engine_cls(cfg, params, tiered, page_size=8, max_pages_per_seq=8)
    for t, p in prompts:
        eng.submit(request_cls(tenant=t, prompt=p.copy(),
                               max_new_tokens=new_tokens))
    eng.run(64)
    return eng


@lru_cache(maxsize=None)
def _reference_engine(case):
    """The reference's engine on the fp32 smoke config (jitted once per
    case): its parameters, tokens, states, decisions and pool."""
    arch, capacity, capacity2, window, ro = ENGINE_CASES[case]
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                               dtype="float32")
    params = _init_jax(rcfg, jax.random.PRNGKey(0))
    pool = RefBlockPool(96, 8, rcfg.n_layers, rcfg.n_kv_heads,
                        rcfg.head_dim, dtype=jnp.float32)
    mgr = RefManager(capacity, ["chat", "batch"], c_min=4, initial_blocks=16,
                     capacity2=capacity2)
    tiered = RefTieredKVCache(pool, mgr, window_events=window)
    if ro is not None:
        tiered.policies[ro] = RefWritePolicy.RO
    eng = _serve(RefEngine, RefRequest, rcfg, params, pool, tiered,
                 _prompts(rcfg.vocab_size), 5)
    return (jax.tree.map(np.asarray, params),
            sorted((r.rid, list(r.generated)) for r in eng.completed),
            _tiered_state(tiered), _decisions(mgr),
            np.asarray(pool.k_pages), np.asarray(pool.v_pages))


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(case):
    params_np, tokens, state, decisions, kp, vp = _reference_engine(case)
    arch, capacity, capacity2, window, ro = ENGINE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    params = M.params_from_jax(params_np, "cpu")
    pool = BlockPool(96, 8, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.float32, device="cpu")
    mgr = ECICacheManager(capacity, ["chat", "batch"], c_min=4,
                          initial_blocks=16, capacity2=capacity2,
                          device="cpu")
    tiered = TieredKVCache(pool, mgr, window_events=window)
    if ro is not None:
        tiered.policies[ro] = WritePolicy.RO
    eng = _serve(MultiTenantEngine, Request, cfg, params, pool, tiered,
                 _prompts(cfg.vocab_size), 5)
    assert sorted((r.rid, list(r.generated)) for r in eng.completed) == \
        tokens
    assert _tiered_state(tiered) == state
    assert _decisions(mgr) == decisions
    assert len(decisions) >= 2                  # rebalanced mid-run
    np.testing.assert_allclose(pool.k_pages.numpy(), kp, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pool.v_pages.numpy(), vp, rtol=1e-5,
                               atol=1e-5)


class _CountingEngine(MultiTenantEngine):
    """The engine, counting the steps that decoded some request."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.decoding_steps = 0

    def _decode_batch(self) -> None:
        self.decoding_steps += any(not r.done for r in self.active)
        super()._decode_batch()


@lru_cache(maxsize=None)
def _traced_engine(case):
    """``test_engine_matches_reference``'s port side, the engine and the
    tiered cache given one profile of their own."""
    params_np = _reference_engine(case)[0]
    arch, capacity, capacity2, window, ro = ENGINE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    params = M.params_from_jax(params_np, "cpu")
    pool = BlockPool(96, 8, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.float32, device="cpu")
    mgr = ECICacheManager(capacity, ["chat", "batch"], c_min=4,
                          initial_blocks=16, capacity2=capacity2,
                          device="cpu")
    prof = StageProfile()
    tiered = TieredKVCache(pool, mgr, window_events=window, profile=prof)
    if ro is not None:
        tiered.policies[ro] = WritePolicy.RO
    eng = _CountingEngine(cfg, params, tiered, page_size=8,
                          max_pages_per_seq=8, profile=prof)
    for t, p in _prompts(cfg.vocab_size):
        eng.submit(Request(tenant=t, prompt=p.copy(), max_new_tokens=5))
    eng.run(64)
    return eng, tiered, mgr, prof


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_traced_engine_matches_reference(case):
    _, tokens, state, decisions, kp, vp = _reference_engine(case)
    eng, tiered, mgr, prof = _traced_engine(case)
    assert sorted((r.rid, list(r.generated)) for r in eng.completed) == \
        tokens
    assert _tiered_state(tiered) == state
    assert _decisions(mgr) == decisions
    np.testing.assert_allclose(tiered.pool.k_pages.numpy(), kp, rtol=1e-5,
                               atol=1e-5)
    assert len(prof.spans("serve.decode")) == eng.decoding_steps > 0
    assert len(prof.window_log) == len(decisions)


def _covered(prof, parent, children):
    """Each child span lies inside one parent span; returns the children's
    total over the parents' (ns)."""
    par = prof.spans(parent)
    kids = [prof.spans(c) for c in children]
    for k in kids:
        j = np.searchsorted(par.start, k.start, side="right") - 1
        assert (j >= 0).all()
        assert (k.end <= par.end[j]).all()
    return sum(int((k.end - k.start).sum()) for k in kids) / \
        int((par.end - par.start).sum())


@pytest.mark.parametrize("case", ["two_level_ro", "moe_wb"])
def test_engine_spans_partition_their_parents(case):
    eng, tiered, _, prof = _traced_engine(case)
    n_req = len(_prompts(eng.cfg.vocab_size))
    assert len(prof.spans("serve.prefill")) == n_req
    for c in ("upload", "forward", "pages", "sample"):
        assert len(prof.spans(f"serve.prefill.{c}")) == n_req
    steps = eng.decoding_steps
    for c in ("pages", "upload", "forward", "writeback", "sample", "finish"):
        assert len(prof.spans(f"serve.decode.{c}")) == steps
    assert len(prof.spans("serve.decode.attention")) == \
        steps * eng.cfg.n_layers
    assert prof.counters["serve.decode.self_fold"] == \
        steps * eng.cfg.n_layers
    assert len(prof.spans("serve.decode.head")) == steps
    # children partition their parents: the gaps are the spans' own cost
    assert _covered(prof, "serve.prefill", [
        f"serve.prefill.{c}" for c in ("upload", "forward", "pages",
                                       "sample")]) > 0.95
    assert _covered(prof, "serve.decode", [
        f"serve.decode.{c}" for c in ("pages", "upload", "forward",
                                      "writeback", "sample",
                                      "finish")]) > 0.95
    assert _covered(prof, "serve.decode.forward", [
        "serve.decode.attention", "serve.decode.head"]) < 1
    assert _covered(prof, "cache.rebalance", [
        f"cache.rebalance.{c}" for c in ("flush", "analyze",
                                         "enforce")]) > 0.95
    m = prof.spans("serve.decode.attention")
    np.testing.assert_allclose(m.device_ms, m.ms)   # the CPU's device time


def test_request_stamps_are_ordered():
    eng, *_ = _traced_engine("two_level_ro")
    assert len(eng.completed) == len(_prompts(eng.cfg.vocab_size))
    for r in eng.completed:
        assert 0 < r.submit_ns <= r.scheduled_ns <= r.first_token_ns \
            <= r.done_ns
    waits = [r.scheduled_ns - r.submit_ns for r in eng.completed]
    assert waits == sorted(waits)           # served in submission order


def test_window_log_deltas_sum_to_tier_stats():
    eng, tiered, mgr, prof = _traced_engine("two_level_ro")
    rows = list(prof.window_log)
    assert len(rows) >= 2
    assert [r["window"] for r in rows] == list(range(1, len(rows) + 1))
    # flush the tail of the events as a window of its own, on a copy of
    # the totals: the engine's run is shared with other tests
    totals = tiered._window_totals()
    logged = {k: sum(r[k] for r in rows) for k in totals}
    pending = {k: totals[k] - tiered._window_marks[k] for k in totals}
    for k in ("hbm_hits", "misses", "hbm_writes", "bypassed_writes"):
        assert logged[k] + pending[k] == sum(getattr(s, k)
                                             for s in tiered.stats), k
    assert logged["bypassed_writes"] > 0            # the RO tenant's
    assert logged["evict_quota"] + pending["evict_quota"] == \
        prof.counters.get("cache.evict.quota", 0)
    assert logged["unmanaged"] + pending["unmanaged"] == \
        prof.counters["serve.pages.unmanaged"] > 0
    # a read is served from exactly one of HBM, the host tier or a miss
    assert all(0 <= r["reads"] <= r["events"] for r in rows)
    assert sum(r["reads"] for r in rows) \
        + int(tiered._ev_read[:tiered._n_ev].sum()) == sum(
            s.hbm_hits + s.host_hits + s.misses for s in tiered.stats)
    assert rows[-1]["quotas"] == {i: int(q) for i, q in
                                  enumerate(mgr.history[-1].sizes)}
    assert all(r["ms"] > 0 for r in rows)


def test_rebalance_seconds_is_the_rebalance_spans():
    _, tiered, mgr, prof = _traced_engine("two_level_ro")
    s = prof.spans("cache.rebalance")
    assert len(s) == len(mgr.history)
    assert tiered.rebalance_seconds == pytest.approx(
        float((s.end - s.start).sum()) * 1e-9, rel=1e-12)
    assert tiered.rebalance_seconds == pytest.approx(
        sum(r["ms"] for r in prof.window_log) * 1e-3, rel=1e-12)


def test_first_token_is_the_padded_last_positions():
    """The reference takes a request's first token at the last position
    of the page-padded prompt (its ``engine.py:121-122``, ``:84``), not at
    the prompt's own last token; the port keeps that."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype="float32")
    params = M.params_from_jax(_reference_engine("wb")[0], "cpu")
    prompt = _prompts(cfg.vocab_size)[1][1]              # 29 tokens
    padded = torch.as_tensor(np.pad(prompt, (0, 3))[None, :],
                             dtype=torch.int64)
    pool = BlockPool(8, 8, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.float32, device="cpu")
    tiered = TieredKVCache(pool, ECICacheManager(8, ["a"], c_min=2,
                                                 device="cpu"))
    eng = MultiTenantEngine(cfg, params, tiered, page_size=8,
                            max_pages_per_seq=8)
    eng.submit(Request(tenant=0, prompt=prompt, max_new_tokens=2))
    eng.run(4)
    logits, ks, vs = prefill_with_kv(params, cfg, padded)
    want = int(logits[0, :cfg.vocab_size].argmax())
    assert eng.completed[0].generated[0] == want
    assert torch.equal(logits, M.prefill(params, cfg, padded))
    assert ks.shape == (cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim)
    assert vs.shape == ks.shape


# ------------------------------------------- slice 6's two public names
@pytest.mark.parametrize("name", ["prxy_0", "hm_1", "web_1"])
def test_stack_distances_and_wb_writes_match_reference(name):
    t = msr_trace(name, 4096, seed=5)
    ref = RefTrace(t.addrs.numpy(), t.is_read.numpy(), name)
    np.testing.assert_array_equal(stack_distances(t).numpy(),
                                  ref_core.stack_distances(ref,
                                                           backend="host"))
    assert total_cache_writes_wb(t) == ref_core.total_cache_writes_wb(ref)
    assert total_cache_writes_wb(Trace(t.addrs[:0], t.is_read[:0])) == 0


# ------------------------------------- tier failures; the MoE engine
def test_tier_failures_and_moe_raise_naming_their_item():
    """(The name is the test's from when MoE serving was refused.) Tier
    failures (item 3b): the pool crash drops its pages, the
    manager notes the loss, and the recovery brings the tier back
    (tests/test_torch_faults.py holds them to the reference).  The MoE
    family (item 2) builds an engine and serves: every request completes
    with tokens of the vocabulary, its pages written to the pool."""
    pool, mgr, tiered = _tiered()
    for k in range(4):
        tiered.access_page(0, ("t0", k), fresh=True)
    assert tiered.fail_tier(1) == {"dropped": 4, "dirty": 4}
    s = tiered.summary()
    assert s["tiers_down"] == [1] and s["tier_failures"] == 1
    assert s["dirty_loss"] == 4 and mgr.tier_is_down(1)
    tiered.recover_tier(1)
    assert tiered.summary()["tiers_down"] == [] and not mgr.tier_is_down(1)
    moe = configs.get_smoke_config("qwen2_moe_a2_7b")
    params = M.init_params(moe, seed=0, device="cpu")
    pool = BlockPool(64, 8, moe.n_layers, moe.n_kv_heads, moe.head_dim,
                     dtype=torch.float32, device="cpu")
    tiered = TieredKVCache(pool, ECICacheManager(32, ["a", "b"], c_min=4,
                                                 device="cpu"))
    eng = MultiTenantEngine(moe, params, tiered, page_size=8,
                            max_pages_per_seq=8)
    rng = np.random.default_rng(3)
    for t in (0, 1, 0):
        eng.submit(Request(tenant=t, prompt=rng.integers(
            0, moe.vocab_size, 20).astype(np.int32), max_new_tokens=3))
    eng.run(8)
    assert len(eng.completed) == 3 and not eng.active
    assert all(len(r.generated) == 3 and all(0 <= x < moe.vocab_size
                                             for x in r.generated)
               for r in eng.completed)
    assert pool.stats["writes"] > 0 and bool(pool.k_pages.abs().sum() > 0)
    mla = configs.get_smoke_config("minicpm3_4b")
    with pytest.raises(ValueError, match="MLA"):
        MultiTenantEngine(mla, {"embed": torch.zeros(1)}, tiered)


def test_launch_serve_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--requests", "4",
                       "--max-new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 4/4 requests, 12 tokens")
    assert out[0].endswith("on cpu") and out[1].startswith("pool: {")
    assert out[2].startswith("profile: {")
    for key in ("'span_ms'", "'serve.prefill.pages'", "'serve.decode'",
                "'counters'", "'windows'", "'queue_wait_ms'"):
        assert key in out[2], key
