"""Per-tenant replay results, the LRU partition state, and the per-access
interpreter.

Port of ``repro.core.simulator``: ``SimResult`` (the per-tenant counts
and latency of one replayed window, per level), ``LRUCache`` (one
tenant's partition of a cache level), ``rebalance_levels`` and
``simulate``, the per-access oracle of the batch engine
(``repro_torch.core.batch_sim``), for one level or the exclusive
two-level hierarchy.  ``simulate`` walks the trace on the host over
Python containers, one read of the cache state and the trace before and
one write of the final state after, on the cache's device.

Latency model (paper §5.1): read hit -> t_fast; read miss -> t_slow;
writes under WB -> t_fast; writes that bypass the fast tier (RO/WT) ->
t_write_bypass; each dirty eviction charges ``flush_cost``.

Two-level hierarchy (ETICA): an L1 hit touches (global MRU); an L1 miss
that hits L2 promotes the block into L1 (one L1 cache write) and is
served at ``t_fast2``; a full miss installs into L1.  Every install into
a full L1 demotes the L1 victim into L2's MRU (one L2 cache write);
eviction from L2 is final.  So the union of both levels is one LRU stack
of ``C1 + C2`` blocks whose top ``C1`` are L1 — the property the batch
engine counts with.  ``policy2 != WB`` keeps L2 clean: dirty victims
flush at demotion, and dirty L2 content flushes up front.  At replay
start ``rebalance_levels`` restores "L1 full or L2 empty".  ``C1 == 0``
makes L2 the single level; ``C2 == 0`` is the single-level scheme.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from repro_torch.core.trace import Trace
from repro_torch.core.write_policy import WritePolicy

__all__ = ["SimResult", "LRUCache", "rebalance_levels", "simulate"]


@dataclasses.dataclass
class SimResult:
    reads: int = 0
    read_hits: int = 0             # reads served from L1 (the fast tier)
    writes: int = 0
    write_hits: int = 0            # writes that touched an L1-resident block
    cache_writes: int = 0          # L1 installs + in-place modifies (endurance)
    total_latency: float = 0.0
    capacity: int = 0
    policy: str = "wb"
    # ---- level-2 accounting (all zero for a single-level hierarchy) ----
    read_hits_l2: int = 0          # reads served from L2 (promotions)
    write_hits_l2: int = 0         # writes that touched an L2-resident block
    cache_writes_l2: int = 0       # demotions into L2 (+ direct L2 installs)
    capacity2: int = 0
    policy2: str = "wb"
    # 1 when the batch engine replayed this tenant-window through the
    # per-access interpreter (degenerate two-level windows only)
    fallback: int = 0

    @property
    def n(self) -> int:
        return self.reads + self.writes

    @property
    def read_hit_ratio(self) -> float:
        return self.read_hits / self.reads if self.reads else 0.0

    @property
    def hit_ratio(self) -> float:
        """L1 read hits over all accesses (paper's h in Eq. 2)."""
        return self.read_hits / self.n if self.n else 0.0

    @property
    def hit_ratio_l2(self) -> float:
        """L2 read hits over all accesses (second-level h in ETICA Eq. 2)."""
        return self.read_hits_l2 / self.n if self.n else 0.0

    @property
    def union_hit_ratio(self) -> float:
        """Read hits anywhere in the hierarchy over all accesses."""
        return (self.read_hits + self.read_hits_l2) / self.n if self.n else 0.0

    @property
    def mean_latency(self) -> float:
        return self.total_latency / self.n if self.n else 0.0

    @property
    def perf(self) -> float:
        """Performance = 1 / mean latency (IOPS-like)."""
        return 1.0 / self.mean_latency if self.mean_latency > 0 else 0.0

    @property
    def perf_per_cost(self) -> float:
        """Performance per allocated cache block (paper's perf-per-cost)."""
        return self.perf / self.capacity if self.capacity else 0.0


class LRUCache:
    """LRU set of block addresses with a capacity in blocks.

    The state is a pair of tensors, LRU -> MRU: ``addrs`` (int64) and
    their ``dirty`` flags (bool), on ``device``.  The batch engine reads
    it as the window's warm prefix and replaces it with the window's
    survivors; ``resize`` shrinks it by slicing the LRU end off.
    """

    def __init__(self, capacity: int, device: str | torch.device = "cpu"):
        self.capacity = int(capacity)
        self._addrs = torch.zeros(0, dtype=torch.int64, device=device)
        self._dirty = torch.zeros(0, dtype=torch.bool, device=device)

    def set_state_arrays(self, addrs: torch.Tensor,
                         dirty: torch.Tensor) -> None:
        """Replace the whole state (LRU -> MRU order)."""
        self._addrs = addrs
        self._dirty = dirty

    def state_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(addrs, dirty), LRU -> MRU."""
        return self._addrs, self._dirty

    def __len__(self) -> int:
        return int(self._addrs.shape[0])

    def resize(self, capacity: int) -> torch.Tensor:
        """Shrink/grow; returns the evicted addrs (LRU-first) on shrink."""
        self.capacity = int(capacity)
        k = len(self) - self.capacity
        if k <= 0:
            return self._addrs[:0]
        out = self._addrs[:k]
        self._addrs = self._addrs[k:]
        self._dirty = self._dirty[k:]
        return out


def rebalance_levels(c1: LRUCache, c2: LRUCache) -> None:
    """Restore the hierarchy invariant "L1 full or L2 empty".

    Moves L2's MRU blocks to L1's LRU end until L1 is full or L2 is
    empty.  The union recency order is unchanged, so this only relabels
    which level holds each block; both replay engines call it at window
    start.
    """
    need = c1.capacity - len(c1)
    if need <= 0 or len(c2) == 0:
        return
    a1, f1 = c1.state_arrays()
    a2, f2 = c2.state_arrays()
    k = min(need, int(a2.shape[0]))
    c1.set_state_arrays(torch.cat([a2[-k:], a1]), torch.cat([f2[-k:], f1]))
    c2.set_state_arrays(a2[:-k], f2[:-k])


class _HostLRU:
    """The interpreter's view of one level: an ``OrderedDict`` addr ->
    dirty (LRU -> MRU) with the reference ``LRUCache``'s operations."""

    def __init__(self, cache: LRUCache):
        a, d = cache.state_arrays()
        self.capacity = cache.capacity
        self.od: OrderedDict[int, bool] = OrderedDict(zip(a.tolist(),
                                                          d.tolist()))

    def store(self, cache: LRUCache) -> None:
        """Write the state back into ``cache`` on its own device."""
        dev = cache.state_arrays()[0].device
        cache.set_state_arrays(
            torch.tensor(list(self.od.keys()), dtype=torch.int64,
                         device=dev),
            torch.tensor(list(self.od.values()), dtype=torch.bool,
                         device=dev))

    def __contains__(self, addr: int) -> bool:
        return addr in self.od

    def touch(self, addr: int) -> None:
        self.od.move_to_end(addr)

    def insert(self, addr: int, dirty: bool) -> int | None:
        """Insert/refresh; returns an evicted addr if one was displaced."""
        if addr in self.od:
            self.od.move_to_end(addr)
            self.od[addr] = self.od[addr] or dirty
            return None
        if self.capacity <= 0:
            return None
        evicted = None
        if len(self.od) >= self.capacity:
            evicted, _ = self.od.popitem(last=False)
        self.od[addr] = dirty
        return evicted

    def mark(self, addr: int, dirty: bool) -> None:
        """Touch + set the dirty flag (a WB write, or a write-through)."""
        if addr in self.od:
            self.od[addr] = dirty
            self.od.move_to_end(addr)

    def invalidate(self, addr: int) -> None:
        self.od.pop(addr, None)


def _simulate_two_level(trace: Trace, c1: _HostLRU, c2: _HostLRU,
                        policy: WritePolicy, policy2: WritePolicy,
                        t_fast: float, t_fast2: float, t_slow: float,
                        t_write_bypass: float, flush_cost: float
                        ) -> SimResult:
    """Per-access interpreter for the exclusive two-level hierarchy
    (caller rebalanced the levels)."""
    cap1, cap2 = c1.capacity, c2.capacity
    r = SimResult(capacity=cap1, policy=policy.value,
                  capacity2=cap2, policy2=policy2.value)
    clean2 = policy2 is not WritePolicy.WB and cap2 > 0 and cap1 > 0
    # dirty shadows mirror each level's own flags (survive eviction return)
    d1: dict[int, bool] = dict(c1.od)
    d2: dict[int, bool] = dict(c2.od)
    if clean2:
        # a clean L2 policy taking effect flushes any dirty L2 content
        for a, fl in c2.od.items():
            if fl:
                c2.od[a] = False
                d2[a] = False
                if flush_cost > 0.0:
                    r.total_latency += flush_cost

    def final_evict(addr: int, dirty: bool) -> None:
        if dirty and flush_cost > 0.0:
            r.total_latency += flush_cost

    def demote(addr: int, dirty: bool) -> None:
        """L1 victim displaced: push into L2's MRU (or evict for good)."""
        if cap2 <= 0:
            final_evict(addr, dirty)
            return
        if clean2 and dirty:
            if flush_cost > 0.0:
                r.total_latency += flush_cost
            dirty = False
        ev = c2.insert(addr, dirty)
        d2[addr] = dirty
        r.cache_writes_l2 += 1
        if ev is not None:
            final_evict(ev, d2.pop(ev, False))

    def install_l1(addr: int, dirty: bool) -> None:
        """Insert at the hierarchy's global MRU (caller ensured cap1 > 0)."""
        ev = c1.insert(addr, dirty)
        d1[addr] = dirty
        r.cache_writes += 1
        if ev is not None:
            demote(ev, d1.pop(ev, False))

    def install_top(addr: int, dirty: bool) -> None:
        if cap1 > 0:
            install_l1(addr, dirty)
        else:                                    # degenerate: L2 is the level
            ev = c2.insert(addr, dirty)
            d2[addr] = dirty
            r.cache_writes_l2 += 1
            if ev is not None:
                final_evict(ev, d2.pop(ev, False))

    captot = cap1 + cap2
    for a, rd in zip(trace.addrs.tolist(), trace.is_read.tolist()):
        if rd:
            r.reads += 1
            if a in c1:
                r.read_hits += 1
                c1.touch(a)
                r.total_latency += t_fast
            elif a in c2:
                r.read_hits_l2 += 1
                r.total_latency += t_fast2
                if cap1 > 0:                     # promote on L2 hit
                    fl = d2.pop(a, False)
                    c2.invalidate(a)
                    install_l1(a, fl)
                else:                            # L2 is the only level
                    c2.touch(a)
            else:
                r.total_latency += t_slow
                if captot > 0:
                    install_top(a, False)
        else:
            r.writes += 1
            if policy is WritePolicy.WB:
                if a in c1:
                    r.write_hits += 1
                    c1.mark(a, True)
                    d1[a] = True
                    r.cache_writes += 1          # in-place modify
                    r.total_latency += t_fast
                elif a in c2:
                    r.write_hits_l2 += 1
                    if cap1 > 0:
                        d2.pop(a, None)
                        c2.invalidate(a)
                        install_l1(a, True)      # promote, dirtied by the write
                        r.total_latency += t_fast
                    else:
                        c2.mark(a, True)
                        d2[a] = True
                        r.cache_writes_l2 += 1
                        r.total_latency += t_fast2
                elif captot > 0:
                    install_top(a, True)
                    r.total_latency += (t_fast if cap1 > 0 else t_fast2)
                else:
                    r.total_latency += t_write_bypass
            elif policy is WritePolicy.WT:
                if a in c1:
                    r.write_hits += 1
                    c1.mark(a, False)            # propagated synchronously
                    d1[a] = False
                    r.cache_writes += 1
                elif a in c2:
                    r.write_hits_l2 += 1
                    if cap1 > 0:
                        d2.pop(a, None)
                        c2.invalidate(a)
                        install_l1(a, False)     # promote clean
                    else:
                        c2.mark(a, False)
                        d2[a] = False
                        r.cache_writes_l2 += 1
                elif captot > 0:
                    install_top(a, False)
                r.total_latency += t_write_bypass
            else:  # RO: write-around invalidates every cached copy
                if a in c1:
                    r.write_hits += 1
                    c1.invalidate(a)
                    d1.pop(a, None)
                elif a in c2:
                    r.write_hits_l2 += 1
                    c2.invalidate(a)
                    d2.pop(a, None)
                r.total_latency += t_write_bypass
    return r


def _simulate_one_level(trace: Trace, c: _HostLRU, policy: WritePolicy,
                        t_fast: float, t_slow: float, t_write_bypass: float,
                        flush_cost: float) -> SimResult:
    """Per-access interpreter for one LRU partition."""
    cap = c.capacity
    r = SimResult(capacity=cap, policy=policy.value)

    def charge_flush(evicted: int | None) -> None:
        # always pop: c_dirty must mirror residency
        if evicted is not None and c_dirty.pop(evicted, False) \
                and flush_cost > 0.0:
            r.total_latency += flush_cost

    # dirty tracking mirrors the LRU's own flags but survives eviction return
    c_dirty: dict[int, bool] = dict(c.od)
    for a, rd in zip(trace.addrs.tolist(), trace.is_read.tolist()):
        if rd:
            r.reads += 1
            if a in c:
                r.read_hits += 1
                c.touch(a)
                r.total_latency += t_fast
            else:
                r.total_latency += t_slow
                if cap > 0:                    # allocate-on-read-miss install
                    charge_flush(c.insert(a, dirty=False))
                    c_dirty[a] = False
                    r.cache_writes += 1
        else:
            r.writes += 1
            if policy is WritePolicy.WB:
                if a in c:
                    r.write_hits += 1
                    c.mark(a, True)
                    c_dirty[a] = True
                    r.cache_writes += 1        # in-place modify
                    r.total_latency += t_fast
                elif cap > 0:
                    charge_flush(c.insert(a, dirty=True))   # allocate-on-write
                    c_dirty[a] = True
                    r.cache_writes += 1
                    r.total_latency += t_fast
                else:
                    r.total_latency += t_write_bypass
            elif policy is WritePolicy.WT:
                if a in c:
                    r.write_hits += 1
                    # write-through: the cached copy is current -> clean
                    c.mark(a, False)
                    c_dirty[a] = False
                    r.cache_writes += 1
                elif cap > 0:
                    charge_flush(c.insert(a, dirty=False))
                    c_dirty[a] = False
                    r.cache_writes += 1
                r.total_latency += t_write_bypass  # propagate synchronously
            else:  # RO: write-around — invalidate any stale cached copy
                if a in c:
                    r.write_hits += 1
                    c.invalidate(a)            # no SSD write
                    c_dirty.pop(a, None)       # drop its dirty flag too
                r.total_latency += t_write_bypass
    return r


def simulate(trace: Trace, capacity: int,
             policy: WritePolicy = WritePolicy.WB,
             t_fast: float = 1.0, t_slow: float = 20.0,
             t_write_bypass: float | None = None,
             flush_cost: float = 0.0,
             cache: LRUCache | None = None, *,
             capacity2: int = 0,
             policy2: WritePolicy = WritePolicy.WB,
             t_fast2: float | None = None,
             cache2: LRUCache | None = None) -> SimResult:
    """Replay ``trace`` against an LRU partition of ``capacity`` blocks.

    When ``cache`` is given its capacity wins and it is left in its final
    state.  With ``capacity2 > 0`` (or a non-empty ``cache2``) the
    partition is the exclusive two-level hierarchy (module docstring).
    A new cache lies on the trace's device.
    """
    if t_write_bypass is None:
        t_write_bypass = 1.2 * t_fast
    dev = trace.addrs.device
    if cache2 is not None or capacity2 > 0:
        c2 = cache2 if cache2 is not None else LRUCache(capacity2, dev)
        if c2.capacity > 0 or len(c2) > 0:
            if t_fast2 is None:
                t_fast2 = 3.0 * t_fast
            c1 = cache if cache is not None else LRUCache(capacity, dev)
            rebalance_levels(c1, c2)
            h1, h2 = _HostLRU(c1), _HostLRU(c2)
            r = _simulate_two_level(trace, h1, h2, policy, policy2, t_fast,
                                    t_fast2, t_slow, t_write_bypass,
                                    flush_cost)
            h1.store(c1)
            h2.store(c2)
            return r
    c = cache if cache is not None else LRUCache(capacity, dev)
    h = _HostLRU(c)
    r = _simulate_one_level(trace, h, policy, t_fast, t_slow,
                            t_write_bypass, flush_cost)
    h.store(c)
    return r
