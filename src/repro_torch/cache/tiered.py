"""Three-tier paged KV cache (HBM pool -> managed host tier -> recompute)
driven by the ECI/ETICA cache manager.

The port of the reference's ``src/repro/cache/tiered.py``.  Level mapping:

    serving tier            trace-replay level      paper device
    -------------------     -------------------     -------------------
    HBM page pool           L1  (``capacity``)      DRAM cache  (ETICA L1)
    managed host tier       L2  (``capacity2``)     SSD cache   (ETICA L2)
    cold recompute          backing store           disk subsystem

A *read* is a prefix-page reuse (decode/prefill hitting a cached page); a
*write* is the admission of a freshly computed page.  Per-tenant write
policy (L1):

  WB: every fresh page is admitted to HBM immediately (classic prefix
      caching: best reuse latency, maximal pool write traffic);
  RO: fresh pages go to the host tier only; a page is *promoted* to HBM
      the first time it is re-read (write-around: pages that are never
      re-read never cost HBM writes or capacity).

With ``manager.capacity2 > 0`` the host tier is *managed*: each tenant owns
a host-page quota (the Analyzer's ``sizes2``), pages evicted from the HBM
pool are **demoted** into the host tier's MRU (``BlockPool.on_evict``), a
host hit promotes the page back into HBM, and pages falling off the host
tier are gone: the next access is a cold recompute.  With
``capacity2 == 0`` the host tier is unmanaged (it retains every page ever
computed).

Every event is recorded into preallocated numpy arrays (the batched
Monitor, host metadata like the pool's); at window boundaries
``rebalance()`` flushes them to the port's ``ECICacheManager`` (which
runs on its own device), re-runs Alg. 1/3 per level, and applies both
quota vectors and both policy vectors through the pool's quota
enforcement and the host tier's LRU trim: the Actuator.
``rebalance_seconds`` accumulates the wall time spent in that path.

Tier failures (``fail_tier``/``recover_tier``) need the manager's
degradation ladder and raise ``NotImplementedError`` naming ROADMAP §1
item 3; until then no tier is ever down, and ``summary()`` reports the
failure counters as 0 (the keys the reference reports).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np

from repro_torch.cache.block_pool import BlockPool, PageMeta
from repro_torch.core.manager import ECICacheManager
from repro_torch.core.write_policy import WritePolicy

__all__ = ["TieredKVCache", "TierStats"]


@dataclasses.dataclass
class TierStats:
    hbm_hits: int = 0
    host_hits: int = 0
    misses: int = 0                 # page had to be (re)computed
    hbm_writes: int = 0             # endurance metric (paper Eq. 3)
    promotions: int = 0
    bypassed_writes: int = 0
    demotions: int = 0              # HBM victims pushed into the host tier
    host_evictions: int = 0         # pages that fell off the managed host
    rerouted_writes: int = 0        # WB admissions sent to host: L1 down
                                    # (never, until fail_tier is ported)

    @property
    def accesses(self) -> int:
        return self.hbm_hits + self.host_hits + self.misses

    @property
    def hit_ratio(self) -> float:
        return self.hbm_hits / self.accesses if self.accesses else 0.0


class TieredKVCache:
    """Prefix-page cache across tenants with ECI-managed partitioning."""

    def __init__(self, pool: BlockPool, manager: ECICacheManager,
                 window_events: int = 4096):
        self.pool = pool
        self.manager = manager
        self.host: dict[tuple, int] = {}       # key -> host "address"
        self._next_host = 0
        n_tenants = len(manager.tenants)
        self.quotas = {i: None for i in range(n_tenants)}
        self.policies = {i: t.policy for i, t in enumerate(manager.tenants)}
        self.stats = [TierStats() for _ in manager.tenants]
        # managed host tier (L2): per-tenant LRU of resident keys + quota
        self.managed_host = manager.capacity2 > 0
        self.host_lru: dict[int, OrderedDict[tuple, None]] = {
            i: OrderedDict() for i in range(n_tenants)}
        self.host_quotas: dict[int, int | None] = {
            i: None for i in range(n_tenants)}
        pool.on_evict = self._demote
        # batched Monitor: page touches land in preallocated arrays (grown
        # by doubling), flushed to the manager once per window
        self.window_events = window_events
        cap = max(256, min(int(window_events), 1 << 16))
        self._ev_tenant = np.empty(cap, np.int32)
        self._ev_addr = np.empty(cap, np.int64)
        self._ev_read = np.empty(cap, bool)
        self._n_ev = 0
        self.rebalance_seconds = 0.0           # Actuator-path wall time

    # ----------------------------------------------------------- app API
    def _addr(self, key: tuple) -> int:
        """Stable integer address per content key (for the Monitor)."""
        a = self.host.get(key)
        if a is None:
            a = self._next_host
            self._next_host += 1
            self.host[key] = a
        return a

    def _record_event(self, tenant: int, addr: int, read: bool) -> None:
        i = self._n_ev
        if i >= self._ev_addr.size:            # amortized doubling
            self._ev_tenant = np.concatenate(
                [self._ev_tenant, np.empty_like(self._ev_tenant)])
            self._ev_addr = np.concatenate(
                [self._ev_addr, np.empty_like(self._ev_addr)])
            self._ev_read = np.concatenate(
                [self._ev_read, np.empty_like(self._ev_read)])
        self._ev_tenant[i] = tenant
        self._ev_addr[i] = addr
        self._ev_read[i] = read
        self._n_ev = i + 1

    def access_page(self, tenant: int, key: tuple,
                    fresh: bool = False) -> str:
        """One page touch.  fresh=True: a newly computed page (a *write*);
        fresh=False: the engine wants to reuse it (a *read*).

        Returns where it was served from: "hbm" | "host" | "miss".
        """
        st = self.stats[tenant]
        self._record_event(tenant, self._addr(key), not fresh)
        served = "miss"

        if fresh:
            if self.policies[tenant] is WritePolicy.WB:
                pid, _ = self.pool.allocate(tenant, key,
                                            quota=self.quotas[tenant],
                                            dirty=True)
                if pid is not None:
                    st.hbm_writes += 1
                    served = "hbm"
            else:                               # RO: write-around
                st.bypassed_writes += 1
                self._host_insert(tenant, key)
                served = "host"
        else:
            pid = self.pool.lookup(key)
            if pid is not None:
                st.hbm_hits += 1
                served = "hbm"
            elif key in self.host and self._host_materialized(tenant, key):
                st.host_hits += 1
                served = "host"
                # promote on proven reuse (the hierarchy's L2-hit rule)
                if self.managed_host:
                    self.host_lru[tenant].pop(key, None)
                pid, _ = self.pool.allocate(tenant, key,
                                            quota=self.quotas[tenant],
                                            dirty=False)
                if pid is not None:
                    st.hbm_writes += 1
                    st.promotions += 1
                elif self.managed_host:
                    # promotion refused (quota 0): keep it in host tier
                    self._host_insert(tenant, key)
            else:
                st.misses += 1
        if self._n_ev >= self.window_events:
            self.rebalance()
        return served

    # ------------------------------------------------- managed host tier
    def _host_insert(self, tenant: int, key: tuple) -> None:
        """Admit/refresh a key at the host tier's MRU, enforcing its quota."""
        if not self.managed_host or tenant < 0:
            return
        q = self.host_lru[tenant]
        q[key] = None
        q.move_to_end(key)
        quota = self.host_quotas[tenant]
        if quota is not None:
            while len(q) > max(quota, 0):
                q.popitem(last=False)          # page is gone: next touch
                self.stats[tenant].host_evictions += 1   # recomputes

    def _demote(self, pid: int, meta: PageMeta) -> None:
        """``BlockPool.on_evict``: HBM victim enters the host tier's MRU."""
        if meta.key is None or meta.tenant < 0 or not self.managed_host:
            return
        self.stats[meta.tenant].demotions += 1
        self._host_insert(meta.tenant, meta.key)

    def _host_materialized(self, tenant: int, key: tuple) -> bool:
        if not self.managed_host:
            # legacy: host tier retains every page ever computed
            return True
        return key in self.host_lru.get(tenant, ())

    # ------------------------------------------------------ tier failures
    def fail_tier(self, level: int = 1) -> dict:
        """Crash one tier (the reference's ``tiered.py:224``): not ported."""
        raise _ladder_not_ported("fail_tier")

    def recover_tier(self, level: int = 1) -> None:
        """Bring a failed tier back (the reference's ``tiered.py:261``):
        not ported."""
        raise _ladder_not_ported("recover_tier")

    def add_tenant(self, name: str = "") -> int:
        """Tenant churn on the serving path: a workload joins mid-run.

        Extends every per-tenant structure and registers the tenant with
        the manager (whose next analyze records the ``"join"`` event and
        sizes the newcomer).  Existing tenants' quotas, host tiers and
        monitor state are untouched.
        """
        i = self.manager.add_tenant(name)
        self.quotas[i] = None
        self.policies[i] = self.manager.tenants[i].policy
        self.stats.append(TierStats())
        self.host_lru[i] = OrderedDict()
        self.host_quotas[i] = None
        return i

    def finish_tenant(self, tenant: int) -> None:
        hook = self.pool.on_evict
        self.pool.on_evict = None      # retiring pages are not demotions
        try:
            self.pool.release_tenant(tenant)
        finally:
            self.pool.on_evict = hook
        self.host_lru[tenant] = OrderedDict()
        self.host_quotas[tenant] = 0
        self.quotas[tenant] = 0
        self.manager.retire_tenant(tenant)

    # ------------------------------------------------- Analyzer/Actuator
    def rebalance(self) -> None:
        """Flush the event window into the Monitor, re-run Alg. 1 + Alg. 3
        (per level), apply quota + policy vectors (Actuator)."""
        n = self._n_ev
        if n == 0:
            return
        t0 = time.perf_counter()
        ten = self._ev_tenant[:n]
        ad = self._ev_addr[:n]
        rd = self._ev_read[:n]
        self._n_ev = 0
        for t in range(len(self.manager.tenants)):
            mask = ten == t
            if mask.any():
                self.manager.record(t, ad[mask].copy(), rd[mask].copy())
        joins = self.manager._drain_joined(self.manager.windows_run)
        if joins:
            self.manager._record_events(joins)
        decision = self.manager.analyze(trigger=tuple(joins))
        sizes = decision.sizes.tolist()
        sizes2 = (decision.sizes2.tolist()
                  if decision.sizes2 is not None else None)
        for i, tstate in enumerate(self.manager.tenants):
            if not tstate.active:
                continue
            self.quotas[i] = int(sizes[i])
            self.policies[i] = tstate.policy
            self.pool.enforce_quota(i, self.quotas[i])
            if self.managed_host and sizes2 is not None:
                self.host_quotas[i] = int(sizes2[i])
                q = self.host_lru[i]
                while len(q) > self.host_quotas[i]:
                    q.popitem(last=False)
                    self.stats[i].host_evictions += 1
            tstate.clear_window()
        self.rebalance_seconds += time.perf_counter() - t0

    # ------------------------------------------------------------ report
    def summary(self) -> dict:
        tot = TierStats()
        for s in self.stats:
            tot.hbm_hits += s.hbm_hits; tot.host_hits += s.host_hits
            tot.misses += s.misses; tot.hbm_writes += s.hbm_writes
            tot.promotions += s.promotions
            tot.bypassed_writes += s.bypassed_writes
            tot.demotions += s.demotions
            tot.host_evictions += s.host_evictions
        return {
            "hbm_hit_ratio": tot.hit_ratio,
            "hbm_writes": tot.hbm_writes,
            "bypassed_writes": tot.bypassed_writes,
            "promotions": tot.promotions,
            "demotions": tot.demotions,
            "host_evictions": tot.host_evictions,
            "host_resident": sum(len(q) for q in self.host_lru.values()),
            "resident_pages": sum(self.pool.resident(i)
                                  for i in range(len(self.stats))),
            "quotas": dict(self.quotas),
            "host_quotas": dict(self.host_quotas),
            "policies": {i: p.value for i, p in self.policies.items()},
            "rebalance_seconds": self.rebalance_seconds,
            # no tier fails until fail_tier is ported (ROADMAP §1 item 3)
            "tier_failures": 0,
            "dropped_pages": 0,
            "dirty_loss": 0,
            "rerouted_writes": 0,
            "tiers_down": [],
        }


def _ladder_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"TieredKVCache.{what} is not ported yet: it drives the manager's "
        f"note_tier_loss / note_tier_recovery, which come with the "
        f"degradation ladder (ROADMAP §1 item 3)")
