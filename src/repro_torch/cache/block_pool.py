"""Paged KV block pool: the serving path's "SSD cache" device substrate.

The port of the reference's ``src/repro/cache/block_pool.py``.  The pool
is a set of fixed-size pages in two device tensors, ``k_pages`` and
``v_pages`` of ``[n_layers, n_pages, page_size, kv_heads, head_dim]``, on
the pool's ``device`` (the CUDA card unless the caller asks for the
CPU).  Page *contents* are only touched by tensor ops: ``write_page``
writes a page in place (``k_pages[:, pid] = ...``, where the reference
rebuilds the array with ``.at[].set``), and the decode attention gathers
pages through block tables.  Page *metadata* (the free list, per-tenant
LRU order, content keys for prefix reuse, pins, stats) is host-side, as
in vLLM's block manager, and behaves as the reference's, in the same
order.

Every metadata operation is a block access (read = page reuse, write =
page admission) that the ECI-Cache monitor consumes through
``TieredKVCache``: the pool is the cache the paper's algorithms manage.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from repro_torch.device import resolve_device

__all__ = ["PageMeta", "BlockPool"]


@dataclasses.dataclass
class PageMeta:
    tenant: int = -1
    key: tuple | None = None      # content key (tenant, prefix-page hash)
    dirty: bool = False
    pinned: bool = False          # in-flight pages are never evicted


class BlockPool:
    """Host-side manager of a device-resident paged pool.

    Device tensors (every layer stacked): ``k_pages``/``v_pages``.  The
    manager hands out page ids; per-tenant LRU and quota enforcement
    implement the Actuator's partition decisions.  ``allocate_device=
    False`` keeps the metadata only (no tensors, no device needed).
    """

    def __init__(self, n_pages: int, page_size: int, n_layers: int,
                 kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 allocate_device: bool = True,
                 device: str | torch.device | None = None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.shape = (n_layers, n_pages, page_size, kv_heads, head_dim)
        if allocate_device:
            dev = resolve_device(device)
            self.k_pages = torch.zeros(self.shape, dtype=dtype, device=dev)
            self.v_pages = torch.zeros(self.shape, dtype=dtype, device=dev)
        else:                       # metadata-only mode (tests/benchmarks)
            self.k_pages = self.v_pages = None
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.meta: dict[int, PageMeta] = {}
        # per-tenant LRU of resident pages: tenant -> OrderedDict[page_id]
        self.lru: dict[int, OrderedDict[int, None]] = {}
        self.by_key: dict[tuple, int] = {}
        self.stats = {"admitted": 0, "evicted": 0, "reused": 0,
                      "writes": 0}
        # demote-on-evict hook: called as on_evict(pid, meta) after a page
        # leaves the pool (TieredKVCache pushes the victim into the managed
        # host tier, the L2 of the serving hierarchy)
        self.on_evict = None

    # ------------------------------------------------------------ metadata
    def resident(self, tenant: int) -> int:
        return len(self.lru.get(tenant, ()))

    def lookup(self, key: tuple) -> int | None:
        """Prefix-cache hit test; bumps LRU on hit."""
        pid = self.by_key.get(key)
        if pid is not None:
            m = self.meta[pid]
            self.lru[m.tenant].move_to_end(pid)
            self.stats["reused"] += 1
        return pid

    def allocate(self, tenant: int, key: tuple | None = None,
                 quota: int | None = None,
                 dirty: bool = False) -> tuple[int | None, list[int]]:
        """Allocate one page for ``tenant``; evicts LRU pages of the same
        tenant while over quota.  Returns (page_id | None, evicted_ids)."""
        evicted: list[int] = []
        q = self.lru.setdefault(tenant, OrderedDict())
        if quota is not None and quota <= 0:
            return None, evicted
        while quota is not None and len(q) >= quota:
            v = self._evict_one(tenant)
            if v is None:
                return None, evicted        # all resident pages pinned
            evicted.append(v)
        if not self.free:
            victim = self._evict_any(tenant)
            if victim is None:
                return None, evicted
            evicted.append(victim)
        pid = self.free.pop()
        self.meta[pid] = PageMeta(tenant, key, dirty)
        q[pid] = None
        if key is not None:
            self.by_key[key] = pid
        self.stats["admitted"] += 1
        self.stats["writes"] += 1
        return pid, evicted

    def _evict_one(self, tenant: int) -> int | None:
        q = self.lru[tenant]
        for pid in q:                       # LRU-first, skipping pinned
            if not self.meta[pid].pinned:
                break
        else:
            return None                     # everything in flight
        q.pop(pid)
        m = self.meta.pop(pid)
        if m.key is not None:
            self.by_key.pop(m.key, None)
        self.free.append(pid)
        self.stats["evicted"] += 1
        if self.on_evict is not None:
            self.on_evict(pid, m)
        return pid

    def pin(self, pid: int) -> None:
        if pid in self.meta:
            self.meta[pid].pinned = True

    def unpin(self, pid: int) -> None:
        if pid in self.meta:
            self.meta[pid].pinned = False

    def _evict_any(self, prefer_tenant: int) -> int | None:
        if self.lru.get(prefer_tenant):
            return self._evict_one(prefer_tenant)
        for t, q in self.lru.items():
            if q:
                v = self._evict_one(t)
                if v is not None:
                    return v
        return None

    def release_tenant(self, tenant: int) -> int:
        """Free all pages of a finished tenant (paper §6.3 retire)."""
        n = 0
        for pid in list(self.lru.get(tenant, ())):
            self.meta[pid].pinned = False
        while self.lru.get(tenant):
            if self._evict_one(tenant) is None:
                break
            n += 1
        return n

    def enforce_quota(self, tenant: int, quota: int) -> list[int]:
        """Actuator resize: shrink a tenant's residency to ``quota``."""
        out = []
        q = self.lru.setdefault(tenant, OrderedDict())
        while len(q) > quota:
            v = self._evict_one(tenant)
            if v is None:
                break
            out.append(v)
        return out

    # -------------------------------------------------------- device data
    def write_page(self, layer_slice_k: torch.Tensor,
                   layer_slice_v: torch.Tensor, pid: int) -> None:
        """Write one page of fresh KV into the pool, every layer, in place.

        layer_slice_*: [n_layers, page_size, kv_heads, head_dim].
        """
        if self.k_pages is None:
            return
        self.k_pages[:, pid] = layer_slice_k
        self.v_pages[:, pid] = layer_slice_v
