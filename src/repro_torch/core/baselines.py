"""Comparison schemes as configurations of ``ECICacheManager``.

  * ``eci``             — the paper's scheme (URD sizing + Alg. 3
    policies).
  * ``etica``           — its two-level configuration: pass ``capacity2``
    (L2 blocks) and optionally ``t_fast2``/``w_threshold2``; each tenant
    owns an (L1, L2) hierarchy with per-level sizing and policies.
  * ``centaur``         — the paper's head-to-head baseline [Koller+,
    ICAC'15]: TRD-based MRC sizing, Eq.-2 optimization when infeasible,
    WB everywhere.
  * ``static``          — equal static partitioning, WB (EMC
    VFCache-style).
  * ``reuse_intensity`` — vCacheShare-like: partitions in proportion to
    each tenant's reuse intensity, Write-Around (= RO) everywhere.
  * ``global``          — one LRU shared by all tenants, WB (Fusion-io
    ioTurbine-style): ``GlobalLRUManager``, replayed through the
    per-access interpreter ``simulator.simulate``.

The two partitioners run on the host over N numbers each; the
proportional split keeps numpy's float64 reductions so its rounding
matches the reference's exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.manager import ECICacheManager
from repro_torch.core.mrc import BatchedHitRatioFunctions
from repro_torch.core.partitioner import PartitionResult, aggregate_latency
from repro_torch.core.simulator import LRUCache, SimResult, simulate
from repro_torch.core.trace import Trace
from repro_torch.core.write_policy import WritePolicy
from repro_torch.device import resolve_device

__all__ = ["GlobalLRUManager", "SCHEMES", "make_manager"]

SCHEMES = ("eci", "etica", "centaur", "static", "reuse_intensity", "global")


def _result(hs, sizes: np.ndarray, t_fast: float, t_slow: float,
            weights) -> PartitionResult:
    b = BatchedHitRatioFunctions.from_curves(hs)
    s = torch.as_tensor(sizes, dtype=torch.int64)
    dev_sizes = s.to(b.edges.device)
    return PartitionResult(
        s, False, aggregate_latency(b, dev_sizes, t_fast, t_slow, weights),
        b.evaluate(dev_sizes).cpu())


def _static_partition(hs, capacity: int, t_fast: float, t_slow: float,
                      c_min: int = 0, weights=None) -> PartitionResult:
    """Equal static split; the ``capacity % n`` remainder blocks go to the
    first tenants (one each), so the whole budget is allocated."""
    n = len(hs)
    share, rem = divmod(capacity, max(n, 1))
    sizes = np.full(n, share, dtype=np.int64)
    sizes[:rem] += 1
    return _result(hs, sizes, t_fast, t_slow, weights)


def _reuse_intensity_partition(hs, capacity: int, t_fast: float,
                               t_slow: float, c_min: int = 0,
                               weights=None) -> PartitionResult:
    """Proportional to max achievable hit mass (reuse intensity proxy).

    Every tenant is floored at ``min(c_min, capacity // n)`` before the
    proportional split, and only the residual budget is divided by
    intensity (largest-remainder rounding, ties broken by tenant index),
    so ``sum(sizes) == capacity`` exactly.
    """
    b = BatchedHitRatioFunctions.from_curves(hs)
    n = len(b)
    intensity = (b.max_hit_ratios.cpu().numpy()
                 * b.n_accesses.cpu().numpy()).astype(float)
    total = intensity.sum()
    if total <= 0 or n == 0:
        return _static_partition(hs, capacity, t_fast, t_slow, c_min, weights)
    cm = min(c_min, capacity // n)
    residual = capacity - cm * n
    raw = intensity / total * residual
    sizes = cm + np.floor(raw).astype(np.int64)
    residue = capacity - int(sizes.sum())         # < n floor leftovers
    if residue > 0:
        frac = raw - np.floor(raw)
        order = np.lexsort((np.arange(n), -frac))
        sizes[order[:residue]] += 1
    return _result(hs, sizes, t_fast, t_slow, weights)


def make_manager(scheme: str, capacity: int, tenant_names: list[str],
                 **kw) -> ECICacheManager:
    """Factory for the partitioned schemes (same knobs as
    ``ECICacheManager``; ``device=None`` means the CUDA card).  The
    ``global`` scheme shares one LRU and is ``GlobalLRUManager``."""
    if scheme in ("eci", "etica"):
        if scheme == "etica" and int(kw.get("capacity2", 0)) <= 0:
            raise ValueError("scheme 'etica' needs capacity2 > 0")
        return ECICacheManager(capacity, tenant_names, rd_kind="urd",
                               adaptive_policy=True, **kw)
    if scheme == "centaur":
        return ECICacheManager(capacity, tenant_names, rd_kind="trd",
                               adaptive_policy=False, **kw)
    if scheme == "static":
        return ECICacheManager(capacity, tenant_names, rd_kind="trd",
                               adaptive_policy=False,
                               partition_fn=_static_partition, **kw)
    if scheme == "reuse_intensity":
        m = ECICacheManager(capacity, tenant_names, rd_kind="trd",
                            adaptive_policy=False,
                            partition_fn=_reuse_intensity_partition, **kw)
        for t in m.tenants:           # vCacheShare uses Write-Around always
            t.policy = WritePolicy.RO
        return m
    raise ValueError(f"unknown scheme {scheme!r} (see SCHEMES)")


class GlobalLRUManager:
    """One shared LRU over all tenants (no partitioning, WB).

    Each window replays the tenants one after another through the
    interpreter ``simulate`` against the shared cache, whose state
    tensors stay on ``device`` (default: the CUDA card).
    """

    def __init__(self, capacity: int, tenant_names: list[str],
                 t_fast: float = 1.0, t_slow: float = 20.0,
                 device: str | torch.device | None = None, **_):
        self.device = resolve_device(device)
        self.cache = LRUCache(capacity, self.device)
        self.capacity = capacity
        self.t_fast, self.t_slow = t_fast, t_slow
        self.results = [SimResult(capacity=capacity) for _ in tenant_names]

    def run_window(self, traces: list[Trace | None]) -> None:
        for i, tr in enumerate(traces):
            if tr is None:
                continue
            res = simulate(tr, self.cache.capacity, WritePolicy.WB,
                           self.t_fast, self.t_slow, cache=self.cache)
            agg = self.results[i]
            agg.reads += res.reads; agg.read_hits += res.read_hits
            agg.writes += res.writes; agg.cache_writes += res.cache_writes
            agg.total_latency += res.total_latency

    def summary(self) -> dict[str, float]:
        n = sum(r.n for r in self.results)
        lat = sum(r.total_latency for r in self.results)
        writes = sum(r.cache_writes for r in self.results)
        mean_lat = lat / n if n else 0.0
        return {
            "accesses": n, "mean_latency": mean_lat,
            "performance": 1.0 / mean_lat if mean_lat else 0.0,
            "cache_writes": writes, "allocated_blocks": self.capacity,
            "perf_per_cost": ((1.0 / mean_lat) / self.capacity
                              if mean_lat and self.capacity else 0.0),
            "read_hit_ratio": (sum(r.read_hits for r in self.results)
                               / max(sum(r.reads for r in self.results), 1)),
        }
