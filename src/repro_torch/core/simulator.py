"""Per-tenant replay results and the LRU partition state.

Port of the state half of ``repro.core.simulator``: ``SimResult`` (the
per-tenant counts and latency of one replayed window) and ``LRUCache``
(one tenant's partition of the fast tier).  The batch engine
(``repro_torch.core.batch_sim``) replays whole windows and leaves each
cache in its exact final LRU state; the per-access interpreter
``simulate`` of the reference is not ported yet.

Latency model (paper §5.1): read hit -> t_fast; read miss -> t_slow;
writes under WB -> t_fast; writes that bypass the fast tier (RO/WT) ->
t_write_bypass; each dirty eviction charges ``flush_cost``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SimResult", "LRUCache"]


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
