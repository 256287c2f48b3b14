"""Reuse-distance results (TRD and URD) and the URD-based cache size.

Definitions (paper §4): a reuse-distance sample at access ``i`` with a
previous access to the same address at ``p`` is the number of distinct
addresses touched strictly between ``p`` and ``i``.  TRD samples every
re-touch; URD only read re-touches (RAR, RAW).  The distances themselves
come from the stack-distance count of ``repro_torch.core.batch_sim``;
the SHARDS-sampled engine of the reference is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RDResult", "max_rd", "urd_cache_blocks"]


@dataclasses.dataclass(frozen=True)
class RDResult:
    """Per-access reuse-distance samples.

    distances: int64[n] — RD sample per access; -1 where the access
      produced no sample (cold access, or — for URD — a write access).
    kind: "trd" | "urd".
    """

    distances: torch.Tensor
    kind: str

    @property
    def samples(self) -> torch.Tensor:
        return self.distances[self.distances >= 0]


def max_rd(result: RDResult, percentile: float = 100.0) -> int:
    """Max (or percentile) reuse distance; -1 when no samples exist.

    The percentile interpolates linearly between order statistics, as
    ``np.percentile``'s default does."""
    s = result.samples
    if s.numel() == 0:
        return -1
    if percentile >= 100.0:
        return int(s.max())
    return int(torch.quantile(s.to(torch.float64), percentile / 100.0))


def urd_cache_blocks(result: RDResult, percentile: float = 100.0) -> int:
    """Paper ``calculateURDbasedSize``: a reuse at distance d needs d + 1
    resident blocks (Fig. 5: max URD 1 -> 2 blocks)."""
    m = max_rd(result, percentile)
    return m + 1 if m >= 0 else 0
