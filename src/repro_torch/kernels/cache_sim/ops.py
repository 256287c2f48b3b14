"""Dispatch: occurrence links -> LRU stack distances, on the links' device.

``stack_distances`` is the counting step of the batch replay engine
(``repro_torch.core.batch_sim``) and of the monitor's recount.  A CUDA
tensor goes through the hand-written kernel (``kernel.cache_sim_scan``)
with every access occupying; a CPU tensor through the plain merge-tree
route, which gives the same integers, and -1 at cold rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cache_sim.kernel import cache_sim_scan
from repro_torch.kernels.cache_sim.ref import stack_distances_tree

__all__ = ["stack_distances"]


def stack_distances(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """int64 stack distances per access, -1 where cold (``prev < 0``).

    Links may be severed at tenant-block boundaries with ``nxt`` clamped
    to the block end: a hot access's interval never leaves its block, so
    one call counts a whole multi-tenant tape.
    """
    if prev.device.type == "cuda":
        p32 = prev.to(torch.int32).contiguous()
        counts = cache_sim_scan(p32, nxt.to(torch.int32).contiguous(),
                                torch.ones_like(p32))
        return counts.to(torch.int64)
    return stack_distances_tree(prev, nxt)
