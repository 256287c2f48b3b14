"""Dispatch: occurrence links -> reuse distances, on the links' device.

``reuse_distances_accel`` is the per-tenant Analyzer (the counterpart of
the reference's ``src/repro/kernels/urd_scan/ops.py:37``, which carries
the paper's Table 3): occurrence links from one sort, then
``urd_counts``, which calls ``kernel.urd_scan``: the hand-written kernel
on a CUDA tensor, the plain merge-tree route on a CPU tensor (the same
integers at any length).  The device decides the route, so the
reference's ``use_kernel`` switch has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.core.reuse_distance import RDResult, _check_kind
from repro_torch.core.trace import Trace, prev_next_occurrence
from repro_torch.device import resolve_device
from repro_torch.kernels.urd_scan.kernel import urd_scan

__all__ = ["reuse_distances_accel", "urd_counts"]


def urd_counts(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """int64 ``#{ j : prev[i] < j < i, nxt[j] >= i }`` per row; -1 where
    cold (``prev < 0``).

    Links may be severed at tenant-block boundaries (``nxt`` clamped to
    the block end): a hot row's interval never leaves its block.
    """
    counts = urd_scan(prev.to(torch.int32).contiguous(),
                      nxt.to(torch.int32).contiguous())
    return counts.to(torch.int64)


def reuse_distances_accel(trace: Trace, kind: str = "urd",
                          device: str | torch.device | None = None
                          ) -> RDResult:
    """Reuse distances of one trace on ``device`` (default: the CUDA
    card); equal to ``core.reuse_distance.reuse_distances``."""
    _check_kind(kind)
    dev = resolve_device(device)
    addrs = trace.addrs.to(dev, torch.int64)
    prev, nxt = prev_next_occurrence(addrs)
    counts = urd_counts(prev, nxt)
    mask = prev >= 0
    if kind == "urd":
        mask &= trace.is_read.to(dev, torch.bool)
    out = torch.where(mask, counts, -1)
    return RDResult(out, kind)
