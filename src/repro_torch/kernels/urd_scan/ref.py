"""Plain PyTorch version of the reuse-distance count of ``urd_scan``.

``urd_scan_ref`` is the dense O(n²) definition, row-chunked so it never
holds more than ~16M (i, j) pairs at once: the yardstick the CUDA kernel
is held against (exactly), for small n.  At any size the wrapper
``kernel.urd_scan`` takes the merge-tree route on a CPU tensor instead
(``kernels.cache_sim.ref.stack_distances_tree``), which gives the same
integers.

Contract shared with the kernel: cold rows (``prev < 0``) get -1.  The
reference's TPU kernel returns a prefix count there instead, which its
callers mask.
"""
from __future__ import annotations

import torch

__all__ = ["urd_scan_ref"]

_PAIRS_PER_CHUNK = 1 << 24


def urd_scan_ref(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """counts[i] = #{ j : prev[i] < j < i, nxt[j] >= i }; int32[n], -1 at
    cold rows."""
    n = prev.shape[0]
    dev = prev.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    j = torch.arange(n, device=dev)[None, :]
    nxt_j = nxt[None, :]
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        i = torch.arange(lo, hi, device=dev)[:, None]
        contrib = (j > prev[lo:hi, None]) & (j < i) & (nxt_j >= i)
        out[lo:hi] = contrib.sum(dim=1, dtype=torch.int32)
    out[prev < 0] = -1
    return out
