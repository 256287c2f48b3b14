"""The yardstick's arithmetic: the H100's published peaks, and the work
of each kernel, computed from shapes alone.

Frozen here so that a change to the program cannot move the ruler it is
measured by.  The kernel formulas are those of ``chip_smoke.py`` and the
port's ``costs.kernel_op`` work functions; each family
(``portbench/families/``) says which kernels a prefill and a decode step
run, and counts its model's FLOPs.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "bound_s",
           "causal_pairs", "flash_attention_work", "paged_attention_work",
           "paged_positions"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask leaves over ``s`` positions."""
    return s * (s + 1) // 2


def flash_attention_work(s: int, hq: int, hkv: int, d: int,
                         esize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal prefill call at [1, s, hq/hkv, d]: two
    products of 2 d FLOPs per seen pair and head; q, k, v read and the
    output written once."""
    flops = 4 * d * hq * causal_pairs(s)
    nbytes = (2 * s * hq * d + 2 * s * hkv * d) * esize
    return flops, nbytes


def paged_positions(pages: list[np.ndarray], lens: np.ndarray,
                    page: int) -> int:
    """Distinct pool positions one decode step's rows attend: each row
    reads positions [0, len) through its block table; a page that rows
    share (a prefix) is counted once, over the most positions any of them
    reads in it."""
    if not len(lens):
        return 0
    pids, cover = [], []
    for pg, n in zip(pages, lens):
        k = -(-int(n) // page)
        pids.append(np.asarray(pg[:k], np.int64))
        c = np.full(k, page, np.int64)
        if k:
            c[-1] = int(n) - (k - 1) * page
        cover.append(c)
    pids, cover = np.concatenate(pids), np.concatenate(cover)
    best = np.zeros(int(pids.max()) + 1 if len(pids) else 0, np.int64)
    np.maximum.at(best, pids, cover)
    return int(best.sum())


def paged_attention_work(positions: int, rows: int, pages_per_seq: int,
                         hq: int, hkv: int, d: int,
                         esize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode call: K and V of every attended pool
    position read once, q read and the output written once, the block
    tables and lengths (int32) read once; 4 d FLOPs per position and q
    head."""
    flops = 4 * d * hq * positions
    nbytes = (positions * hkv * d * 2 * esize + 2 * rows * hq * d * esize
              + 4 * (rows * pages_per_seq + rows))
    return flops, nbytes

