"""Plain PyTorch versions of the occupancy-masked stack-distance count.

Two routes to the same numbers, both running on any device:

  * ``cache_sim_ref`` — the dense definition, row-chunked so it never
    holds more than ~16M (i, j) pairs at once.  It is the yardstick the
    CUDA kernel is held against (exactly) and the CPU answer for an
    explicit occupancy mask.
  * the merge-tree route — ``coverage_counts`` + ``count_prev_ge``, joined
    by ``stack_distances_tree`` — computes the same distances for
    ``occ = 1`` in O(n log² n) work (the reference's host engine,
    ``repro.core.batch_sim``).  It is what a CPU tensor takes on the main
    path at any size.

The two-level hierarchy's kernels have dense yardsticks here too:
``cache_sim_levels_ref`` (the count compared with two per-row capacity
thresholds, the masks of ``cache_sim_levels_scan``) and
``live_counts_ref`` (the RO live count of ``live_count_scan``, with its
O(n) form ``live_counts_delta``, which a CPU tensor takes on the main
path).

The segment-restricted count of ``cache_sim_segments_scan`` has the same
two routes on a padded, self-aligned multi-tenant tape: the dense
``cache_sim_segments_ref`` (the j plane masked to the row's own
``seg_width`` block) and the merge-sort tree ``cache_sim_segments_tree``
(O(m log² w) work, O(m) memory), which is what a CPU tensor takes on the
sampled monitor's path.

Contract shared with the kernels: cold rows (``prev < 0``, which includes
the pad rows of a padded tape) get -1.
"""
from __future__ import annotations

import torch

__all__ = ["cache_sim_levels_ref", "cache_sim_ref", "cache_sim_segments_ref",
           "cache_sim_segments_tree", "count_prev_ge", "coverage_counts",
           "live_counts_delta", "live_counts_ref", "stack_distances_tree"]

_PAIRS_PER_CHUNK = 1 << 24


def cache_sim_ref(prev: torch.Tensor, nxt: torch.Tensor,
                  occ: torch.Tensor) -> torch.Tensor:
    """counts[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i }.

    int32[n]; -1 at cold rows (``prev[i] < 0``).  With ``occ = 1`` this
    is the per-access LRU stack distance (resident iff SD < capacity);
    ``occ = is_read`` gives the RO write-around distance.
    """
    n = prev.shape[0]
    dev = prev.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    j = torch.arange(n, device=dev)[None, :]
    nxt_j = nxt[None, :]
    occ_j = (occ > 0)[None, :]
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        i = torch.arange(lo, hi, device=dev)[:, None]
        contrib = ((j > prev[lo:hi, None]) & (j < i) & (nxt_j >= i)
                   & occ_j)
        out[lo:hi] = contrib.sum(dim=1, dtype=torch.int32)
    out[prev < 0] = -1
    return out


def cache_sim_levels_ref(prev: torch.Tensor, nxt: torch.Tensor,
                         occ: torch.Tensor, cap1: torch.Tensor,
                         captot: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both-level residency masks ``(l1, union)``, int32 0/1 per row.

    The exclusive two-level hierarchy's union is one LRU stack whose top
    ``cap1[i]`` entries are L1, so with ``SD = cache_sim_ref(prev, nxt,
    occ)``: ``l1[i] = prev[i] >= 0 and SD[i] < cap1[i]``, ``union[i] =
    prev[i] >= 0 and SD[i] < captot[i]`` (an L2 hit is ``union & ~l1``).
    Cold rows are 0 in both.
    """
    counts = cache_sim_ref(prev, nxt, occ)
    hot = prev >= 0
    return ((hot & (counts < cap1)).to(torch.int32),
            (hot & (counts < captot)).to(torch.int32))


def live_counts_ref(nxt: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """counts[i] = #{ j <= i : occ[j] > 0, nxt[j] > i } (dense O(n²)).

    The RO write-around live count: occupying tokens still resident
    after access i assuming no eviction (the batch engine's no-eviction
    guard; with ``occ`` on the warm-L2 pseudo rows, the still-untouched
    warm-L2 blocks).  int32, row-chunked like ``cache_sim_ref``.
    """
    n = nxt.shape[0]
    dev = nxt.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    j = torch.arange(n, device=dev)[None, :]
    nxt_j = nxt[None, :]
    occ_j = (occ > 0)[None, :]
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        i = torch.arange(lo, hi, device=dev)[:, None]
        contrib = (j <= i) & (nxt_j > i) & occ_j
        out[lo:hi] = contrib.sum(dim=1, dtype=torch.int32)
    return out


def live_counts_delta(nxt: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """``live_counts_ref`` in O(n): +1 at each token's birth j, -1 at its
    death ``min(nxt[j], n)``, prefix-summed.

    Only rows with ``occ[j] > 0`` and ``nxt[j] > j`` are tokens; a row
    with ``nxt[j] <= j`` (a pad row's -1, say) never counts in the dense
    definition, so it adds nothing here either.  int32.
    """
    n = nxt.shape[0]
    nx = nxt.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=nxt.device)
    tok = (occ > 0) & (nx > pos)
    d = (torch.bincount(pos[tok], minlength=n + 1)
         - torch.bincount(torch.clamp(nx[tok], max=n), minlength=n + 1))
    return torch.cumsum(d[:n], 0).to(torch.int32)


def cache_sim_segments_ref(prev: torch.Tensor, nxt: torch.Tensor,
                           occ: torch.Tensor, seg_width: int) -> torch.Tensor:
    """``cache_sim_ref`` with j restricted to row i's ``seg_width`` block:

    ``counts[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i,
    j // seg_width == i // seg_width }``, int32, -1 at cold rows.  The
    dense definition, row-chunked like ``cache_sim_ref``; the yardstick
    the CUDA ``cache_sim_segments_scan`` is held against, exactly.
    """
    n = prev.shape[0]
    dev = prev.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    j = torch.arange(n, device=dev)[None, :]
    blk_j = j // seg_width
    nxt_j = nxt[None, :]
    occ_j = (occ > 0)[None, :]
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        i = torch.arange(lo, hi, device=dev)[:, None]
        contrib = ((j > prev[lo:hi, None]) & (j < i) & (nxt_j >= i)
                   & occ_j & (blk_j == i // seg_width))
        out[lo:hi] = contrib.sum(dim=1, dtype=torch.int32)
    out[prev < 0] = -1
    return out


def cache_sim_segments_tree(prev: torch.Tensor, nxt: torch.Tensor,
                            occ: torch.Tensor,
                            seg_width: int) -> torch.Tensor:
    """``cache_sim_segments_ref`` without the dense (i, j) plane.

    The reference's merge-sort tree (``repro.kernels.cache_sim.ref``):
    at every level ``s = 1, 2, ..., seg_width / 2`` the occupying
    ``nxt + 1`` values are sorted inside each aligned s-block (pads and
    non-occupying rows carry 0, below every query), and each query
    interval ``(prev[i], i)`` is peeled into its canonical aligned
    blocks, at most two a level, each counted by one ``searchsorted`` of
    ``nxt >= i``.  ``seg_width`` is a power of two dividing the length,
    and links stay inside their block (``prev`` severed, ``nxt``
    clamped), as on a padded tape.  int32, -1 at cold rows.
    """
    m = prev.shape[0]
    dev = prev.device
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    levels = max(int(seg_width).bit_length() - 1, 0)    # seg_width = 2**L
    big = m + 2                                         # value field size
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    v = torch.where(occ > 0, nxt.to(torch.int64) + 1, 0)  # query is i + 1
    a = torch.where(prev >= 0, prev.to(torch.int64) + 1, pos)  # cold: empty
    b = pos
    q = pos + 1
    cnt = torch.zeros(m, dtype=torch.int64, device=dev)
    for lev in range(levels):
        s = 1 << lev
        srt = v if s == 1 else torch.sort(v.view(-1, s), dim=1).values \
            .view(-1)
        keys = (pos // s) * big + srt                   # sorted composite
        # left peel: a sits on an odd s-block of its 2s-parent
        do = (a < b) & ((a // s) % 2 == 1)
        blk = a // s
        p = torch.searchsorted(keys, blk * big + q)
        cnt = cnt + torch.where(do, (blk + 1) * s - p, 0)
        a = a + torch.where(do, s, 0)
        # right peel
        do = (a < b) & ((b // s) % 2 == 1)
        b = b - torch.where(do, s, 0)
        blk = b // s
        p = torch.searchsorted(keys, blk * big + q)
        cnt = cnt + torch.where(do, (blk + 1) * s - p, 0)
    out = cnt.to(torch.int32)
    out[prev < 0] = -1
    return out


def coverage_counts(nxt: torch.Tensor) -> torch.Tensor:
    """F[i] = #{ j < i : nxt[j] >= i } via a difference array, O(n).

    Returns n + 1 entries (the reference's ``_coverage_counts``)."""
    n = nxt.shape[0]
    d = -torch.bincount(torch.clamp(nxt, max=n) + 1, minlength=n + 2)
    d[1:n + 1] += 1                              # interval starts at j + 1
    return torch.cumsum(d, 0)[:n + 1]


def count_prev_ge(y: torch.Tensor) -> torch.Tensor:
    """cnt[q] = #{ j < q : y[j] >= y[q] }, bottom-up merge tree.

    At half-size ``s`` every element in the right half of an aligned
    2s-block counts the elements >= it in the left half: one row-wise
    sort of the left halves and one batched ``searchsorted`` per level,
    O(n log² n) work.  Requires ``y >= 0`` (pads carry -1).
    """
    m = y.shape[0]
    out = torch.zeros(m, dtype=torch.int64, device=y.device)
    s = 1
    while s < m:
        w = 2 * s
        ms = -(-m // w) * w
        yp = torch.full((ms,), -1, dtype=torch.int64, device=y.device)
        yp[:m] = y
        blk = yp.view(-1, w)
        left = blk[:, :s].sort(dim=1).values
        n_lt = torch.searchsorted(left, blk[:, s:].contiguous())
        cnt = torch.zeros_like(blk)
        cnt[:, s:] = s - n_lt
        out += cnt.view(-1)[:m]
        s = w
    return out


def stack_distances_tree(prev: torch.Tensor,
                         nxt: torch.Tensor) -> torch.Tensor:
    """int64 SD per access for ``occ = 1``; -1 at cold rows.

    ``SD(i) = F(i) - G(i)`` with ``F = coverage_counts(nxt)`` and
    ``G(i) = count_prev_ge(nxt)[prev[i]] + 1`` (``nxt[prev[i]] == i``).
    Links may be severed and ``nxt`` clamped at tenant-block ends: a
    clamped interval never covers a hot access of another block, so one
    pass over the unpadded multi-tenant tape gives each block's own
    distances.
    """
    n = prev.shape[0]
    sd = torch.full((n,), -1, dtype=torch.int64, device=prev.device)
    if n == 0:
        return sd
    nxt = nxt.to(torch.int64)
    F = coverage_counts(nxt)
    cnt = count_prev_ge(nxt)
    idx = torch.nonzero(prev >= 0).squeeze(1)
    sd[idx] = F[idx] - (cnt[prev[idx].to(torch.int64)] + 1)
    return sd
