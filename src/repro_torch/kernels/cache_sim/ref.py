"""Plain PyTorch versions of the occupancy-masked stack-distance count.

Three routes to the same numbers, all running on any device:

  * ``cache_sim_ref`` — the dense definition, row-chunked so it never
    holds more than ~16M (i, j) pairs at once.  It is the yardstick the
    CUDA kernel is held against (exactly) and the CPU answer for an
    explicit occupancy mask.
  * ``cache_sim_tiled_ref`` — the CUDA kernel's own decomposition
    (direct compares over the head and tail of each interval, a
    ``searchsorted`` in each sorted whole tile between them), held to the
    dense definition in the tests.
  * the merge-tree route — ``coverage_counts`` + ``count_prev_ge``, joined
    by ``stack_distances_tree`` — computes the same distances for
    ``occ = 1`` in O(n log² n) work (the reference's host engine,
    ``repro.core.batch_sim``).  It is what a CPU tensor takes on the main
    path at any size.

The two-level hierarchy's kernels have dense yardsticks here too:
``cache_sim_levels_ref`` (the count compared with two per-row capacity
thresholds, the masks of ``cache_sim_levels_scan``, whose decomposition
is ``cache_sim_levels_tiled_ref``) and
``live_counts_ref`` (the RO live count of ``live_count_scan``, with its
O(n) form ``live_counts_delta``, which a CPU tensor takes on the main
path, and the kernel's one-pass decomposition ``live_counts_onepass_ref``).

The segment-restricted count of ``cache_sim_segments_scan`` has the same
two routes on a padded, self-aligned multi-tenant tape: the dense
``cache_sim_segments_ref`` (the j plane masked to the row's own
``seg_width`` block) and the merge-sort tree ``cache_sim_segments_tree``
(O(m log² w) work, O(m) memory), which is what a CPU tensor takes on the
sampled monitor's path; ``cache_sim_segments_tiled_ref`` is the CUDA
kernel's decomposition.  ``live_counts_onepass_ref`` and
``cache_sim_segments_tiled_ref`` are held to the reference in the tests
only.

Contract shared with the kernels: cold rows (``prev < 0``, which includes
the pad rows of a padded tape) get -1.
"""
from __future__ import annotations

import torch

__all__ = ["cache_sim_levels_ref", "cache_sim_levels_tiled_ref",
           "cache_sim_ref", "cache_sim_segments_ref",
           "cache_sim_segments_tiled_ref", "cache_sim_segments_tree",
           "cache_sim_tiled_ref", "count_prev_ge", "coverage_counts",
           "live_counts_delta", "live_counts_onepass_ref", "live_counts_ref",
           "stack_distances_tree"]

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


def cache_sim_tiled_ref(prev: torch.Tensor, nxt: torch.Tensor,
                        occ: torch.Tensor, tile: int) -> torch.Tensor:
    """``cache_sim_ref`` as ``cache_sim_scan``'s kernel decomposes it.

    With ``key[j] = nxt[j]`` where ``occ[j] > 0`` and -1 elsewhere, row
    i's interval ``[prev[i] + 1, i)`` is cut at the tile edges (multiples
    of ``tile``): the head before the first edge and the tail after the
    last are counted by direct compares ``key[j] >= i`` (each under
    ``tile`` positions), and each whole tile between them by a
    ``searchsorted`` of i in its sorted keys.  int32, -1 at cold rows.
    """
    n = prev.shape[0]
    dev = prev.device
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(prev >= 0).squeeze(1)
    if rows.numel() == 0:
        return out
    key = torch.where(occ > 0, nxt.to(torch.int64), -1)
    i = rows
    lo = prev[rows].to(torch.int64) + 1
    head_end = torch.minimum(-(-lo // tile) * tile, i)
    tail_start = torch.maximum(i // tile * tile, head_end)
    cnt = torch.zeros(rows.numel(), dtype=torch.int64, device=dev)
    # head and tail: offsets 0 .. tile - 2 from each piece's start
    off = torch.arange(max(tile - 1, 1), device=dev)
    chunk = max(1, _PAIRS_PER_CHUNK // off.numel())
    for start, end in ((lo, head_end), (tail_start, i)):
        for c in range(0, rows.numel(), chunk):
            j = start[c:c + chunk, None] + off[None, :]
            inside = j < end[c:c + chunk, None]
            hit = key[j.clamp(0, n - 1)] >= i[c:c + chunk, None]
            cnt[c:c + chunk] += (inside & hit).sum(dim=1)
    # whole tiles: keys sorted in each, shifted to >= 0 and made one
    # ascending list by the tile's index, searched for i + 1
    tiles = n // tile
    ntile = tail_start // tile - head_end // tile
    if tiles and int(ntile.sum()):
        srt = torch.sort(key[:tiles * tile].view(tiles, tile), dim=1).values
        big = int(key.max()) + 3
        flat = (torch.arange(tiles, device=dev)[:, None] * big
                + srt + 1).view(-1)
        owner = torch.repeat_interleave(torch.arange(rows.numel(),
                                                     device=dev), ntile)
        first = torch.repeat_interleave(head_end // tile, ntile)
        k = first + (torch.arange(owner.numel(), device=dev)
                     - torch.repeat_interleave(torch.cumsum(ntile, 0)
                                               - ntile, ntile))
        below = torch.searchsorted(flat, k * big + i[owner] + 1) - k * tile
        cnt.index_add_(0, owner, tile - below)
    out[rows] = cnt.to(torch.int32)
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


def cache_sim_levels_tiled_ref(prev: torch.Tensor, nxt: torch.Tensor,
                               occ: torch.Tensor, cap1: torch.Tensor,
                               captot: torch.Tensor, tile: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cache_sim_levels_ref`` as ``cache_sim_levels_scan``'s kernel
    decomposes it: the exact count of ``cache_sim_tiled_ref`` compared
    with both capacities, for any capacities (``cap1 > captot`` and zeros
    included).  int32 0/1 masks ``(l1, union)``, cold rows 0."""
    counts = cache_sim_tiled_ref(prev, nxt, occ, tile)
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


def live_counts_onepass_ref(nxt: torch.Tensor, occ: torch.Tensor,
                            tile: int = 4096) -> torch.Tensor:
    """``live_counts_ref`` as ``live_count_scan``'s kernel computes it, a
    tile of ``tile`` rows after another: the tile's births (+1 at each
    token, ``occ[j] > 0`` and ``nxt[j] > j``), its own deaths (-1 at
    ``nxt[j]`` inside it), the deaths that earlier tiles carried forward
    into it (deaths at ``nxt[j] >= n`` dropped), a scan of the tile, and
    the running total of the tiles before it added.  int32."""
    n = nxt.shape[0]
    dev = nxt.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    nx = nxt.to(torch.int64)
    carried = torch.zeros(n, dtype=torch.int64, device=dev)
    before = 0
    for base in range(0, n, tile):
        end = min(base + tile, n)
        pos = torch.arange(base, end, device=dev)
        tok = (occ[base:end] > 0) & (nx[base:end] > pos)
        x = nx[base:end][tok & (nx[base:end] < n)]
        here = x < end
        delta = tok.to(torch.int64) - torch.bincount(x[here] - base,
                                                     minlength=end - base)
        carried.index_add_(0, x[~here], torch.ones_like(x[~here]))
        scan = torch.cumsum(delta - carried[base:end], 0)
        out[base:end] = (before + scan).to(torch.int32)
        before += int(scan[-1])
    return out


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


def cache_sim_segments_tiled_ref(prev: torch.Tensor, nxt: torch.Tensor,
                                 occ: torch.Tensor, seg_width: int,
                                 tile: int = 256) -> torch.Tensor:
    """``cache_sim_segments_ref`` as ``cache_sim_segments_scan``'s kernel
    decomposes it.

    A hot row's interval starts at ``lo = max(prev[i] + 1, i - i % w)``
    (prev raised to the block start).  The block is cut into tiles of
    ``T = min(tile, w)`` positions from its start (the last one ragged when
    T does not divide w); with ``key[j] = nxt[j]`` where ``occ[j] > 0`` and
    -1 elsewhere, an interval inside the row's own tile and the head up to
    the first tile edge are direct compares ``key[j] >= i`` (under T
    positions), each whole tile between is the count of its keys >= i, and
    the tail from the row's tile start is a coverage count: key j covers
    rows ``j + 1 .. min(key, tile end - 1)``, a difference array prefix-
    summed over the tape, read as ``P[i] - P[tile start]``.  int32, -1 at
    cold rows.
    """
    m = prev.shape[0]
    dev = prev.device
    w = int(seg_width)
    T = min(int(tile), w)
    out = torch.full((m,), -1, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    key = torch.where(occ > 0, nxt.to(torch.int64), -1)
    pos = torch.arange(m, device=dev)
    bs = pos - pos % w
    start = bs + (pos - bs) // T * T                 # the row's own tile
    end = torch.minimum(start + T, bs + w)
    lo = torch.minimum(torch.maximum(prev.to(torch.int64) + 1, bs), pos)
    inside = lo > start
    edge = torch.where(inside, pos,
                       torch.minimum(bs + -(-(lo - bs) // T) * T, start))
    cnt = torch.zeros(m, dtype=torch.int64, device=dev)
    # direct compares over [lo, edge)
    off = torch.arange(max(T - 1, 1), device=dev)
    chunk = max(1, _PAIRS_PER_CHUNK // off.numel())
    for c in range(0, m, chunk):
        j = lo[c:c + chunk, None] + off[None, :]
        hit = key[j.clamp(max=m - 1)] >= pos[c:c + chunk, None]
        cnt[c:c + chunk] += ((j < edge[c:c + chunk, None]) & hit).sum(dim=1)
    # tails [start, i) by coverage
    last = torch.minimum(key, end - 1)
    covers = last > pos
    diff = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, pos[covers] + 1, torch.ones_like(pos[covers]))
    stops = covers & (last + 1 < end)
    diff.index_add_(0, last[stops] + 1, -torch.ones_like(pos[stops]))
    P = torch.cumsum(diff[:m], 0)
    cnt += torch.where(inside, 0, P - P[start])
    # whole tiles [edge, start): keys >= i of each, from its sorted keys
    ntile = ((start - edge) // T).clamp(min=0)
    if int(ntile.sum()):
        per = w // T                                 # whole tiles a block
        first = (torch.arange(m // w, device=dev)[:, None] * w
                 + torch.arange(per, device=dev)[None, :] * T).view(-1)
        srt = torch.sort(key[first[:, None] + torch.arange(T, device=dev)],
                         dim=1).values
        big = int(key.max()) + 3
        flat = (torch.arange(first.numel(), device=dev)[:, None] * big
                + srt + 1).view(-1)
        owner = torch.repeat_interleave(pos, ntile)
        k0 = torch.repeat_interleave(bs // w * per + (edge - bs) // T, ntile)
        k = k0 + (torch.arange(owner.numel(), device=dev)
                  - torch.repeat_interleave(torch.cumsum(ntile, 0) - ntile,
                                            ntile))
        below = torch.searchsorted(flat, k * big + owner + 1) - k * T
        cnt.index_add_(0, owner, T - below)
    hot = prev >= 0
    out[hot] = cnt[hot].to(torch.int32)
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
