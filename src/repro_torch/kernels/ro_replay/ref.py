"""Plain versions of the RO eviction-token replays (host loops).

``ro_token_replay_ref`` and ``ro_token_replay_levels_ref`` replay one
tenant block, as the reference's ``_ro_token_replay`` and
``_ro_token_replay_levels`` (``src/repro/core/batch_sim.py:539``,
``:589``): host loops over host copies of the block, taken once (never
element-wise reads of device tensors).  ``ro_token_replay_blocks_ref``
and ``ro_token_replay_levels_blocks_ref`` are the functions the CUDA
kernels compute: the same loops over several blocks of one tape, with
the outputs laid out block after block.

``ro_token_replay_pointer_ref`` and ``ro_token_replay_levels_pointer_ref``
compute the same functions the way the CUDA kernels do
(``csrc/ro_replay.cu``): a walk that reads only the read-only inputs,
with the victim pointers stepped past each token they act on, so that
"was p evicted" is ``p < b`` (``b2`` with two levels) and "is p in L1"
is ``p >= b1``; then the dirty bits and the flushes in a pass after the
walk, by pointer jumping along the read-hit chains (``_dirty_pass``).

``EDGE_CASES`` and ``ro_edge_tape`` make the tapes that hold the kernels
to these at the edges of their design, on the card and at small scale
on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["EDGE_CASES", "ro_edge_tape", "ro_token_replay_blocks_ref",
           "ro_token_replay_levels_blocks_ref",
           "ro_token_replay_levels_pointer_ref", "ro_token_replay_levels_ref",
           "ro_token_replay_pointer_ref", "ro_token_replay_ref"]


def ro_token_replay_ref(is_read_blk: torch.Tensor, prev_blk: torch.Tensor,
                        nxt_blk: torch.Tensor, force_blk: torch.Tensor,
                        cap: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Exact RO (write-around) replay of one block under capacity
    pressure, O(n).

    Every read position ``j`` is a cache-slot token alive on ``(j,
    nxt[j])``; a miss that overflows the partition evicts the minimum
    live token, which is non-decreasing over time, so one forward pointer
    suffices.  Access ``i`` then hits iff its previous occurrence ``p``
    was a read whose token survived to its natural death (``death[p] ==
    i``).  Positions are local to the block (``prev < 0``: none).

    Returns (death, dirty, flushes) with the tensors on the block's
    device: ``death[j]`` when token j left the cache (== ``nxt_blk[j]``
    iff never evicted), ``dirty[j]`` the flag it carried, ``flushes`` the
    dirty evictions.
    """
    n = int(is_read_blk.shape[0])
    rd = is_read_blk.tolist()
    pv = prev_blk.tolist()
    death = nxt_blk.tolist()
    dirty = force_blk.tolist()
    flushes = 0
    resident = 0
    b = 0                                        # oldest-resident candidate
    for t in range(n):
        p = pv[t]
        if rd[t]:
            if p >= 0 and rd[p] and death[p] == t:
                dirty[t] = dirty[p]              # hit: token renewal
            else:
                resident += 1                    # miss: install clean
                if resident > cap:
                    while not rd[b] or death[b] <= t:
                        b += 1
                    death[b] = t                 # evict oldest resident
                    if dirty[b]:
                        flushes += 1
                    resident -= 1
        elif p >= 0 and rd[p] and death[p] == t:
            resident -= 1                        # write-hit: invalidate
    dev = is_read_blk.device
    return (torch.tensor(death, dtype=torch.int64, device=dev),
            torch.tensor(dirty, dtype=torch.bool, device=dev), flushes)


def ro_token_replay_levels_ref(is_read_blk: torch.Tensor,
                               prev_blk: torch.Tensor, nxt_blk: torch.Tensor,
                               force_blk: torch.Tensor, cap1: int, cap2: int,
                               l2_end: int, clean2: bool
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, int, int]:
    """Exact two-level RO replay of one block under eviction pressure,
    O(n).

    The eviction-token loop of ``ro_token_replay_ref`` with a level per
    token: recency within a level is token-position order; a demotion
    moves L1's minimum live token (forward pointer ``b1``, skipping
    demoted tokens) into L2; an L2 overflow evicts the lowest live token
    (``b2``; always an L2 one, since live L1 positions sit above every
    live L2 position).  An invalidation frees a slot in whichever level
    holds the token; the next install fills the hole without demoting.
    ``clean2`` flushes a dirty victim at the demotion instead of at its
    final eviction.  Positions below ``l2_end`` are the warm-L2
    pseudo-reads, born in L2.

    Returns ``(death, dirty, lvl, flushes, demotions)`` with the tensors
    on the block's device: ``death[j]`` when token j left the hierarchy
    (== ``nxt_blk[j]`` iff never evicted from L2), ``dirty[j]`` its flag,
    ``lvl[j]`` (int8) the level it died in, ``flushes`` the dirty
    evictions and demotion flushes, ``demotions`` the L2 cache writes.
    """
    n = int(is_read_blk.shape[0])
    rd = is_read_blk.tolist()
    pv = prev_blk.tolist()
    death = nxt_blk.tolist()
    dirty = force_blk.tolist()
    lvl = [1] * n
    flushes = demotions = 0
    res1 = res2 = 0
    b1 = b2 = 0                                  # per-level victim candidates
    for t in range(n):
        if t < l2_end:
            lvl[t] = 2                           # warm-L2 token: born in L2
            res2 += 1
            continue
        p = pv[t]
        if rd[t]:
            if p >= 0 and rd[p] and death[p] == t:
                dirty[t] = dirty[p]              # hit: token renewal
                if lvl[p] == 1:
                    continue                     # L1 hit: occupancy unchanged
                res2 -= 1                        # L2 hit: promote out of L2
            res1 += 1                            # install / rebirth into L1
            if res1 > cap1:
                while not rd[b1] or death[b1] <= t or lvl[b1] == 2:
                    b1 += 1                      # min live L1 token
                lvl[b1] = 2                      # demote into L2's MRU
                if clean2 and dirty[b1]:
                    flushes += 1                 # flush at the demotion
                    dirty[b1] = False
                res1 -= 1
                res2 += 1
                demotions += 1
                if res2 > cap2:
                    while not rd[b2] or death[b2] <= t:
                        b2 += 1                  # min live token == L2 victim
                    death[b2] = t                # evicted for good
                    if dirty[b2]:
                        flushes += 1
                    res2 -= 1
        elif p >= 0 and rd[p] and death[p] == t:
            if lvl[p] == 1:                      # write-hit: invalidate the
                res1 -= 1                        # holding level (a hole)
            else:
                res2 -= 1
    dev = is_read_blk.device
    return (torch.tensor(death, dtype=torch.int64, device=dev),
            torch.tensor(dirty, dtype=torch.bool, device=dev),
            torch.tensor(lvl, dtype=torch.int8, device=dev), flushes,
            demotions)


def _walk_inputs(rd: list, pv: list, nx: list) -> tuple[list, list]:
    """The walk's read-only streams: ``cand[t]`` is ``p + 1`` when the
    previous occurrence ``p`` of t is a read (the token t may hit), else
    0; ``live_to[j]`` is ``nxt[j]`` for a read token, else -1 (never a
    victim)."""
    cand = [p + 1 if p >= 0 and rd[p] else 0 for p in pv]
    live_to = [x if r else -1 for r, x in zip(rd, nx)]
    return cand, live_to


def _dirty_pass(rd: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor,
                force: torch.Tensor, death: torch.Tensor, born_from: int,
                cleaned: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The dirty bits and the flushes of a walked block, after the walk.

    A read t at or past ``born_from`` hits iff its previous occurrence p
    is a read whose token lived to t (``death[p] == t``); it is then born
    with p's final flag, any other row with its forced flag.  A token
    ``cleaned`` (demoted under a clean L2) ends with 0 and flushes its
    birth flag at the demotion; every other victim (``death < nxt``)
    flushes its birth flag at the eviction.  The birth flags are found by
    pointer jumping, as the kernel's pass behind the walk finds them: each
    row points at its parent until a terminal row (a chain's root, or a
    row whose parent was cleaned, born 0), whose flag it then takes;
    about log2 of the longest chain rounds.  Returns (final flags,
    flushes).
    """
    n = rd.shape[0]
    idx = torch.arange(n)
    ps = prev.clamp(min=0)
    hit = (rd & (prev >= 0) & rd[ps] & (death[ps] == idx)
           & (idx >= born_from))
    from_cleaned = hit & cleaned[ps]
    value = force & ~hit                     # a terminal row's birth flag
    ptr = torch.where(hit & ~from_cleaned, ps, idx)
    while True:
        jumped = ptr[ptr]
        if torch.equal(jumped, ptr):
            break
        ptr = jumped
    born = value[ptr]
    victims = death != nxt
    flushes = int((cleaned & born).sum()) + int((victims & ~cleaned
                                                 & born).sum())
    return born & ~cleaned, flushes


def ro_token_replay_pointer_ref(is_read_blk: torch.Tensor,
                                prev_blk: torch.Tensor,
                                nxt_blk: torch.Tensor,
                                force_blk: torch.Tensor, cap: int
                                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``ro_token_replay_ref`` as the CUDA kernel computes it: the walk
    never reads ``death`` or ``dirty``.

    The victim pointer ``b`` steps past each victim, so every read token
    below ``b`` still alive by its links was evicted and none at or above
    it was: access t hits iff its previous occurrence p is a read with
    ``p >= b``, and the next victim is the first read token at or past
    ``b`` whose ``nxt`` lies beyond t.  The state is ``resident`` and
    ``b``; the dirty bits and flushes follow in ``_dirty_pass``.
    """
    n = int(is_read_blk.shape[0])
    rd = is_read_blk.tolist()
    nx = nxt_blk.tolist()
    cand, live_to = _walk_inputs(rd, prev_blk.tolist(), nx)
    death = list(nx)
    resident = 0
    b = 0                                        # next victim candidate
    for t in range(n):
        hit = cand[t] > b
        if rd[t]:
            if not hit:
                resident += 1                    # miss: install
                if resident > cap:
                    while live_to[b] <= t:
                        b += 1
                    death[b] = t                 # evict the oldest resident
                    b += 1
                    resident -= 1
        elif hit:
            resident -= 1                        # write-hit: invalidate
    dev = is_read_blk.device
    death_t = torch.tensor(death, dtype=torch.int64)
    dirty, flushes = _dirty_pass(
        is_read_blk.cpu(), prev_blk.cpu().long(), nxt_blk.cpu().long(),
        force_blk.cpu(), death_t, 0, torch.zeros(n, dtype=torch.bool))
    return death_t.to(dev), dirty.to(dev), flushes


def ro_token_replay_levels_pointer_ref(is_read_blk: torch.Tensor,
                                       prev_blk: torch.Tensor,
                                       nxt_blk: torch.Tensor,
                                       force_blk: torch.Tensor, cap1: int,
                                       cap2: int, l2_end: int, clean2: bool
                                       ) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor, int, int]:
    """``ro_token_replay_levels_ref`` as the CUDA kernel computes it: the
    walk never reads ``death``, ``lvl`` or ``dirty``.

    Two pointers step past each token they act on: ``b2`` (evictions,
    from 0) and ``b1`` (demotions, from ``l2_end``, since the warm-L2
    rows are born in L2).  A token p still alive by its links was evicted
    iff ``p < b2`` and sits in L1 iff ``p >= b1``, because live L1
    positions lie above every live L2 position.  The warm-L2 rows only
    fill L2 (``res2`` starts at ``l2_end``).  The dirty bits, the
    demotion flushes of a clean L2 and the victims' flushes follow in
    ``_dirty_pass``.
    """
    n = int(is_read_blk.shape[0])
    rd = is_read_blk.tolist()
    nx = nxt_blk.tolist()
    cand, live_to = _walk_inputs(rd, prev_blk.tolist(), nx)
    death = list(nx)
    lvl = [2 if t < l2_end else 1 for t in range(n)]
    demotions = 0
    res1, res2 = 0, min(max(l2_end, 0), n)
    b1, b2 = max(l2_end, 0), 0                   # next victim candidates
    for t in range(max(l2_end, 0), n):
        kept = cand[t] > b2                      # p's token not evicted
        in_l1 = cand[t] > b1
        if rd[t]:
            if kept:
                if in_l1:
                    continue                     # L1 hit: occupancy unchanged
                res2 -= 1                        # L2 hit: promote out of L2
            res1 += 1                            # install / rebirth into L1
            if res1 > cap1:
                while live_to[b1] <= t:
                    b1 += 1                      # min live L1 token
                lvl[b1] = 2                      # demote into L2's MRU
                b1 += 1
                res1 -= 1
                res2 += 1
                demotions += 1
                if res2 > cap2:
                    while live_to[b2] <= t:
                        b2 += 1                  # min live token: an L2 one
                    death[b2] = t                # evicted for good
                    b2 += 1
                    res2 -= 1
        elif in_l1:
            res1 -= 1                            # write-hit: invalidate the
        elif kept:                               # holding level (a hole)
            res2 -= 1
    dev = is_read_blk.device
    death_t = torch.tensor(death, dtype=torch.int64)
    lvl_t = torch.tensor(lvl, dtype=torch.int8)
    cleaned = ((lvl_t == 2) & (torch.arange(n) >= l2_end) if clean2
               else torch.zeros(n, dtype=torch.bool))
    dirty, flushes = _dirty_pass(
        is_read_blk.cpu(), prev_blk.cpu().long(), nxt_blk.cpu().long(),
        force_blk.cpu(), death_t, l2_end, cleaned)
    return (death_t.to(dev), dirty.to(dev), lvl_t.to(dev), flushes,
            demotions)


def _block_args(is_read, prev, nxt, force, s: int, e: int):
    """One block of the tape in local positions, on the host."""
    return (is_read[s:e].cpu(), (prev[s:e] - s).cpu(), (nxt[s:e] - s).cpu(),
            force[s:e].cpu())


def ro_token_replay_blocks_ref(is_read: torch.Tensor, prev: torch.Tensor,
                               nxt: torch.Tensor, force: torch.Tensor,
                               starts, ends, caps
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``ro_token_replay_ref`` over the blocks ``[starts[k], ends[k])`` of
    one tape (global links severed at the blocks, ``nxt`` clamped to the
    block end), block k at capacity ``caps[k]``.

    Returns ``(death, dirty, flushes)`` on the tape's device: ``death``
    (int32, local positions) and ``dirty`` (bool) of every block's rows,
    block after block, and ``flushes`` int64[K].
    """
    deaths, dirties, flushes = [], [], []
    for s, e, cap in zip(starts, ends, caps):
        d, y, f = ro_token_replay_ref(
            *_block_args(is_read, prev, nxt, force, s, e), cap)
        deaths.append(d.to(torch.int32))
        dirties.append(y)
        flushes.append(f)
    dev = is_read.device
    return (torch.cat(deaths).to(dev) if deaths
            else torch.zeros(0, dtype=torch.int32, device=dev),
            torch.cat(dirties).to(dev) if dirties
            else torch.zeros(0, dtype=torch.bool, device=dev),
            torch.tensor(flushes, dtype=torch.int64, device=dev))


def ro_token_replay_levels_blocks_ref(is_read: torch.Tensor,
                                      prev: torch.Tensor, nxt: torch.Tensor,
                                      force: torch.Tensor, starts, ends,
                                      cap1, cap2, l2_end, clean2
                                      ) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]:
    """``ro_token_replay_levels_ref`` over the blocks of one tape, block k
    at ``cap1[k]``, ``cap2[k]``, its local ``l2_end[k]`` and ``clean2[k]``.

    Returns ``(death, dirty, lvl, counts)`` on the tape's device: the
    blocks' rows block after block (``death`` int32, local positions;
    ``lvl`` int8), and ``counts`` int64[2K], the flushes of block k at k
    and its demotions at K + k.
    """
    out: list[list] = [[], [], []]
    flushes, demotions = [], []
    for s, e, c1, c2, le, cl in zip(starts, ends, cap1, cap2, l2_end,
                                    clean2):
        d, y, lv, f, m = ro_token_replay_levels_ref(
            *_block_args(is_read, prev, nxt, force, s, e), c1, c2, le, cl)
        for acc, x in zip(out, (d.to(torch.int32), y, lv)):
            acc.append(x)
        flushes.append(f)
        demotions.append(m)
    dev = is_read.device
    empty = (torch.int32, torch.bool, torch.int8)
    death, dirty, lvl = (torch.cat(acc).to(dev) if acc
                         else torch.zeros(0, dtype=dt, device=dev)
                         for acc, dt in zip(out, empty))
    return (death, dirty, lvl,
            torch.tensor(flushes + demotions, dtype=torch.int64, device=dev))


# The kernels' edge tapes (``ro_edge_tape``): "long" blocks of 65,536 and
# 66,175 rows (the paths' longest) at capacities in the thousands;
# "trail", capacities that keep the victim pointers thousands of rows
# behind t; "l2_edge", warm-L2 prefixes ending either side of 512-row
# and 1024-row edges; "many", 170 blocks (more than the card's 132 SMs),
# capacity 0 and an empty block among them; "hot", a key read every other
# row, so one read-hit chain spans the whole block.
EDGE_CASES = ("long", "trail", "l2_edge", "many", "hot")


def ro_edge_tape(case: str, levels: bool, seed: int = 0,
                 device="cpu", scale: int = 1):
    """One of ``EDGE_CASES`` as the kernels' arguments: ``((is_read, prev,
    nxt, force), starts, ends, caps)`` with int64 global links severed at
    the blocks (``nxt`` clamped to the block end) and ``caps`` ``(cap,)``
    or ``(cap1, cap2, l2_end, clean2)``, every other block with a clean
    L2.  Two-level blocks open with ``l2_end`` warm-L2 pseudo-reads of
    distinct addresses the block reads again.  ``scale`` divides every
    length and capacity (the CPU tests' small copies)."""
    rng = np.random.default_rng(seed)
    if case == "long":
        lens, cap, span = [65536, 66175], [2000, 5000], [20000, 30000]
    elif case == "trail":
        lens, cap, span = [20000, 12000], [3000, 1500], [6000, 4000]
    elif case == "l2_edge":
        lens, cap, span = [6000] * 4, [300] * 4, [3000] * 4
    elif case == "many":
        lens = [int(x) for x in rng.integers(1000, 6000, 170)]
        cap = [0, 1] + [int(x) for x in rng.integers(2, 400, 168)]
        span = [2 * c + 50 for c in cap]
    elif case == "hot":
        lens, cap, span = [65536, 40000], [64, 1000], [4000, 9000]
    else:
        raise ValueError(f"unknown edge case {case!r}")
    lens = [max(1, x // scale) for x in lens]
    if case == "many":
        lens[2] = 0                               # an empty block too
    cap = [c // scale for c in cap]
    span = [max(2, x // scale) for x in span]
    # two levels split each capacity in halves, the warm L2 filling its
    # half (or the l2_edge prefixes, which L2 is widened to hold)
    edge = case == "l2_edge"
    l2e = ([max(0, x // scale) for x in (511, 512, 513, 1025)] if edge
           else [min(c - c // 2, ln) for c, ln in zip(cap, lens)])
    if not levels:
        l2e = [0] * len(lens)
    addrs, rd, force = [], [], []
    for k, (n, sp, w) in enumerate(zip(lens, span, l2e)):
        a = rng.integers(0, sp, n)
        r = rng.random(n) < 0.85
        if case == "hot":
            a[::2], r[::2] = 0, True
        a[:w] = rng.permutation(max(sp, w))[:w]   # warm L2: distinct reads
        r[:w] = True
        addrs.append(a + (k << 32))               # blocks share no address
        rd.append(r)
        force.append(rng.random(n) < 0.3)
    addrs, rd, force = (np.concatenate(x) for x in (addrs, rd, force))
    bounds = np.concatenate([[0], np.cumsum(lens)])
    m = addrs.size
    order = np.argsort(addrs, kind="stable")
    same = addrs[order[1:]] == addrs[order[:-1]]
    prev = np.full(m, -1, np.int64)
    nxt = np.full(m, m, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    nxt[order[:-1][same]] = order[1:][same]
    nxt = np.minimum(nxt, np.repeat(bounds[1:], lens))
    tape = tuple(torch.as_tensor(x, device=device)
                 for x in (rd, prev, nxt, force))
    if levels:
        caps = ([c // 2 for c in cap],
                [c - c // 2 + (w if edge else 0) for c, w in zip(cap, l2e)],
                l2e, [bool(k % 2) for k in range(len(lens))])
    else:
        caps = (cap,)
    return tape, bounds[:-1].tolist(), bounds[1:].tolist(), caps
