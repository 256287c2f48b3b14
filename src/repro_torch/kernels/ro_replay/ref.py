"""Plain versions of the RO eviction-token replays (host loops).

``ro_token_replay_ref`` and ``ro_token_replay_levels_ref`` replay one
tenant block, as the reference's ``_ro_token_replay`` and
``_ro_token_replay_levels`` (``src/repro/core/batch_sim.py:539``,
``:589``): host loops over host copies of the block, taken once (never
element-wise reads of device tensors).  ``ro_token_replay_blocks_ref``
and ``ro_token_replay_levels_blocks_ref`` are the functions the CUDA
kernels compute: the same loops over several blocks of one tape, with
the outputs laid out block after block.
"""
from __future__ import annotations

import torch

__all__ = ["ro_token_replay_blocks_ref", "ro_token_replay_levels_blocks_ref",
           "ro_token_replay_levels_ref", "ro_token_replay_ref"]


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
