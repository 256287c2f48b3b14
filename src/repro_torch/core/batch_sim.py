"""Vectorized multi-tenant window replay — the batch simulation engine.

Port of ``repro.core.batch_sim.simulate_many``: one Δt window of **all
tenants at once**, as tensor programs over occurrence links on one
device, for one cache level or the exclusive two-level (ETICA)
hierarchy.  The engine is exact: it reproduces the per-access
interpreter's (``simulator.simulate``) hits, write hits, cache writes
per level, flush charges, total latency and both levels' final LRU
states.

Hit oracle (see the reference module for the derivation).  With
``prev[i]``/``nxt[j]`` the previous/next occurrence links, the stack
distance

    SD(i) = #{ j : prev[i] < j < i,  nxt[j] >= i }

decides residency for an LRU partition of ``C`` blocks that allocates on
every access (WB, WT): access ``i`` is resident iff ``prev[i] >= 0`` and
``SD(i) < C``.  With two levels the union is one LRU stack of ``C1 + C2``
blocks whose top ``C1`` are L1 (after ``rebalance_levels``), so the same
count classifies each access twice: an L1 hit iff ``SD < C1``, an L2
hit iff ``C1 <= SD < C1 + C2``.  On a CUDA tape both masks come from one
``kernels.cache_sim.ops.residency_levels`` launch
(``cache_sim_levels_scan``); when the caller also wants the window's
reuse distances, and on the CPU, the distances come from
``ops.stack_distances`` (``cache_sim_scan`` on the card, the merge tree
on the CPU) and are compared with the two thresholds.  Links are severed
at tenant blocks and ``nxt`` clamped to the block end, so one call
counts the whole tape.

RO (write-around) gates residency on ``is_read[prev[i]]``.  Invalidation
frees slots, so the stack property holds only while a level never
fills: the live count ``L(t) = #{ j <= t : is_read[j], nxt[j] > t }``
(``ops.ro_live_counts``: ``live_count_scan`` on the card) is the guard,
less ``U2``, the still-untouched warm-L2 blocks, when both levels are
live.  A tenant over the bound is replayed by an O(n) eviction-token
host loop: ``_ro_token_replay`` for one level, ``_ro_token_replay_levels``
(tokens carry their level) for two.

Warm cross-window state is replayed exactly by prepending the cache
content as pseudo-read accesses — warm L2 then warm L1, each LRU -> MRU,
the union stack — carrying their dirty flags; the prefix is excluded
from the reported stats.  Dirty chains, flush accounting and per-tenant
stats are segmented tensor reductions.  A clean L2 (``policy2 != WB``)
segments dirty chains at L1 exits and flushes at the L1 threshold.  The
per-access interpreter replays only degenerate windows (an empty window
with two levels, or warm L2 behind a dead ``C2 <= 0`` level), counted
by ``SimResult.fallback``.

``reuse_distances_fast`` is the same count for one trace, as an
``RDResult``: the vectorized drop-in for the Fenwick oracle
``reuse_distance.reuse_distances``.
"""
from __future__ import annotations

import torch

from repro_torch.core.profile import StageProfile, pstage
from repro_torch.core.reuse_distance import RDResult, _check_kind
from repro_torch.core.simulator import (LRUCache, SimResult,
                                       rebalance_levels, simulate)
from repro_torch.core.trace import Trace, prev_next_occurrence
from repro_torch.core.write_policy import WritePolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_sim.ops import (
    residency_levels, ro_live_counts, stack_distances as _link_distances)

__all__ = ["padded_segment_layout", "padded_tape_links",
           "reuse_distances_fast", "segment_links", "simulate_batch",
           "simulate_many", "stack_distances"]

_POLICY_CODE = {WritePolicy.WB: 0, WritePolicy.WT: 1, WritePolicy.RO: 2}
# every padded segment width is a power of two and at least this wide
_PAD_MIN = 64


def segment_links(addrs: torch.Tensor, tid: torch.Tensor,
                  end_of: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Occurrence links on a multi-tenant tape, severed at tenant blocks.

    ``tid`` is non-decreasing (one contiguous block per tenant) and
    ``end_of[i]`` is the end of position i's block.  Returns ``(prev,
    nxt_c, order, same)``: ``prev[i]`` the previous occurrence of the
    address inside the block (-1 if none), ``nxt_c[j]`` the next one
    clamped to the block end, ``order`` the stable (tenant, address,
    position) sort order, ``same[k]`` whether sorted entry k continues
    entry k-1's address run.
    """
    m = addrs.shape[0]
    dev = addrs.device
    order = torch.sort(addrs, stable=True).indices
    order = order[torch.sort(tid[order], stable=True).indices]
    sa, st = addrs[order], tid[order]
    same = torch.zeros(m, dtype=torch.bool, device=dev)
    same[1:] = (sa[1:] == sa[:-1]) & (st[1:] == st[:-1])
    prev = torch.full((m,), -1, dtype=torch.int64, device=dev)
    prev[order[1:]] = torch.where(same[1:], order[:-1], -1)
    nxt = torch.full((m,), m, dtype=torch.int64, device=dev)
    nxt[order[:-1]] = torch.where(same[1:], order[1:], m)
    return prev, torch.minimum(nxt, end_of), order, same


def stack_distances(trace: Trace) -> torch.Tensor:
    """Per-access LRU stack distances (TRD samples at every re-touch, -1
    at cold accesses), int64 on the trace's device: the hand-written
    ``cache_sim_scan`` on the card, the merge-tree route on the CPU (the
    reference's ``batch_sim.stack_distances``, whose ``backend`` string
    the trace's device replaces)."""
    prev, nxt = prev_next_occurrence(trace.addrs.to(torch.int64))
    return _link_distances(prev, nxt)


def reuse_distances_fast(trace: Trace, kind: str = "urd") -> RDResult:
    """Reuse distances of one trace from the stack-distance count
    (``stack_distances``, on the trace's device): the same integers as
    the Fenwick oracle, with no per-access loop."""
    _check_kind(kind)
    sd = stack_distances(trace)
    if kind == "urd":
        sd = torch.where(trace.is_read.to(torch.bool), sd, -1)
    return RDResult(sd, kind)


def padded_segment_layout(bounds, device: str | torch.device | None = None):
    """Segment-aligned power-of-two padding for a multi-segment tape.

    Each non-empty segment of ``bounds`` is padded to the next power of
    two (at least ``_PAD_MIN``) and the padded segments are laid out in
    descending width order (stable among equal widths).  Prefix sums of
    descending powers of two are multiples of every following width, so
    every segment starts at a multiple of its own padded width.

    Returns ``(src, tpos, base_src, base_pad, widths, total, starts)`` as
    the reference's ``padded_segment_layout`` does, with int64 tensors on
    ``device`` (default: the device of ``bounds``): ``src`` the original
    tape positions of the real entries in layout order (``None`` when
    that is ``arange``: tape order kept and no empty segment), ``tpos``
    their padded positions, ``base_src``/``base_pad`` each entry's
    original and padded segment start, ``widths`` the padded widths
    (descending), ``total`` the padded length and ``starts`` each laid
    out segment's original start.  The arithmetic is on the host: one
    integer per segment.
    """
    bt = torch.as_tensor(bounds)
    dev = torch.device(device) if device is not None else bt.device
    b = [int(x) for x in bt.tolist()]
    i64 = dict(dtype=torch.int64, device=dev)
    lens = [b[k + 1] - b[k] for k in range(len(b) - 1)]
    act = [k for k, ln in enumerate(lens) if ln > 0]
    if not act:
        z = torch.zeros(0, **i64)
        return z, z, z, z, z, 0, z
    W = [max(1 << (lens[k] - 1).bit_length(), _PAD_MIN) for k in act]
    order = sorted(range(len(act)), key=lambda q: -W[q])   # stable
    Ws = [W[q] for q in order]
    Ls = [lens[act[q]] for q in order]
    seg_starts = [b[act[q]] for q in order]
    row_base, csl = [0], [0]
    for wd, ln in zip(Ws[:-1], Ls[:-1]):
        row_base.append(row_base[-1] + wd)
        csl.append(csl[-1] + ln)
    Ls_t = torch.tensor(Ls, **i64)
    k = sum(Ls)
    loc = torch.arange(k, **i64) - torch.repeat_interleave(
        torch.tensor(csl, **i64), Ls_t)
    base_src = torch.repeat_interleave(torch.tensor(seg_starts, **i64), Ls_t)
    base_pad = torch.repeat_interleave(torch.tensor(row_base, **i64), Ls_t)
    identity = (len(act) == len(lens) and b[0] == 0
                and all(x >= y for x, y in zip(W[:-1], W[1:])))
    src = None if identity else base_src + loc
    return (src, base_pad + loc, base_src, base_pad, torch.tensor(Ws, **i64),
            sum(Ws), torch.tensor(seg_starts, **i64))


def padded_tape_links(prev: torch.Tensor, nxt: torch.Tensor, layout
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter severed/clamped occurrence links onto the padded tape.

    ``prev``/``nxt`` live on the original multi-segment tape (links
    severed at segment boundaries, ``nxt`` clamped to the segment end);
    ``layout`` is its ``padded_segment_layout``.  Returns ``(gprev, gnxt,
    gocc)`` on the padded tape: real entries carry their links shifted
    into padded coordinates, pad rows the cold, non-occupying sentinels
    (``gprev = -1``, self-``gnxt``, ``gocc = 0``), which add nothing to
    any in-segment count.
    """
    src, tpos, base_src, base_pad, _, total, _ = layout
    dev = prev.device
    if src is None:                              # layout kept tape order
        src = torch.arange(prev.shape[0], dtype=torch.int64, device=dev)
    ps = prev[src]
    gprev = torch.full((total,), -1, dtype=torch.int64, device=dev)
    gprev[tpos] = torch.where(ps >= 0, tpos - src + ps, -1)
    gnxt = torch.arange(total, dtype=torch.int64, device=dev)
    gnxt[tpos] = base_pad + (nxt[src] - base_src)
    gocc = torch.zeros(total, dtype=torch.int32, device=dev)
    gocc[tpos] = 1
    return gprev, gnxt, gocc


def _ro_token_replay(is_read_blk: torch.Tensor, prev_blk: torch.Tensor,
                     nxt_blk: torch.Tensor, force_blk: torch.Tensor,
                     cap: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Exact RO (write-around) replay under capacity pressure, O(n).

    A host loop over host copies of the tenant's block, taken once per
    tenant (never element-wise reads of device tensors), as the
    reference's ``_ro_token_replay``: every read
    position ``j`` is a cache-slot token alive on ``(j, nxt[j])``; a
    miss that overflows the partition evicts the minimum live token,
    which is non-decreasing over time, so one forward pointer suffices.
    Access ``i`` then hits iff its previous occurrence ``p`` was a read
    whose token survived to its natural death (``death[p] == i``).

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


def _ro_token_replay_levels(is_read_blk: torch.Tensor, prev_blk: torch.Tensor,
                            nxt_blk: torch.Tensor, force_blk: torch.Tensor,
                            cap1: int, cap2: int, l2_end: int, clean2: bool
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, int, int]:
    """Exact two-level RO replay under eviction pressure, O(n).

    The eviction-token loop of ``_ro_token_replay`` with a level per
    token, as the reference's ``_ro_token_replay_levels``: recency within
    a level is token-position order; a demotion moves L1's minimum live
    token (forward pointer ``b1``, skipping demoted tokens) into L2; an
    L2 overflow evicts the lowest live token (``b2``; always an L2 one,
    since live L1 positions sit above every live L2 position).  An
    invalidation frees a slot in whichever level holds the token; the
    next install fills the hole without demoting.  ``clean2`` flushes a
    dirty victim at the demotion instead of at its final eviction.
    Positions below ``l2_end`` are the warm-L2 pseudo-reads, born in L2.
    A host loop over host copies of the block, taken once.

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


def simulate_many(traces: list[Trace], capacities=None, policies=None, *,
                  t_fast: float = 1.0, t_slow: float = 20.0,
                  t_write_bypass: float | None = None,
                  flush_cost: float = 0.0,
                  caches: list[LRUCache | None] | None = None,
                  capacities2=None, policies2=None,
                  caches2: list[LRUCache | None] | None = None,
                  t_fast2: float | None = None,
                  return_window_rd: bool = False,
                  device: str | torch.device | None = None,
                  profile: StageProfile | None = None):
    """Replay one window for every tenant at once (exact, vectorized).

    When ``caches[k]`` is given its capacity wins over ``capacities[k]``,
    its warm content seeds the replay, and it is left in the exact final
    LRU state; the same holds per level for ``caches2``/``capacities2``
    (the second level, with ``policies2`` and service time ``t_fast2``,
    default ``3 * t_fast``).  RO tenants whose window fails the
    no-eviction guard are replayed with the eviction-token loops.
    Degenerate two-level windows go through ``simulate`` and are flagged
    with ``SimResult.fallback = 1``.  Runs on ``device`` (default: the
    CUDA card); the traces and caches are moved there.

    With ``return_window_rd=True`` also returns, per tenant, the TRD
    sample tensor of the *window* trace (-1 at cold accesses and at
    reuses of warm-prefix blocks) — the Analyzer's reuse distances, free
    from the same counting pass; ``None`` where the tenant was not
    replayed on the tape.  ``profile`` times the stages ``tape``,
    ``ro_replay``, ``count`` and ``replay``.
    """
    dev = resolve_device(device)
    if t_write_bypass is None:
        t_write_bypass = 1.2 * t_fast
    if t_fast2 is None:
        t_fast2 = 3.0 * t_fast
    T = len(traces)
    caches = caches if caches is not None else [None] * T
    caches2 = caches2 if caches2 is not None else [None] * T
    if policies is None:
        policies = [WritePolicy.WB] * T
    if policies2 is None:
        policies2 = [WritePolicy.WB] * T
    results: list[SimResult | None] = [None] * T
    rds: list[torch.Tensor | None] = [None] * T

    def run_interp(k: int) -> SimResult:
        """Exact per-tenant replay through the interpreter (degenerate)."""
        r = simulate(traces[k], caps1[k], policies[k], t_fast, t_slow,
                     t_write_bypass=t_write_bypass, flush_cost=flush_cost,
                     cache=caches[k], capacity2=caps2[k],
                     policy2=policies2[k], t_fast2=t_fast2,
                     cache2=caches2[k])
        r.fallback = 1
        return r

    vec: list[int] = []
    caps1 = [0] * T
    caps2 = [0] * T
    for k in range(T):
        tr, c, c2 = traces[k], caches[k], caches2[k]
        cap = int(c.capacity if c is not None else capacities[k])
        cap2 = int(c2.capacity if c2 is not None else
                   (capacities2[k] if capacities2 is not None else 0))
        caps1[k], caps2[k] = cap, cap2
        pol = policies[k]
        two = cap2 > 0 or (c2 is not None and len(c2) > 0)
        n = len(tr)
        if n == 0:
            # rebalance/flush side effects still run with two levels
            results[k] = (run_interp(k) if two
                          else SimResult(capacity=cap, policy=pol.value))
            continue
        if cap <= 0 and not two:
            r = SimResult(capacity=cap, policy=pol.value)
            r.reads = int(tr.is_read.sum())
            r.writes = n - r.reads
            r.total_latency = r.reads * t_slow + r.writes * t_write_bypass
            results[k] = r
            continue
        if two and cap2 <= 0:        # warm L2 behind a dead level
            results[k] = run_interp(k)
            continue
        vec.append(k)
    if not vec:
        return (results, rds) if return_window_rd else results
    V = len(vec)

    # ------------------------------------------------------ build the tape
    # one contiguous block per tenant: [warm L2 prefix][warm L1 prefix]
    # (pseudo-reads carrying dirty flags, each LRU -> MRU: the union
    # stack) + [window accesses]
    with pstage(profile, "tape"):
        # restore "L1 full or L2 empty" before reading warm state
        for k in vec:
            c, c2 = caches[k], caches2[k]
            if c is not None and c2 is not None and len(c2) > 0:
                rebalance_levels(c, c2)
        empty = (torch.zeros(0, dtype=torch.int64),
                 torch.zeros(0, dtype=torch.bool))
        parts_addr, parts_read, parts_force = [], [], []
        starts, l2_ends, bodies, ends = [], [], [], []
        off = 0
        for k in vec:
            tr, c, c2 = traces[k], caches[k], caches2[k]
            paddrs2, pdirty2 = (c2.state_arrays()
                                if c2 is not None and len(c2) > 0 else empty)
            paddrs, pdirty = (c.state_arrays()
                              if c is not None and len(c) > 0 else empty)
            npre2, npre = int(paddrs2.shape[0]), int(paddrs.shape[0])
            parts_addr += [paddrs2.to(dev, torch.int64),
                           paddrs.to(dev, torch.int64),
                           tr.addrs.to(dev, torch.int64)]
            parts_read += [torch.ones(npre2 + npre, dtype=torch.bool,
                                      device=dev),
                           tr.is_read.to(dev, torch.bool)]
            parts_force += [pdirty2.to(dev, torch.bool),
                            pdirty.to(dev, torch.bool),
                            torch.zeros(len(tr), dtype=torch.bool,
                                        device=dev)]
            starts.append(off)
            l2_ends.append(off + npre2)
            bodies.append(off + npre2 + npre)
            off += npre2 + npre + len(tr)
            ends.append(off)
        orig_addr = torch.cat(parts_addr)
        is_read = torch.cat(parts_read)
        force_dirty = torch.cat(parts_force)
        m = off
        i64 = dict(dtype=torch.int64, device=dev)
        lens = torch.tensor([e - s for s, e in zip(starts, ends)], **i64)

        def per_access(values) -> torch.Tensor:
            """A per-tenant list as a per-access tensor on the tape."""
            return torch.repeat_interleave(torch.tensor(values, **i64), lens)

        tid = per_access(list(range(V)))
        cap1_l = [caps1[k] for k in vec]
        cap2_l = [caps2[k] for k in vec]
        cap1_of = per_access(cap1_l)
        captot_of = per_access([a + b for a, b in zip(cap1_l, cap2_l)])
        pol_codes = [_POLICY_CODE[policies[k]] for k in vec]
        pol_of = per_access(pol_codes)
        clean2_l = [policies2[k] is not WritePolicy.WB and caps2[k] > 0
                    and caps1[k] > 0 for k in vec]
        clean2_of = per_access(clean2_l).bool()
        # hit-level boundary: hits whose previous occurrence precedes it
        # are L2 hits (RO path); when L1 has no capacity L2 *is* the level
        l2b_l = [e2 if c1 > 0 else m for e2, c1 in zip(l2_ends, cap1_l)]
        l2b_of = per_access(l2b_l)
        l2end_of = per_access(l2_ends)          # true warm-L2 boundary
        end_of = per_access(ends)
        pos = torch.arange(m, **i64)
        counted = pos >= per_access(bodies)
        is_write = ~is_read
        # links from one stable (tenant, address) sort; the same order
        # serves the dirty-chain segmented reductions below
        prev, nxt_c, ordi, same_prev = segment_links(orig_addr, tid, end_of)

        # a clean L2 flushes its warm dirty content up front; the tape
        # forgets those flags, so the token replays, dirty chains and
        # final state all see a clean L2
        flush_pre = [0] * V
        if any(clean2_l):
            pre = force_dirty & clean2_of & (pos < l2end_of)
            flush_pre = torch.bincount(tid[pre], minlength=V).tolist()
            force_dirty = force_dirty & ~pre

    # --------------------------------------- RO residency: guard or tokens
    # L[t] = live blocks after access t assuming no eviction, less (with
    # both levels live) U2[t], the still-untouched warm-L2 blocks.  While
    # that stays <= C1 (or C1 + C2 where L2 is the only level) no level
    # ever filled, so resident <=> live is exact; tenants over it take the
    # eviction-token loops.
    tokens: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}
    tokens2: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             int, int]] = {}
    if 2 in pol_codes:
        with pstage(profile, "ro_replay"):
            L = ro_live_counts(nxt_c, is_read)
            both = [c1 > 0 and c2 > 0 for c1, c2 in zip(cap1_l, cap2_l)]
            if any(e2 > s for s, e2 in zip(starts, l2_ends)) and any(both):
                U2 = ro_live_counts(nxt_c, pos < l2end_of)
                L = L - torch.where(per_access(both).bool(), U2, 0)
            lmax = torch.zeros(V, **i64).scatter_reduce(
                0, tid, L, "amax").tolist()
            for t in range(V):
                if pol_codes[t] != 2:
                    continue
                c1, c2 = cap1_l[t], cap2_l[t]
                ro_cap = c1 if c1 > 0 else c1 + c2
                if lmax[t] <= ro_cap:
                    continue
                s, e = starts[t], ends[t]
                blk = (is_read[s:e], prev[s:e] - s, nxt_c[s:e] - s,
                       force_dirty[s:e])
                if both[t]:
                    tokens2[t] = _ro_token_replay_levels(
                        *blk, c1, c2, l2_ends[t] - s, clean2_l[t])
                else:
                    tokens[t] = _ro_token_replay(*blk, ro_cap)

    # -------------------------------------------------- residency oracle
    hot = prev >= 0
    with pstage(profile, "count"):
        if dev.type == "cuda" and not return_window_rd:
            # both levels' residency straight off the kernel, one launch
            res_l1_sd, res_un_sd = residency_levels(prev, nxt_c, cap1_of,
                                                    captot_of)
        else:
            sd = _link_distances(prev, nxt_c)
            res_l1_sd = hot & (sd < cap1_of) & (sd >= 0)
            res_un_sd = hot & (sd < captot_of) & (sd >= 0)

    with pstage(profile, "replay"):
        if return_window_rd:
            # reuses of warm-prefix pseudo-accesses are cold from the
            # Analyzer's view of the window
            for t, k in enumerate(vec):
                sl = slice(bodies[t], ends[t])
                rds[k] = torch.where(prev[sl] >= bodies[t], sd[sl], -1)
        prev_safe = torch.clamp(prev, min=0)
        res_ro = hot & is_read[prev_safe]
        resident = torch.where(pol_of == 2, res_ro, res_un_sd)
        for t, rec in list(tokens.items()) + list(tokens2.items()):
            death = rec[0]
            s, e = starts[t], ends[t]
            pl = prev[s:e] - s
            pls = torch.clamp(pl, min=0)
            resident[s:e] = ((pl >= 0) & is_read[s:e][pls]
                             & (death[pls] == torch.arange(e - s,
                                                           device=dev)))
        # split hits by level: WB/WT against the two stack thresholds, RO
        # by whether the previous occurrence is a still-untouched warm-L2
        # block — or, under pressure, by the level the token died in
        res_l2 = torch.where(pol_of == 2, resident & (prev_safe < l2b_of),
                             resident & ~res_l1_sd)
        for t, (_, _, lv, _, _) in tokens2.items():
            s, e = starts[t], ends[t]
            pls = torch.clamp(prev[s:e] - s, min=0)
            res_l2[s:e] = resident[s:e] & (lv[pls] == 2)
        res_l1 = resident & ~res_l2

        # --------------------------------------------------- dirty chains
        # group by address, segment at installs (non-resident accesses;
        # for a clean L2 at L1 exits, since a demotion flushes the block
        # and it comes back clean); the dirty flag after each access is a
        # segmented reduction:
        #   WB      : OR of (is_write | forced) over the period so far
        #   WT / RO : forced flag at the period head, cleared by any write
        chain_res = torch.where(clean2_of & (pol_of != 2), res_l1, resident)
        head = ~same_prev | ~chain_res[ordi]
        head_pos = torch.cummax(torch.where(head, pos, -1), 0).values
        w_wb = (is_write | force_dirty)[ordi].to(torch.int64)
        cw_wb = torch.cumsum(w_wb, 0)
        dirty_wb_s = (cw_wb - cw_wb[head_pos] + w_wb[head_pos]) > 0
        if bool(force_dirty.any()) and any(p != 0 for p in pol_codes):
            w_any = is_write[ordi].to(torch.int64)
            cw_any = torch.cumsum(w_any, 0)
            seg_writes = cw_any - cw_any[head_pos] + w_any[head_pos]
            dirty_chain_s = force_dirty[ordi][head_pos] & (seg_writes == 0)
        else:
            # WT/RO blocks can only be dirty via warm-prefix flags
            dirty_chain_s = torch.zeros(m, dtype=torch.bool, device=dev)
        dirty_after = torch.empty(m, dtype=torch.bool, device=dev)
        dirty_after[ordi] = torch.where(pol_of[ordi] == 0, dirty_wb_s,
                                        dirty_chain_s)

        # ----------------------------------------------- flush accounting
        # the block last touched at j is evicted iff its next occurrence
        # misses, or (no next occurrence) >= C distinct addresses follow;
        # with a dirty-accepting L2 the flush is at the union eviction,
        # with a clean L2 at the L1 exit (the C1 threshold)
        last = nxt_c == end_of
        cl = torch.cumsum(last.to(torch.int64), 0)
        D = cl[end_of - 1] - cl
        if flush_cost > 0.0:
            flushcap_of = torch.where(clean2_of & (pol_of != 2), cap1_of,
                                      captot_of)
            nz = torch.nonzero(~last).squeeze(1)
            miss_next = torch.zeros(m, dtype=torch.bool, device=dev)
            miss_next[nz] = ~chain_res[nxt_c[nz]]
            evicted = torch.where(last, D >= flushcap_of, miss_next)
            flush_ev = dirty_after & evicted & (pol_of != 2)
            flush_per = torch.bincount(tid[flush_ev], minlength=V).tolist()
        else:
            flush_per = [0] * V
        flush_per = [a + b for a, b in zip(flush_per, flush_pre)]
        for t, (_, _, fl) in tokens.items():    # RO evictions under pressure
            flush_per[t] += fl
        for t, (_, _, _, fl, _) in tokens2.items():  # incl. demotion flushes
            flush_per[t] += fl

        # --------------------------------------------------- per-tenant stats
        # one fused bincount: code = 8*tenant + 4*is_read + level
        # (level: 0 = miss, 1 = L2 hit, 2 = L1 hit)
        lvl = res_l1.to(torch.int64) * 2 + res_l2.to(torch.int64)
        code = tid * 8 + is_read.to(torch.int64) * 4 + lvl
        cnts = torch.bincount(code[counted], minlength=8 * V) \
            .view(V, 8).tolist()
        # distinct union addresses per tenant block -> closed-form demotions
        U_per = torch.bincount(tid[last], minlength=V).tolist()

        for t, k in enumerate(vec):
            pol = policies[k]
            cap1, cap2 = cap1_l[t], cap2_l[t]
            captot = cap1 + cap2
            cnt = cnts[t]
            r = SimResult(capacity=cap1, policy=pol.value, capacity2=cap2,
                          policy2=(policies2[k].value if cap2 > 0
                                   else "wb"))
            r.reads = cnt[4] + cnt[5] + cnt[6]
            r.read_hits = cnt[6]
            r.read_hits_l2 = cnt[5]
            r.writes = cnt[0] + cnt[1] + cnt[2]
            r.write_hits = cnt[2]
            r.write_hits_l2 = cnt[1]
            l2h = r.read_hits_l2
            rmiss = r.reads - r.read_hits - l2h
            fl = flush_per[t]
            if pol is WritePolicy.WB:
                if cap1 > 0:
                    r.cache_writes = rmiss + l2h + r.writes
                    r.total_latency = (r.read_hits * t_fast + rmiss * t_slow
                                       + r.writes * t_fast + fl * flush_cost)
                elif captot > 0:
                    r.cache_writes_l2 = rmiss + r.writes
                    r.total_latency = (rmiss * t_slow + r.writes * t_fast2
                                       + fl * flush_cost)
                else:
                    r.total_latency = (rmiss * t_slow
                                       + r.writes * t_write_bypass)
            elif pol is WritePolicy.WT:
                if cap1 > 0:
                    r.cache_writes = rmiss + l2h + r.writes
                elif captot > 0:
                    r.cache_writes_l2 = rmiss + r.writes
                r.total_latency = (r.read_hits * t_fast + rmiss * t_slow
                                   + r.writes * t_write_bypass
                                   + fl * flush_cost)
            else:
                if cap1 > 0:
                    r.cache_writes = rmiss + l2h  # installs + promotions
                    if t in tokens2:              # demotions under pressure
                        r.cache_writes_l2 = tokens2[t][4]
                elif captot > 0:
                    r.cache_writes_l2 = rmiss
                r.total_latency = (r.read_hits * t_fast + rmiss * t_slow
                                   + r.writes * t_write_bypass
                                   + fl * flush_cost)
            if l2h:
                r.total_latency += l2h * t_fast2
            if cap1 > 0 and cap2 > 0 and pol is not WritePolicy.RO:
                # every install into a full L1 demotes its victim into L2
                installs = (r.reads - r.read_hits) + (r.writes - r.write_hits)
                final_l1 = min(U_per[t], cap1)
                init_l1 = bodies[t] - l2_ends[t]
                r.cache_writes_l2 = installs - (final_l1 - init_l1)

            # ------------------------------------------- final LRU state
            c, c2v = caches[k], caches2[k]
            if c is not None or c2v is not None:
                s, e = starts[t], ends[t]
                surv_lvl = None
                if t in tokens or t in tokens2:
                    rec = tokens[t] if t in tokens else tokens2[t]
                    death, tdirty = rec[0], rec[1]
                    keep = is_read[s:e] & (death == e - s)
                    dirty_keep = tdirty[keep]
                    if t in tokens2:
                        surv_lvl = rec[2][keep]
                else:
                    if pol is WritePolicy.RO:
                        keep = last[s:e] & is_read[s:e]
                    else:
                        keep = last[s:e] & (D[s:e] < captot)
                    dirty_keep = dirty_after[s:e][keep]
                js = torch.nonzero(keep).squeeze(1) + s   # LRU -> MRU
                if cap2 <= 0 and (c2v is None or len(c2v) == 0):
                    if c is not None:
                        c.set_state_arrays(orig_addr[js], dirty_keep)
                else:
                    # split the union survivor stack at depth C1 (WB/WT),
                    # by warm-L2 pseudo position (RO: untouched blocks
                    # stay in L2), or by the surviving token's level
                    if surv_lvl is not None:
                        in_l2 = surv_lvl == 2
                    elif pol is WritePolicy.RO:
                        in_l2 = js < l2b_l[t]
                    else:
                        nj = int(js.shape[0])
                        in_l2 = torch.arange(nj, device=dev) \
                            < nj - min(cap1, nj)
                    if c is not None:
                        c.set_state_arrays(orig_addr[js[~in_l2]],
                                           dirty_keep[~in_l2])
                    if c2v is not None:
                        d2k = dirty_keep[in_l2]
                        if clean2_l[t]:
                            d2k = torch.zeros_like(d2k)
                        c2v.set_state_arrays(orig_addr[js[in_l2]], d2k)
            results[k] = r
    return (results, rds) if return_window_rd else results


def simulate_batch(trace: Trace, capacity: int,
                   policy: WritePolicy = WritePolicy.WB,
                   t_fast: float = 1.0, t_slow: float = 20.0,
                   t_write_bypass: float | None = None,
                   flush_cost: float = 0.0,
                   cache: LRUCache | None = None, *,
                   capacity2: int = 0,
                   policy2: WritePolicy = WritePolicy.WB,
                   t_fast2: float | None = None,
                   cache2: LRUCache | None = None,
                   device: str | torch.device | None = None) -> SimResult:
    """Vectorized drop-in for ``simulator.simulate`` (one tenant)."""
    return simulate_many([trace], [capacity], [policy], t_fast=t_fast,
                         t_slow=t_slow, t_write_bypass=t_write_bypass,
                         flush_cost=flush_cost, caches=[cache],
                         capacities2=[capacity2], policies2=[policy2],
                         caches2=[cache2], t_fast2=t_fast2,
                         device=device)[0]
