"""Vectorized multi-tenant window replay — the batch simulation engine.

Port of ``repro.core.batch_sim.simulate_many`` for the single-level
hierarchy: one Δt window of **all tenants at once**, as tensor programs
over occurrence links on one device.  The engine is exact: it reproduces
the reference's hits, write hits, cache writes, flush charges, total
latency and the final LRU state.

Hit oracle (see the reference module for the derivation).  With
``prev[i]``/``nxt[j]`` the previous/next occurrence links, the stack
distance

    SD(i) = #{ j : prev[i] < j < i,  nxt[j] >= i }

decides residency for an LRU partition of ``C`` blocks that allocates on
every access (WB, WT): access ``i`` is resident iff ``prev[i] >= 0`` and
``SD(i) < C``.  The count runs in ``kernels.cache_sim.ops.stack_distances``
— the hand-written CUDA kernel on the card, the merge-tree route on the
CPU — over the whole tape at once: links are severed at tenant blocks and
``nxt`` clamped to the block end, so no hot access's interval leaves its
block.

RO (write-around) gates residency on ``is_read[prev[i]]``.  Invalidation
frees slots, so the stack property holds only while the partition never
fills: the O(n) live count ``L(t) = #{ j <= t : is_read[j], nxt[j] > t }``
is the guard, and a tenant whose ``max L`` exceeds its capacity is
replayed by the O(n) eviction-token loop ``_ro_token_replay``.

Warm cross-window state is replayed exactly by prepending the cache
content as pseudo-read accesses (LRU -> MRU) carrying their dirty flags;
the prefix is excluded from the reported stats.  Dirty chains, flush
accounting and per-tenant stats are segmented tensor reductions.

The reference's second hierarchy level (ETICA) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.profile import StageProfile, pstage
from repro_torch.core.simulator import LRUCache, SimResult
from repro_torch.core.trace import Trace
from repro_torch.core.write_policy import WritePolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_sim.ops import stack_distances

__all__ = ["padded_segment_layout", "padded_tape_links", "segment_links",
           "simulate_many"]

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


def simulate_many(traces: list[Trace], capacities=None, policies=None, *,
                  t_fast: float = 1.0, t_slow: float = 20.0,
                  t_write_bypass: float | None = None,
                  flush_cost: float = 0.0,
                  caches: list[LRUCache | None] | None = None,
                  return_window_rd: bool = False,
                  device: str | torch.device | None = None,
                  profile: StageProfile | None = None):
    """Replay one window for every tenant at once (exact, vectorized).

    When ``caches[k]`` is given its capacity wins over ``capacities[k]``,
    its warm content seeds the replay, and it is left in the exact final
    LRU state.  RO tenants whose window fails the no-eviction guard are
    replayed with the eviction-token loop.  Runs on ``device`` (default:
    the CUDA card); the traces and caches are moved there.

    With ``return_window_rd=True`` also returns, per tenant, the TRD
    sample tensor of the *window* trace (-1 at cold accesses and at
    reuses of warm-prefix blocks) — the Analyzer's reuse distances, free
    from the same counting pass; ``None`` where the tenant was not
    replayed (empty window or zero capacity).  ``profile`` times the
    stages ``tape``, ``ro_replay``, ``count`` and ``replay``.
    """
    dev = resolve_device(device)
    if t_write_bypass is None:
        t_write_bypass = 1.2 * t_fast
    T = len(traces)
    caches = caches if caches is not None else [None] * T
    if policies is None:
        policies = [WritePolicy.WB] * T
    results: list[SimResult | None] = [None] * T
    rds: list[torch.Tensor | None] = [None] * T

    vec: list[int] = []
    caps = [0] * T
    for k in range(T):
        tr, c = traces[k], caches[k]
        cap = int(c.capacity if c is not None else capacities[k])
        caps[k] = cap
        pol = policies[k]
        n = len(tr)
        if n == 0:
            results[k] = SimResult(capacity=cap, policy=pol.value)
            continue
        if cap <= 0:
            r = SimResult(capacity=cap, policy=pol.value)
            r.reads = int(tr.is_read.sum())
            r.writes = n - r.reads
            r.total_latency = r.reads * t_slow + r.writes * t_write_bypass
            results[k] = r
            continue
        vec.append(k)
    if not vec:
        return (results, rds) if return_window_rd else results
    V = len(vec)

    # ------------------------------------------------------ build the tape
    # one contiguous block per tenant: [warm prefix (pseudo-reads carrying
    # dirty flags, LRU -> MRU)] + [window accesses]
    with pstage(profile, "tape"):
        parts_addr, parts_read, parts_force = [], [], []
        starts, bodies, ends = [], [], []
        off = 0
        for k in vec:
            tr, c = traces[k], caches[k]
            if c is not None and len(c) > 0:
                paddrs, pdirty = c.state_arrays()
            else:
                paddrs = torch.zeros(0, dtype=torch.int64)
                pdirty = torch.zeros(0, dtype=torch.bool)
            npre = int(paddrs.shape[0])
            parts_addr += [paddrs.to(dev, torch.int64),
                           tr.addrs.to(dev, torch.int64)]
            parts_read += [torch.ones(npre, dtype=torch.bool, device=dev),
                           tr.is_read.to(dev, torch.bool)]
            parts_force += [pdirty.to(dev, torch.bool),
                            torch.zeros(len(tr), dtype=torch.bool,
                                        device=dev)]
            starts.append(off)
            bodies.append(off + npre)
            off += npre + len(tr)
            ends.append(off)
        orig_addr = torch.cat(parts_addr)
        is_read = torch.cat(parts_read)
        force_dirty = torch.cat(parts_force)
        m = off
        lens = torch.tensor([e - s for s, e in zip(starts, ends)],
                            dtype=torch.int64, device=dev)
        tid = torch.repeat_interleave(
            torch.arange(V, dtype=torch.int64, device=dev), lens)
        ends_a = torch.tensor(ends, dtype=torch.int64, device=dev)
        bodies_a = torch.tensor(bodies, dtype=torch.int64, device=dev)
        cap_arr = torch.tensor([caps[k] for k in vec], dtype=torch.int64,
                               device=dev)
        pol_codes = [_POLICY_CODE[policies[k]] for k in vec]
        pol_of = torch.tensor(pol_codes, dtype=torch.int64, device=dev)[tid]
        cap_of = cap_arr[tid]
        end_of = ends_a[tid]
        pos = torch.arange(m, dtype=torch.int64, device=dev)
        counted = pos >= bodies_a[tid]
        is_write = ~is_read
        # links from one stable (tenant, address) sort; the same order
        # serves the dirty-chain segmented reductions below
        prev, nxt_c, ordi, same_prev = segment_links(orig_addr, tid, end_of)

    # ------------------------------------------ RO residency: guard or tokens
    # L[t] = live read tokens after access t assuming no eviction; while
    # L <= C the partition never filled, so resident <=> live is exact.
    # Tenants exceeding the bound take the eviction-token loop.
    tokens: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}
    if 2 in pol_codes:
        with pstage(profile, "ro_replay"):
            d = (torch.bincount(pos[is_read], minlength=m + 1)
                 - torch.bincount(nxt_c[is_read], minlength=m + 1))
            L = torch.cumsum(d[:m], 0)
            lmax = torch.zeros(V, dtype=torch.int64, device=dev) \
                .scatter_reduce(0, tid, L, "amax").tolist()
            for t in range(V):
                if pol_codes[t] == 2 and lmax[t] > caps[vec[t]]:
                    s, e = starts[t], ends[t]
                    tokens[t] = _ro_token_replay(
                        is_read[s:e], prev[s:e] - s, nxt_c[s:e] - s,
                        force_dirty[s:e], caps[vec[t]])

    # -------------------------------------------------- residency oracle
    with pstage(profile, "count"):
        sd = stack_distances(prev, nxt_c)

    with pstage(profile, "replay"):
        if return_window_rd:
            # reuses of warm-prefix pseudo-accesses are cold from the
            # Analyzer's view of the window
            for t, k in enumerate(vec):
                sl = slice(bodies[t], ends[t])
                rds[k] = torch.where(prev[sl] >= bodies[t], sd[sl], -1)
        hot = prev >= 0
        prev_safe = torch.clamp(prev, min=0)
        res_sd = hot & (sd < cap_of) & (sd >= 0)
        res_ro = hot & is_read[prev_safe]
        resident = torch.where(pol_of == 2, res_ro, res_sd)
        for t, (death, _, _) in tokens.items():
            s, e = starts[t], ends[t]
            pl = prev[s:e] - s
            pls = torch.clamp(pl, min=0)
            resident[s:e] = ((pl >= 0) & is_read[s:e][pls]
                             & (death[pls] == torch.arange(e - s,
                                                           device=dev)))

        # --------------------------------------------------- dirty chains
        # group by address, segment at installs (non-resident accesses);
        # the dirty flag after each access is a segmented reduction:
        #   WB      : OR of (is_write | forced) over the period so far
        #   WT / RO : forced flag at the period head, cleared by any write
        head = ~same_prev | ~resident[ordi]
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
        # misses, or (no next occurrence) >= C distinct addresses follow
        last = nxt_c == end_of
        cl = torch.cumsum(last.to(torch.int64), 0)
        D = cl[end_of - 1] - cl
        if flush_cost > 0.0:
            nz = torch.nonzero(~last).squeeze(1)
            miss_next = torch.zeros(m, dtype=torch.bool, device=dev)
            miss_next[nz] = ~resident[nxt_c[nz]]
            evicted = torch.where(last, D >= cap_of, miss_next)
            flush_ev = dirty_after & evicted & (pol_of != 2)
            flush_per = torch.bincount(tid[flush_ev], minlength=V).tolist()
        else:
            flush_per = [0] * V
        for t, (_, _, fl) in tokens.items():    # RO evictions under pressure
            flush_per[t] += fl

        # --------------------------------------------------- per-tenant stats
        # one fused bincount: code = 8*tenant + 4*is_read + 2*hit
        code = tid * 8 + is_read.to(torch.int64) * 4 \
            + resident.to(torch.int64) * 2
        cnts = torch.bincount(code[counted], minlength=8 * V) \
            .view(V, 8).tolist()

        for t, k in enumerate(vec):
            pol = policies[k]
            cap = caps[k]
            cnt = cnts[t]
            r = SimResult(capacity=cap, policy=pol.value)
            r.reads = cnt[4] + cnt[6]
            r.read_hits = cnt[6]
            r.writes = cnt[0] + cnt[2]
            r.write_hits = cnt[2]
            rmiss = r.reads - r.read_hits
            fl = flush_per[t]
            if pol is WritePolicy.WB:
                r.cache_writes = rmiss + r.writes
                r.total_latency = (r.read_hits * t_fast + rmiss * t_slow
                                   + r.writes * t_fast + fl * flush_cost)
            else:
                # WT installs misses and writes; RO only read misses
                r.cache_writes = (rmiss + r.writes if pol is WritePolicy.WT
                                  else rmiss)
                r.total_latency = (r.read_hits * t_fast + rmiss * t_slow
                                   + r.writes * t_write_bypass
                                   + fl * flush_cost)

            # ------------------------------------------- final LRU state
            c = caches[k]
            if c is not None:
                s, e = starts[t], ends[t]
                if t in tokens:
                    death, tdirty, _ = tokens[t]
                    keep = is_read[s:e] & (death == e - s)
                    dirty_keep = tdirty[keep]
                else:
                    if pol is WritePolicy.RO:
                        keep = last[s:e] & is_read[s:e]
                    else:
                        keep = last[s:e] & (D[s:e] < cap)
                    dirty_keep = dirty_after[s:e][keep]
                js = torch.nonzero(keep).squeeze(1) + s   # LRU -> MRU
                c.set_state_arrays(orig_addr[js], dirty_keep)
            results[k] = r
    return (results, rds) if return_window_rd else results
