"""Device-resident Δt window pipeline: count → curve → write ratio →
partition on one device, with double-buffered window ingest.

Port of ``repro.core.device_pipeline``.  The fused host monitor
(``core.monitor``) builds its tape and reduces it through host-visible
steps; this module keeps the whole window decision on the device:

  * **Ingest** (``ingest_window``): the host knows only the per-tenant
    lengths.  From them it plans the padded, self-aligned layout
    (``batch_sim.padded_plan``); the shape key is ``(width groups,
    tenants, sampled, kind)``.  The raw tape crosses to the card from
    pinned memory on a side stream (``non_blocking``), so window t+1's
    copy overlaps window t's work; the occurrence links, the padded
    tape (``padded_segment_layout``, ``padded_tape_links``) and every
    per-row vector are then built on the card, with nothing read back.
  * **The stages** (plain torch functions on one device, queued with no
    host sync between dispatch and fetch): ``count_stage`` (the
    segment-restricted SD, ``ops.segment_counts_device``: one
    ``cache_sim_segments_scan`` launch per width group on the card),
    ``curve_stage`` (a row-local sort and run-length reduction into a
    stacked-breakpoint curve store: tenant i's breakpoints live at
    ``[row_start[i], row_start[i] + k[i])`` of the padded tape),
    ``wr_stage`` (Alg. 3 write ratios, one ``index_add``) and
    ``partition_stage`` (the ``method="fast"`` envelope-scan greedy walk,
    ``walk``: a row-local prefix-min envelope, two stable sorts for the
    ``(-envelope, tenant, rank)`` merge, a prefix sum for the budget cut
    and the partial grant; ``eval_at`` for the hit ratios).  Scatters
    that drop out-of-range rows write into one trash slot past the end,
    then slice it off.
  * **One sync a window** (``_fetch``): one non-blocking copy of every
    output into pinned host tensors, then one event synchronize, counted
    by ``StageProfile.sync``.  ``transfer_sanitizer`` runs the dispatch
    under ``torch.cuda.set_sync_debug_mode("error")``: any hidden sync
    there raises.  The sampled branch of ``analyze_windows`` reads the
    kept lengths once before ingest (the layout depends on them).
  * **Bit parity.**  Everything is int64 / float64 on every device (the
    reference's f64 mode, which its host path pins), every division is
    by a tensor on the same device, and rounding is half to even: every
    per-tenant output (curve edges and heights, URD sizes, write ratios,
    allocations, hit ratios) is bit-identical to the host path, on the
    CPU and on the card.  The aggregate latency is a sum whose order
    differs; compare it to rel 1e-12.

``monitor_window_device`` backs ``analyze_windows(pipeline="device")``;
``DeviceWindowPipeline`` adds the partition stage and the
double-buffered ``run_stream``; ``greedy_walk_device`` runs the walk for
``greedy_allocate(method="device")`` on a curve store padded to a power
of two per tenant.  ``monitor_window_device``'s ``launch_hook`` (fault
injection: host Python, called after ingest, right before the dispatch,
never inside the sanitized region) lets the manager's degradation ladder
kill a device-rung launch.  The stages run eagerly: a CUDA graph per
shape bucket is performance work (ROADMAP).  The sharded pipeline
(``mesh=``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.batch_sim import (padded_plan, padded_segment_layout,
                                        padded_tape_links, segment_links)
from repro_torch.core.mrc import BatchedHitRatioFunctions
from repro_torch.core.profile import StageProfile, pstage
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.cache_sim.ops import (segment_counts_device,
                                               width_groups_of)

__all__ = ["DeviceWindowPipeline", "StageProfile", "WindowDecision",
           "WindowIngest", "count_stage", "curve_stage", "eval_at",
           "greedy_walk_device", "ingest_window", "monitor_window_device",
           "partition_stage", "transfer_sanitizer", "walk", "wr_stage"]

_I64, _F64 = torch.int64, torch.float64
_SENT = 1 << 62                 # above every real sample + 1


@contextlib.contextmanager
def transfer_sanitizer(enabled: bool = True,
                       device: str | torch.device | None = None):
    """Runtime teeth for the no-hidden-sync window contract.

    Entered around a window's dispatch, ``torch.cuda.set_sync_debug_mode
    ("error")`` makes every synchronizing operation raise — a stray
    ``.item()``, ``.tolist()``, ``int()``/``float()`` of a device value,
    a boolean-mask index, ``nonzero``, ``repeat_interleave`` without
    ``output_size`` or a copy from pageable host memory — instead of
    stalling the host unseen; the previous mode comes back on exit.  The
    window's one permitted sync, the fetch, runs outside it.  A no-op
    when ``enabled`` is false and on the CPU (``device``, default the
    card when one is visible).
    """
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if not (enabled and on_card):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ------------------------------------------------------------------- ingest
@dataclasses.dataclass
class WindowIngest:
    """One window's device-resident tape and its host-side metadata.

    ``key`` is the shape bucket ``(width groups, n_tenants, sampled,
    kind)``, from the host-side lengths alone; ``dev`` holds the tensors
    on ``device``.  ``row_start`` and ``n_acc`` (int64[n], on the host)
    unpack the fetched curve store.
    """

    key: tuple
    dev: dict
    n: int
    total: int
    device: torch.device
    row_start: torch.Tensor
    n_acc: torch.Tensor

    @property
    def wg(self) -> tuple:
        return self.key[0]


_COPY_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _upload(xs: list[torch.Tensor], dev: torch.device) -> list[torch.Tensor]:
    """Host tensors to the card on a side stream, from pinned memory,
    without waiting for it; the current stream waits for the copies
    before it uses them.  Tensors already on ``dev`` stay; on the CPU this
    is ``.to``."""
    if dev.type != "cuda":
        return [x.to(dev) for x in xs]
    cur = torch.cuda.current_stream(dev)
    side = _COPY_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
    out = []
    with torch.cuda.stream(side):
        for x in xs:
            out.append(x.pin_memory().to(dev, non_blocking=True)
                       if x.device.type == "cpu" else x.to(dev))
    cur.wait_stream(side)
    for y in out:
        y.record_stream(cur)
    return out


def ingest_window(addrs: torch.Tensor, is_read: torch.Tensor, bounds,
                  n_accesses, *, rates=None, kind: str = "urd",
                  profile: StageProfile | None = None,
                  device: str | torch.device | None = None
                  ) -> WindowIngest | None:
    """Lay one window out on ``device`` (default: the card).

    ``bounds`` are the per-tenant segment offsets of the (possibly
    SHARDS-filtered) tape ``addrs``/``is_read`` and ``n_accesses`` the
    full window lengths (the curve denominators), both host integers;
    ``rates`` the per-tenant SHARDS rates (host floats) of a sampled
    tape.  Returns ``None`` for an all-empty window (the callers
    short-circuit to the trivial result).  Nothing is read back from the
    card.
    """
    dev = resolve_device(device)
    b = [int(x) for x in torch.as_tensor(bounds).tolist()]
    n = len(b) - 1
    lens = [b[i + 1] - b[i] for i in range(n)]
    with pstage(profile, "ingest", fence=False):
        segs, widths = padded_plan(lens)
        total = sum(widths)
        if n == 0 or total == 0:
            return None
        m = b[-1]
        wg = width_groups_of(widths)
        row_base = [0]
        for w in widths[:-1]:
            row_base.append(row_base[-1] + w)
        row_start = torch.zeros(n, dtype=_I64)
        row_start[segs] = torch.tensor(row_base, dtype=_I64)
        n_acc = torch.clamp(torch.as_tensor(n_accesses, dtype=_I64), min=1)
        per_tenant = torch.stack([torch.tensor(lens, dtype=_I64), row_start,
                                  n_acc, torch.clamp(torch.tensor(
                                      lens, dtype=_I64), min=1)])
        per_row = torch.tensor([segs, widths, row_base], dtype=_I64)
        rate_t = (torch.ones(n, dtype=_F64) if rates is None
                  else torch.as_tensor(rates, dtype=_F64))
        addrs_d, read_d, pt, pr, rate_d = _upload(
            [addrs.to(_I64), is_read.to(torch.bool), per_tenant, per_row,
             rate_t], dev)
        i64 = dict(dtype=_I64, device=dev)
        lens_d = pt[0]
        tid = torch.repeat_interleave(torch.arange(n, **i64), lens_d,
                                      output_size=m)
        end_of = torch.cumsum(lens_d, 0)[tid]
        prev, nxt_c, _, _ = segment_links(addrs_d, tid, end_of)
        layout = padded_segment_layout(b, device=dev)
        src, tpos = layout[0], layout[1]
        gprev, gnxt, gocc = padded_tape_links(prev, nxt_c, layout)
        gread = torch.zeros(total, dtype=torch.bool, device=dev)
        gread[tpos] = read_d if src is None else read_d[src]
        # cold accesses per tenant (the kept distinct addresses)
        cold = torch.zeros(n, **i64).index_add_(0, tid, (prev < 0).to(_I64))
        row_tids, row_w, row_b = pr[0], pr[1], pr[2]
        d = {"gprev": gprev, "gnxt": gnxt, "gocc": gocc, "gread": gread,
             "gtid": torch.repeat_interleave(row_tids, row_w,
                                             output_size=total),
             "grank": torch.arange(total, **i64) - torch.repeat_interleave(
                 row_b, row_w, output_size=total),
             "row_tids": row_tids, "row_start": pt[1], "n_acc": pt[2],
             "wr_den": pt[3], "rates": rate_d, "cold": cold}
    return WindowIngest((wg, n, rates is not None, kind), d, n, total, dev,
                        row_start, n_acc)


# ------------------------------------------------------------ the stages
def _row_scan(x: torch.Tensor, wg, fn) -> torch.Tensor:
    """``fn`` along the rows of each width group (rows are self-aligned
    blocks of width w)."""
    parts = [fn(x[lo:hi].reshape((hi - lo) // w, w)).reshape(-1)
             for w, lo, hi in wg]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def count_stage(ing: WindowIngest) -> torch.Tensor:
    """Per padded row: the (sampled: scaled, rounded half to even) reuse
    distance, -1 at cold and pad rows."""
    d = ing.dev
    counts = segment_counts_device(d["gprev"], d["gnxt"], d["gocc"], ing.wg)
    hot = d["gprev"] >= 0
    if ing.key[2]:
        r = torch.clamp(d["rates"][d["gtid"]], min=1e-300)
        return torch.where(hot, torch.round(counts.to(_F64) / r).to(_I64),
                           -1)
    return torch.where(hot, counts, -1)


def curve_stage(ing: WindowIngest, dist: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The padded curve store ``(edges_p, hgt_p, kcnt, urd)``: each row
    sorted, its distinct sample sizes (+1) written at the row's start in
    order with the cumulative count of its run ends, their heights by
    the host build's divisions (the Horvitz–Thompson estimator when
    sampled), the breakpoint count and the URD size per tenant."""
    d, n, total = ing.dev, ing.n, ing.total
    dev = dist.device
    i64 = dict(dtype=_I64, device=dev)
    smask = dist >= 0
    if ing.key[3] == "urd":
        smask = smask & d["gread"]
    sv = torch.where(smask, dist + 1, _SENT)
    edges_p = torch.zeros(total + 1, **i64)       # the last slot is trash
    cum_p = torch.zeros(total + 1, **i64)
    kcnt = torch.zeros(n, **i64)
    urd = torch.zeros(n, **i64)
    r0 = 0
    for w, lo, hi in ing.wg:
        rows = (hi - lo) // w
        s = torch.sort(sv[lo:hi].reshape(rows, w), dim=1).values
        val = s != _SENT
        edge = torch.full((rows, 1), -1, **i64)
        new = val & (s != torch.cat([edge, s[:, :-1]], dim=1))  # run head
        last = val & (s != torch.cat([s[:, 1:], edge], dim=1))  # run end
        rank = torch.cumsum(new.to(_I64), dim=1) - 1
        iota = torch.arange(w, **i64).expand(rows, w)
        rowi = torch.arange(rows, **i64)[:, None]
        dst = torch.where(last, lo + rowi * w + rank, total).reshape(-1)
        edges_p[dst] = s.reshape(-1)
        cum_p[dst] = (iota + 1).reshape(-1)
        rt = d["row_tids"][r0:r0 + rows]
        kcnt[rt] = new.to(_I64).sum(dim=1)
        urd[rt] = torch.where(val, s, 0).max(dim=1).values
        r0 += rows
    edges_p, cum_p = edges_p[:total], cum_p[:total].to(_F64)
    if ing.key[2]:
        den = d["n_acc"].to(_F64) * d["rates"]
        hgt_p = torch.clamp(cum_p / den[d["gtid"]], max=1.0)
    else:
        hgt_p = cum_p / d["n_acc"].to(_F64)[d["gtid"]]
    return edges_p, hgt_p, kcnt, urd


def wr_stage(ing: WindowIngest, dist: torch.Tensor) -> torch.Tensor:
    """Alg. 3 write ratios: write re-touches over the (kept) accesses."""
    d = ing.dev
    wflag = ((dist >= 0) & ~d["gread"]).to(_I64)
    wcnt = torch.zeros(ing.n, dtype=_I64, device=dist.device).index_add_(
        0, d["gtid"], wflag)
    return wcnt.to(_F64) / d["wr_den"].to(_F64)


def eval_at(edges_p, hgt_p, kcnt, gtid, grank, row_start,
            sizes: torch.Tensor) -> torch.Tensor:
    """h_i(sizes_i) from the padded curve store (the host ``evaluate``: the
    0-head plateau below the first breakpoint, 0 at sizes <= 0)."""
    has_u = grank < kcnt[gtid]
    le = has_u & (edges_p <= sizes[gtid])
    kq = torch.zeros_like(sizes).index_add_(0, gtid, le.to(_I64))
    h = hgt_p[row_start + torch.clamp(kq - 1, min=0)]
    return torch.where((kq > 0) & (sizes > 0), h, 0.0)


def walk(wg, edges_p, hgt_p, kcnt, gtid, grank, row_start,
         sizes0: torch.Tensor, budget, w_t: torch.Tensor,
         gain: float) -> torch.Tensor:
    """The ``method="fast"`` greedy walk on the padded curve store, with
    ``partitioner._greedy_walk_fast``'s grant order.

    A tenant's chain (its steps above its current size) lies inside its
    row, so the chain stop (a cumsum) and the prefix-min density envelope
    (a cummin) are row-local scans.  The rows are laid out by width, not
    by tenant, so the merge by ``(-envelope, tenant, rank)`` is two
    stable sorts, least significant key first: by tenant (a row a tenant,
    ranks ascending along it), then by the negated envelope; steps that
    are not valid carry +inf and sort past every valid one.  A prefix
    sum over Δc finds the budget cut; the first step not granted receives
    the partial grant.  ``budget`` is a device scalar or a host integer.
    """
    total = edges_p.shape[0]
    dev = edges_p.device
    has_u = grank < kcnt[gtid]
    le0 = has_u & (edges_p <= sizes0[gtid])
    k0 = torch.zeros_like(sizes0).index_add_(0, gtid, le0.to(_I64))
    k0g = k0[gtid]
    step = has_u & (grank >= k0g)
    first = step & (grank == k0g)
    h0 = torch.where((k0 > 0) & (sizes0 > 0),
                     hgt_p[row_start + torch.clamp(k0 - 1, min=0)], 0.0)
    hprev = torch.cat([torch.zeros(1, dtype=_F64, device=dev), hgt_p[:-1]])
    eprev = torch.cat([torch.zeros(1, dtype=_I64, device=dev), edges_p[:-1]])
    dh = hgt_p - torch.where(first, h0[gtid], hprev)
    dc = edges_p - torch.where(first, sizes0[gtid], eprev)
    # the heap stops a chain at its first non-improving step
    bad = (step & (dh <= 0)).to(_I64)
    valid = step & (_row_scan(bad, wg, lambda x: torch.cumsum(x, 1)) == 0)
    dens = (w_t[gtid] * dh * gain) / dc.to(_F64)    # the heap's operations
    env = _row_scan(torch.where(valid, dens, torch.inf), wg,
                    lambda x: torch.cummin(x, 1).values)
    neg_e = torch.where(valid, -env, torch.inf)
    by_tenant = torch.sort(gtid, stable=True).indices
    order = by_tenant[torch.sort(neg_e[by_tenant], stable=True).indices]
    tid_s, dc_s = gtid[order], torch.where(valid, dc, 0)[order]
    cum = torch.cumsum(dc_s, 0)
    granted = (dc_s > 0) & (cum <= budget)
    sizes1 = sizes0.scatter_reduce(0, tid_s,
                                   torch.where(granted, edges_p[order], 0),
                                   "amax", include_self=True)
    ngrant = granted.to(_I64).sum().reshape(1)
    nvalid = valid.to(_I64).sum().reshape(1)
    spent = torch.where(ngrant > 0, cum.index_select(
        0, torch.clamp(ngrant - 1, 0, total - 1)), 0)
    rem = budget - spent
    part = torch.where((rem > 0) & (ngrant < nvalid), rem, 0)
    return sizes1.index_add(0, tid_s.index_select(
        0, torch.clamp(ngrant, 0, total - 1)), part)


def partition_stage(ing: WindowIngest, edges_p, hgt_p, kcnt, urd,
                    capacity: int, c_min: int, w_t: torch.Tensor,
                    t_fast: float, t_slow: float):
    """``greedy_allocate(method="fast")`` on the curve store: the feasible
    grant, else the minimums (scaled down when even they do not fit) and
    the walk; then the hit ratios and the Eq. 2 latency at the sizes."""
    d = ing.dev
    c_min_arr = torch.clamp(urd, max=c_min)
    feasible = urd.sum() <= capacity
    tot = c_min_arr.sum()
    scaled = torch.floor((c_min_arr * capacity).to(_F64)
                         / torch.clamp(tot, min=1).to(_F64)).to(_I64)
    s0 = torch.where(capacity - tot < 0, scaled, c_min_arr)
    rows = (edges_p, hgt_p, kcnt, d["gtid"], d["grank"], d["row_start"])
    walked = walk(ing.wg, *rows, s0, capacity - s0.sum(), w_t,
                  t_slow - t_fast)
    sizes = torch.where(feasible, urd, walked)
    h_at = eval_at(*rows, sizes)
    lat = torch.sum(w_t * (h_at * t_fast + (1.0 - h_at) * t_slow))
    return sizes, h_at, lat, feasible


# ---------------------------------------------------- dispatch and fetch
def _staged(profile: StageProfile, name: str, sanitize: bool,
            dev: torch.device, fn, *args):
    """Staged mode: one stage, fenced, counted as a sync."""
    with profile.stage(name):
        with transfer_sanitizer(sanitize, dev):
            out = fn(*args)
    profile.sync()
    return out


def _dispatch_monitor(ing: WindowIngest, profile: StageProfile | None,
                      sanitize: bool = False) -> tuple:
    dev = ing.device
    if profile is not None and profile.staged:
        dist = _staged(profile, "count", sanitize, dev, count_stage, ing)
        cur = _staged(profile, "curve", sanitize, dev, curve_stage, ing,
                      dist)
        wr = _staged(profile, "write_ratio", sanitize, dev, wr_stage, ing,
                     dist)
        return (*cur, wr, ing.dev["cold"])
    with pstage(profile, "dispatch", fence=False):
        with transfer_sanitizer(sanitize, dev):
            dist = count_stage(ing)
            return (*curve_stage(ing, dist), wr_stage(ing, dist),
                    ing.dev["cold"])


def _fetch(ing: WindowIngest, out, profile: StageProfile | None
           ) -> list[torch.Tensor]:
    """The window's one host sync: every output copied into pinned host
    tensors without waiting, then one event synchronize (outside the
    sanitizer)."""
    with pstage(profile, "fetch", fence=False):
        if ing.device.type == "cuda":
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in out]
            for h, x in zip(host, out):
                h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(ing.device))
            done.synchronize()
        else:
            host = list(out)
        if profile is not None and not profile.staged:
            profile.sync()
    return host


def _trivial_monitor(n: int, n_acc: torch.Tensor):
    """Host-identical outputs for an all-empty window (no device work)."""
    z = torch.zeros(n, dtype=_I64)
    curves = BatchedHitRatioFunctions.from_padded(
        torch.zeros(0, dtype=_I64), torch.zeros(0, dtype=_F64), z, z, n_acc)
    return curves, z.clone(), torch.zeros(n, dtype=_F64), z.clone()


def monitor_window_device(addrs: torch.Tensor, is_read: torch.Tensor,
                          bounds, n_accesses, *, rates=None,
                          kind: str = "urd",
                          profile: StageProfile | None = None,
                          launch_hook=None, transfer_sanitize: bool = False,
                          device: str | torch.device | None = None):
    """Monitor outputs for one window, computed on ``device`` (default:
    the card).

    Returns ``(curves, urd_sizes, write_ratios, cold_counts)`` on the
    host, bit-identical to the host monitor; one host sync (the fetch).
    ``transfer_sanitize`` runs the dispatch under ``transfer_sanitizer``.
    ``launch_hook`` (fault injection) is called after ingest, right
    before the dispatch (and before the trivial result of an all-empty
    window), outside the sanitized region.
    """
    dev = resolve_device(device)
    if profile is not None:
        profile.bind(dev)
    n = len(bounds) - 1
    ing = ingest_window(addrs, is_read, bounds, n_accesses, rates=rates,
                       kind=kind, profile=profile, device=dev)
    if profile is not None:
        profile.windows += 1
    if launch_hook is not None:
        launch_hook()
    if ing is None:
        return _trivial_monitor(
            n, torch.clamp(torch.as_tensor(n_accesses, dtype=_I64), min=1))
    edges_p, hgt_p, kcnt, urd, wr, cold = _fetch(
        ing, _dispatch_monitor(ing, profile, transfer_sanitize), profile)
    curves = BatchedHitRatioFunctions.from_padded(edges_p, hgt_p, kcnt,
                                                  ing.row_start, ing.n_acc)
    return curves, urd, wr, cold


# --------------------------------------------------- fused decision pipeline
@dataclasses.dataclass(frozen=True)
class WindowDecision:
    """One Δt window's control-plane decision, computed on the device.

    Tensors on the host.  ``latency`` is the Eq. 2 objective at
    ``sizes`` (a sum in another order than ``aggregate_latency``: equal
    to rel 1e-12); everything else is bit-identical to the host path.
    """

    sizes: torch.Tensor
    write_ratios: torch.Tensor
    urd_sizes: torch.Tensor
    hit_ratios: torch.Tensor
    latency: float
    feasible: bool
    curves: BatchedHitRatioFunctions


class DeviceWindowPipeline:
    """End-to-end window decisions on one device, with double-buffered
    ingest.

    ``run(traces)`` analyzes and partitions one window (count, curve,
    write ratio, partition) with one host sync, the fetch;
    ``run_stream(windows)`` queues window t+1's ingest and dispatch
    before window t's fetch.  ``device`` defaults to the card.
    ``transfer_sanitize`` (off by default; the same decisions when on)
    runs every dispatch under ``transfer_sanitizer``.  ``mesh`` (the
    sharded pipeline) is refused until item 4.
    """

    def __init__(self, capacity: int, t_fast: float = 1.0,
                 t_slow: float = 20.0, c_min: int = 0, kind: str = "urd",
                 weights=None, transfer_sanitize: bool = False, mesh=None,
                 device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "the sharded window pipeline (mesh=) is not ported yet "
                "(ROADMAP: modules queue, item 4, core/shard_pipeline.py)")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.t_fast, self.t_slow = float(t_fast), float(t_slow)
        self.c_min = int(c_min)
        self.kind = kind
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=_F64).cpu())
        self.transfer_sanitize = bool(transfer_sanitize)

    # ------------------------------------------------------------ plumbing
    def _host_weights(self, n: int) -> torch.Tensor:
        return (torch.ones(n, dtype=_F64) if self.weights is None
                else self.weights)

    def ingest(self, traces, profile: StageProfile | None = None):
        """Lay one window of tenant traces out on the device."""
        lens = [len(t) for t in traces]
        bounds = [0]
        for ln in lens:
            bounds.append(bounds[-1] + ln)
        if bounds[-1]:
            addrs = torch.cat([t.addrs.to(_I64) for t in traces])
            is_read = torch.cat([t.is_read.to(torch.bool) for t in traces])
        else:
            addrs = torch.zeros(0, dtype=_I64)
            is_read = torch.zeros(0, dtype=torch.bool)
        ing = ingest_window(addrs, is_read, bounds, lens, kind=self.kind,
                            profile=profile, device=self.device)
        return ing, len(traces), torch.clamp(torch.tensor(lens, dtype=_I64),
                                             min=1)

    def _dispatch(self, ing: WindowIngest,
                  profile: StageProfile | None = None) -> tuple:
        dev, san = ing.device, self.transfer_sanitize
        # the weights cross before the sanitized region
        w_t = to_device(self._host_weights(ing.n), dev)
        part_args = (self.capacity, self.c_min, w_t, self.t_fast,
                     self.t_slow)
        if profile is not None and profile.staged:
            dist = _staged(profile, "count", san, dev, count_stage, ing)
            cur = _staged(profile, "curve", san, dev, curve_stage, ing, dist)
            wr = _staged(profile, "write_ratio", san, dev, wr_stage, ing,
                         dist)
            part = _staged(profile, "partition", san, dev, partition_stage,
                           ing, *cur, *part_args)
            return (*cur, wr, *part)
        with pstage(profile, "dispatch", fence=False):
            with transfer_sanitizer(san, dev):
                dist = count_stage(ing)
                cur = curve_stage(ing, dist)
                return (*cur, wr_stage(ing, dist),
                        *partition_stage(ing, *cur, *part_args))

    def _trivial(self, n: int, n_acc: torch.Tensor) -> WindowDecision:
        curves, urd, wr, _ = _trivial_monitor(n, n_acc)
        lat = float(torch.sum(self._host_weights(n) * self.t_slow))
        return WindowDecision(torch.zeros(n, dtype=_I64), wr, urd,
                              torch.zeros(n, dtype=_F64), lat, True, curves)

    def _finish(self, ing: WindowIngest, out,
                profile: StageProfile | None = None) -> WindowDecision:
        (edges_p, hgt_p, kcnt, urd, wr, sizes, h_at, lat,
         feas) = _fetch(ing, out, profile)
        curves = BatchedHitRatioFunctions.from_padded(
            edges_p, hgt_p, kcnt, ing.row_start, ing.n_acc)
        if profile is not None:
            profile.windows += 1
        return WindowDecision(sizes, wr, urd, h_at, float(lat), bool(feas),
                              curves)

    # -------------------------------------------------------------- driving
    def run(self, traces, profile: StageProfile | None = None
            ) -> WindowDecision:
        if profile is not None:
            profile.bind(self.device)
        ing, n, n_acc = self.ingest(traces, profile)
        if ing is None:
            if profile is not None:
                profile.windows += 1
            return self._trivial(n, n_acc)
        return self._finish(ing, self._dispatch(ing, profile), profile)

    def run_stream(self, windows, profile: StageProfile | None = None
                   ) -> list[WindowDecision]:
        """Double-buffered window stream: while window t's stages run on
        the device, window t+1 is laid out and queued; only then is window
        t fetched (its one sync).  Each fetch copies into fresh pinned
        buffers, and window t's outputs are read only after its fetch."""
        if profile is not None:
            profile.bind(self.device)
        results: list[WindowDecision] = []
        pending = None                  # (ingest, queued outputs)
        for traces in windows:
            ing, n, n_acc = self.ingest(traces, profile)
            nxt = None if ing is None else (ing, self._dispatch(ing,
                                                                profile))
            if pending is not None:
                results.append(self._finish(*pending, profile))
            if ing is None:
                if profile is not None:
                    profile.windows += 1
                results.append(self._trivial(n, n_acc))
            pending = nxt
        if pending is not None:
            results.append(self._finish(*pending, profile))
        return results


# ------------------------------------------------- standalone device walk
def greedy_walk_device(b: BatchedHitRatioFunctions, sizes: torch.Tensor,
                       budget: int, w: torch.Tensor,
                       gain: float) -> torch.Tensor:
    """``partitioner._greedy_walk_fast`` as ``walk`` on the curves' device:
    ``greedy_allocate(method="device")``'s backend.

    Pads the curve store (0-heads stripped) to a uniform power-of-two
    breakpoint count per tenant, one row a tenant, and walks it; the same
    grant order as the host walk, bit for bit.
    """
    n = len(b)
    if budget <= 0 or n == 0:
        return sizes
    dev = b.edges.device
    i64 = dict(dtype=_I64, device=dev)
    k = torch.clamp(torch.diff(b.offsets) - 1, min=0)     # drop the 0-heads
    kmax = int(k.max())
    if kmax == 0:
        return sizes
    k_pad = 1 << (kmax - 1).bit_length()
    total = n * k_pad
    edges_p = torch.zeros(total, **i64)
    hgt_p = torch.zeros(total, dtype=_F64, device=dev)
    tot_k = int(k.sum())

    def rep(x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, k, output_size=tot_k)

    rank = torch.arange(tot_k, **i64) - rep(torch.cumsum(k, 0) - k)
    src = rep(b.offsets[:-1] + 1) + rank
    row_start = torch.arange(n, **i64) * k_pad
    dst = rep(row_start) + rank
    edges_p[dst] = b.edges[src]
    hgt_p[dst] = b.heights[src]
    pos = torch.arange(total, **i64)
    return walk(((k_pad, 0, total),), edges_p, hgt_p, k, pos // k_pad,
                pos % k_pad, row_start, sizes.to(dev), budget,
                w.to(dev), gain)
