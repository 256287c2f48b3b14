"""Sharded Δt window pipeline: the device window pipeline over a 1-D mesh.

Port of ``repro.core.shard_pipeline``.  ``core.device_pipeline`` keeps a
whole window decision on one device; this module partitions the padded,
width-sorted segment tape across the shards of a ``ShardMesh``
(``distributed.sharding``) **by whole tenant-segments** and runs the same
stages on every shard:

  * **Assignment** (``shard_assignment``): greedy width-balanced (LPT)
    placement of the padded rows, walked in the tape's descending-width
    order, so each shard's sub-tape is again a descending sequence of
    power-of-two rows: every row stays self-aligned on its shard and the
    boundary-severing argument of ``core.monitor`` holds per shard, so
    counting needs no link across shards.  The largest shard load is at
    most the mean plus the widest row, within 2x of the optimum.
  * **Uniform layout** (``uniform_shard_layout``): every shard carries
    the same structure, each distinct width's row count padded to its
    largest over the shards.  Surplus rows carry ``padded_tape_links``'s
    pad sentinels and a *trash tenant slot* ``n``: per-tenant vectors
    have length ``n + 1`` and the slot is sliced off after the
    reduction, so an all-pad row never reaches a real tenant's curve.
  * **Ingest** (``ingest_window_sharded``): the host plans the widths,
    the assignment and the uniform layout from the lengths alone; the raw
    tape crosses to the mesh's first device from pinned memory on a side
    stream, the links and the padded tape are built there, and every real
    row is scattered into its shard's ``[S]`` chunk with one constant
    shift per row (its links are row-internal).  Each shard's chunk then
    moves to its device; nothing is read back.
  * **The stages**: ``count_stage`` (one ``cache_sim_segments_scan``
    launch per width group, on every shard), ``curve_stage`` and the
    write counts run on each shard's chunk under its device.  Only the
    per-tenant integer summaries (breakpoint counts, URD sizes, write
    counts) cross shards: they move to the first device and are summed,
    which is exact because each tenant lives whole on one shard and the
    others add zeros.  The curve stores are concatenated there in shard
    order.  The budget cut (``partition_stage``, the envelope-scan walk)
    then runs once, on the first device, over the concatenated store, so
    the grant order is the host walk's bit for bit.
  * **One sync a window per mesh**: the fetch, as in the device pipeline.

The reference runs this as one ``shard_map`` program with in-process
``psum`` / ``all_gather`` on a single-controller mesh; the port keeps the
single controller (one process issues every shard's work) and spells the
collectives out as tensor moves onto the first device.  Logical shards
(a device repeated in the mesh) run their stages one after the other on
that device.

``monitor_window_sharded`` backs ``analyze_windows(pipeline="sharded")``
and the manager's top ladder rung (sharded -> device -> host -> tenant);
``DeviceWindowPipeline(mesh=...)`` routes its decisions (and
``run_stream``) through ``dispatch_decision_sharded``.  The sharded
pipeline always runs fused: a ``staged`` profile attributes no stage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import heapq

import torch

from repro_torch.core.batch_sim import (padded_plan, padded_segment_layout,
                                        padded_tape_links, segment_links)
from repro_torch.core.device_pipeline import (WindowIngest, _fetch,
                                              _trivial_monitor, _upload,
                                              count_stage, curve_stage,
                                              partition_stage,
                                              transfer_sanitizer,
                                              write_counts)
from repro_torch.core.mrc import BatchedHitRatioFunctions
from repro_torch.core.profile import StageProfile, pstage
from repro_torch.device import to_device
from repro_torch.distributed.sharding import ShardMesh, control_plane_mesh

__all__ = ["ShardIngest", "ShardLayout", "dispatch_decision_sharded",
           "ingest_window_sharded", "monitor_window_sharded",
           "shard_assignment", "uniform_shard_layout"]

_I64, _F64 = torch.int64, torch.float64


# ----------------------------------------------------------- shard placement
def shard_assignment(widths, n_shards: int) -> torch.Tensor:
    """Greedy width-balanced (LPT) shard per padded row (int64, host).

    ``widths`` are the layout's padded row widths in descending order;
    each row goes to the currently lightest shard (ties to the lowest
    index), so every shard's rows stay descending (self-aligned) and
    ``max_load <= mean + w_max <= 2 * max(mean, w_max)``.
    """
    heap = [(0, s) for s in range(int(n_shards))]   # (load, shard)
    out = []
    for w in widths:
        load, s = heapq.heappop(heap)
        out.append(s)
        heapq.heappush(heap, (load + int(w), s))
    return torch.tensor(out, dtype=_I64)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The uniform per-shard tape structure (the same on every shard).

    ``shard_wg`` is the per-shard width-group structure (every distinct
    width padded to its largest row count over the shards);
    ``entry_base`` / ``row_index`` map each layout row to its local entry
    offset and row on its assigned shard.  Tensors are int64 on the host.
    """

    uwidths: torch.Tensor      # distinct widths, descending
    rcap: torch.Tensor         # rows per width in the uniform layout
    size: int                  # per-shard padded tape length S
    rows: int                  # per-shard row count R
    shard_wg: tuple            # ((w, lo, hi), ...) over [0, S)
    entry_base: torch.Tensor   # local entry offset per layout row
    row_index: torch.Tensor    # local row index per layout row


def uniform_shard_layout(widths, assign, n_shards: int) -> ShardLayout:
    """Place every assigned row into the uniform per-shard structure: a
    block per distinct width (descending), and inside it each shard's rows
    of that width in the order they arrive."""
    widths = [int(w) for w in widths]
    uw = sorted(set(widths), reverse=True)
    col = {w: c for c, w in enumerate(uw)}
    per = [[0] * len(uw) for _ in range(int(n_shards))]
    seq = []                              # arrival rank per (shard, width)
    for w, s in zip(widths, (int(a) for a in assign)):
        seq.append(per[s][col[w]])
        per[s][col[w]] += 1
    rcap = [max(row[c] for row in per) for c in range(len(uw))]
    blk_entry, blk_row, shard_wg = [], [], []
    lo = r = 0
    for w, cap in zip(uw, rcap):
        blk_entry.append(lo)
        blk_row.append(r)
        shard_wg.append((w, lo, lo + cap * w))
        lo += cap * w
        r += cap
    i64 = functools.partial(torch.tensor, dtype=_I64)
    return ShardLayout(
        i64(uw), i64(rcap), lo, r, tuple(shard_wg),
        i64([blk_entry[col[w]] + q * w for w, q in zip(widths, seq)]),
        i64([blk_row[col[w]] + q for w, q in zip(widths, seq)]))


# ------------------------------------------------------------------- ingest
@dataclasses.dataclass
class ShardIngest:
    """One window laid out over a mesh, and its host-side metadata.

    ``shards`` are the per-shard ``WindowIngest`` views (each on its
    device, ``n + 1`` tenants with the trash slot); ``store`` is the
    concatenated curve store's view on the first device (``gtid``,
    ``grank`` and ``row_start`` for the budget cut).  ``row_start`` and
    ``n_acc`` (int64[n], on the host) unpack the fetched store:
    ``row_start`` is in concatenated-store coordinates.  The views'
    host fields are ``None``: only this object is unpacked.
    """

    key: tuple
    shards: list
    store: WindowIngest
    n: int
    mesh: ShardMesh
    wr_den: torch.Tensor       # int64[n + 1] on the first device
    cold: torch.Tensor         # int64[n] on the first device
    row_start: torch.Tensor
    n_acc: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]


def ingest_window_sharded(addrs: torch.Tensor, is_read: torch.Tensor,
                          bounds, n_accesses, *, mesh: ShardMesh,
                          rates=None, kind: str = "urd",
                          profile: StageProfile | None = None
                          ) -> ShardIngest | None:
    """Lay one window out over ``mesh`` (``ingest_window``'s contract:
    ``None`` for an all-empty window, nothing read back).

    The key is ``(shard width groups, n_shards, n_tenants, sampled, kind,
    mesh)``.
    """
    dev0, k = mesh.devices[0], mesh.size
    b = [int(x) for x in torch.as_tensor(bounds).tolist()]
    n = len(b) - 1
    lens = [b[i + 1] - b[i] for i in range(n)]
    with pstage(profile, "ingest", fence=False):
        segs, widths = padded_plan(lens)
        total = sum(widths)
        if n == 0 or total == 0:
            return None
        m, g = b[-1], len(widths)
        assign = shard_assignment(widths, k)
        lay = uniform_shard_layout(widths, assign, k)
        S, R = lay.size, lay.rows
        row_base = [0]
        for w in widths[:-1]:
            row_base.append(row_base[-1] + w)
        segs_t = torch.tensor(segs, dtype=_I64)
        row_start = torch.zeros(n + 1, dtype=_I64)
        row_start[segs_t] = assign * S + lay.entry_base
        n_acc = torch.clamp(torch.as_tensor(n_accesses, dtype=_I64), min=1)
        lens_t = torch.tensor(lens + [0], dtype=_I64)
        one = torch.ones(1, dtype=_I64)
        per_tenant = torch.stack([lens_t, row_start, torch.cat([n_acc, one]),
                                  torch.clamp(lens_t, min=1)])
        per_row = torch.stack([segs_t, torch.tensor(widths, dtype=_I64),
                               lay.entry_base - torch.tensor(row_base,
                                                             dtype=_I64),
                               assign * S, assign * R + lay.row_index])
        u_w = torch.repeat_interleave(lay.uwidths, lay.rcap)
        per_urow = torch.stack([u_w, torch.cumsum(u_w, 0) - u_w])
        rate_t = torch.cat([torch.ones(n, dtype=_F64) if rates is None
                            else torch.as_tensor(rates, dtype=_F64),
                            torch.ones(1, dtype=_F64)])
        addrs_d, read_d, pt, pr, pu, rate_d = _upload(
            [addrs.to(_I64), is_read.to(torch.bool), per_tenant, per_row,
             per_urow, rate_t], dev0)
        i64 = dict(dtype=_I64, device=dev0)
        # the links and the padded tape, as the device pipeline builds them
        tid = torch.repeat_interleave(torch.arange(n + 1, **i64), pt[0],
                                      output_size=m)
        end_of = torch.cumsum(pt[0], 0)[tid]
        prev, nxt_c, _, _ = segment_links(addrs_d, tid, end_of)
        layout = padded_segment_layout(b, device=dev0)
        src, tpos = layout[0], layout[1]
        gprev, gnxt, gocc = padded_tape_links(prev, nxt_c, layout)
        gread = torch.zeros(total, dtype=torch.bool, device=dev0)
        gread[tpos] = read_d if src is None else read_d[src]
        cold = torch.zeros(n, **i64).index_add_(0, tid, (prev < 0).to(_I64))
        # scatter the real rows into the stacked [k, S] tape: one constant
        # shift a row relocates its row-internal links; the template's
        # surplus rows are the pad sentinels of the trash slot n, and
        # grank is shift-invariant, so the template's is already right
        row_tids, row_w, shift, row_off, row_slot = pr
        rows_e = torch.repeat_interleave(torch.arange(g, **i64), row_w,
                                         output_size=total)
        shift_e = shift[rows_e]
        dst = torch.arange(total, **i64) + shift_e + row_off[rows_e]
        loc = torch.arange(S, **i64)
        t_prev = torch.full((k * S,), -1, **i64)
        t_prev[dst] = torch.where(gprev >= 0, gprev + shift_e, -1)
        t_nxt = loc.repeat(k)
        t_nxt[dst] = gnxt + shift_e
        t_occ = torch.zeros(k * S, dtype=torch.int32, device=dev0)
        t_occ[dst] = gocc
        t_read = torch.zeros(k * S, dtype=torch.bool, device=dev0)
        t_read[dst] = gread
        t_tid = torch.full((k * S,), n, **i64)
        t_tid[dst] = torch.repeat_interleave(row_tids, row_w,
                                             output_size=total)
        t_rank = (loc - torch.repeat_interleave(pu[1], pu[0],
                                                output_size=S)).repeat(k)
        t_rows = torch.full((k * R,), n, **i64)
        t_rows[row_slot] = row_tids
        sampled = rates is not None
        shards = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = s * S, (s + 1) * S
            parts = [t_prev[lo:hi], t_nxt[lo:hi], t_occ[lo:hi],
                     t_read[lo:hi], t_tid[lo:hi], t_rank[lo:hi],
                     t_rows[s * R:(s + 1) * R], pt[2], rate_d]
            if dev != dev0:
                parts = _upload(parts, dev)
            d = dict(zip(("gprev", "gnxt", "gocc", "gread", "gtid", "grank",
                          "row_tids", "n_acc", "rates"), parts))
            shards.append(WindowIngest((lay.shard_wg, n + 1, sampled, kind),
                                       d, n + 1, S, dev, None, None))
        # the budget cut walks the concatenated store: the shard structure
        # repeated in mesh order
        wg_cat = tuple((w, s * S + lo, s * S + hi) for s in range(k)
                       for w, lo, hi in lay.shard_wg)
        store = WindowIngest((wg_cat, n + 1, sampled, kind),
                             {"gtid": t_tid, "grank": t_rank,
                              "row_start": pt[1]},
                             n + 1, k * S, dev0, None, None)
    return ShardIngest((lay.shard_wg, k, n, sampled, kind, mesh), shards,
                       store, n, mesh, pt[3], cold, row_start[:n].clone(),
                       n_acc)


# ----------------------------------------------------------------- dispatch
def _on(dev: torch.device):
    """Issue work on ``dev`` (its kernels launch on that card)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _shard_stages(ing: ShardIngest) -> tuple:
    """Count, curve and write counts on every shard under its device; the
    integer summaries summed and the curve stores concatenated, in shard
    order, on the first device.  Returns ``(edges, heights, kcnt, urd,
    wr)`` with the trash slot."""
    dev0 = ing.device
    edges, hgts, sums = [], [], []
    for view in ing.shards:
        with _on(view.device):
            dist = count_stage(view)
            e, h, kcnt, urd = curve_stage(view, dist)
            wcnt = write_counts(view, dist)
        edges.append(e.to(dev0, non_blocking=True))
        hgts.append(h.to(dev0, non_blocking=True))
        sums.append(torch.stack([kcnt, urd, wcnt]).to(dev0,
                                                      non_blocking=True))
    kcnt, urd, wcnt = torch.stack(sums).sum(0)
    wr = wcnt.to(_F64) / ing.wr_den.to(_F64)
    return torch.cat(edges), torch.cat(hgts), kcnt, urd, wr


def _dispatch_monitor_sharded(ing: ShardIngest,
                              profile: StageProfile | None,
                              sanitize: bool = False) -> tuple:
    n = ing.n
    with pstage(profile, "dispatch", fence=False):
        with transfer_sanitizer(sanitize, ing.device):
            edges, hgt, kcnt, urd, wr = _shard_stages(ing)
            return edges, hgt, kcnt[:n], urd[:n], wr[:n], ing.cold


def dispatch_decision_sharded(ing: ShardIngest, capacity: int, c_min: int,
                              weights: torch.Tensor, t_fast: float,
                              t_slow: float,
                              profile: StageProfile | None = None,
                              sanitize: bool = False) -> tuple:
    """Queue one sharded window decision (``DeviceWindowPipeline``'s
    backend): the shards' stages, then the one ``partition_stage`` over
    the concatenated store on the first device.  ``weights`` (float64[n],
    host) gain the trash slot at weight 0, so the pad tenant adds nothing
    to the latency objective.  Returns ``DeviceWindowPipeline._dispatch``'s
    tuple, on the first device."""
    n = ing.n
    # the weights cross before the sanitized region
    w_t = to_device(torch.cat([weights.to(_F64),
                               torch.zeros(1, dtype=_F64)]), ing.device)
    with pstage(profile, "dispatch", fence=False):
        with transfer_sanitizer(sanitize, ing.device):
            edges, hgt, kcnt, urd, wr = _shard_stages(ing)
            sizes, h_at, lat, feas = partition_stage(
                ing.store, edges, hgt, kcnt, urd, capacity, c_min, w_t,
                t_fast, t_slow)
            return (edges, hgt, kcnt[:n], urd[:n], wr[:n], sizes[:n],
                    h_at[:n], lat, feas)


def monitor_window_sharded(addrs: torch.Tensor, is_read: torch.Tensor,
                           bounds, n_accesses, *, mesh: ShardMesh | None = None,
                           rates=None, kind: str = "urd",
                           profile: StageProfile | None = None,
                           launch_hook=None, transfer_sanitize: bool = False,
                           device: str | torch.device | None = None):
    """Monitor outputs for one window, computed across ``mesh`` (default:
    ``control_plane_mesh(device=device)``, every visible card).

    ``monitor_window_device``'s contract: ``(curves, urd_sizes,
    write_ratios, cold_counts)`` on the host, bit-identical to the host
    monitor at any shard count, one host sync a window per mesh (the
    fetch); ``launch_hook`` is called once after ingest, before the
    dispatch and before an all-empty window's trivial result.
    """
    if mesh is None:
        mesh = control_plane_mesh(device=device)
    if profile is not None:
        profile.bind(mesh.devices[0])
    n = len(bounds) - 1
    ing = ingest_window_sharded(addrs, is_read, bounds, n_accesses,
                                mesh=mesh, rates=rates, kind=kind,
                                profile=profile)
    if profile is not None:
        profile.windows += 1
    if launch_hook is not None:
        launch_hook()
    if ing is None:
        return _trivial_monitor(
            n, torch.clamp(torch.as_tensor(n_accesses, dtype=_I64), min=1))
    edges, hgt, kcnt, urd, wr, cold = _fetch(
        ing, _dispatch_monitor_sharded(ing, profile, transfer_sanitize),
        profile)
    curves = BatchedHitRatioFunctions.from_padded(edges, hgt, kcnt,
                                                  ing.row_start, ing.n_acc)
    return curves, urd, wr, cold
