"""Fused multi-tenant Monitor/Analyzer: one pass for all tenants.

Port of the exact host pipeline of ``repro.core.monitor.analyze_windows``
onto tensors on one device.  All tenants' Δt window traces form one
tape with per-tenant segment offsets; URD/TRD samples, hit-ratio curves
(``build_hit_ratio_functions``), Alg.-3 write ratios (write re-touches
per tenant = one ``bincount``) and URD-based sizes all come from that
tape with no per-tenant loop.

The batch replay engine already counts each window's stack distances, so
the manager forwards them as ``precomputed_trd`` on the exact path; a
tenant without them is counted here with
``kernels.cache_sim.ops.stack_distances`` over its severed sub-tape (the
kernel on the card, the merge-tree route on the CPU), which gives the
same counts as the reference's padded pass.

**SHARDS.**  With ``sample_rate`` set (a float, or ``"auto"`` for the
per-tenant target-sample-count tuner) each tenant's window is spatially
filtered first, with a salt per (tenant, window) from ``shards_salt``,
and only the kept sub-tape is concatenated.  It is laid out padded and
self-aligned (``batch_sim.padded_segment_layout``) and counted in one
``kernels.cache_sim.ops.stack_distances_segments`` pass, one
``cache_sim_segments_scan`` launch per distinct padded width on the
card.  Distances are scaled by ``1/rate`` (rounded half to even), curve
heights use the Horvitz–Thompson estimator, write ratios are measured
over the kept accesses, and each tenant's error bar is
``1/sqrt(kept distinct addresses)``.  Every output equals the
reference's host pipeline bit for bit.

``pipeline="device"`` routes a window through the device window
pipeline (``core.device_pipeline.monitor_window_device``: one sync a
window, the fetch), on the exact and the sampled branch alike, with the
same outputs bit for bit; it recounts even where distances were
precomputed and needs percentile 100.  ``fault_hook`` (fault injection,
the manager's degradation ladder) is called once at the pipeline's
dispatch boundary, as in the reference: on the host pipeline right before
the count, on the device pipeline right before its dispatch.  Not ported
yet: the reference's sharded window program (``pipeline="sharded"``,
ROADMAP item 4).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.batch_sim import segment_links
from repro_torch.core.device_pipeline import monitor_window_device
from repro_torch.core.mrc import (BatchedHitRatioFunctions,
                                  build_hit_ratio_functions)
from repro_torch.core.profile import StageProfile
from repro_torch.core.reuse_distance import (auto_sample_rate, shards_hash,
                                             shards_salt, shards_threshold)
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_sim.ops import (stack_distances,
                                               stack_distances_segments)

__all__ = ["MonitorResult", "analyze_windows", "shards_subtape"]


@dataclasses.dataclass(frozen=True)
class MonitorResult:
    """Per-tenant Analyzer outputs for one Δt window, batched.

    curves: stacked hit-ratio step functions (feed the partitioners).
    urd_sizes: int64[N] — ``calculateURDbasedSize`` per tenant.
    write_ratios: float64[N] — Alg. 3 ``(WAW + WAR) / n`` per tenant
      (sampled: measured over the kept accesses).
    sample_rates: float64[N] — effective SHARDS rate per tenant (1.0
      exact).
    expected_errors: float64[N] — expected absolute curve error
      (~1/sqrt(kept distinct addresses)); 0.0 where exact.
    kind: "urd" | "trd".
    """

    curves: BatchedHitRatioFunctions
    urd_sizes: torch.Tensor
    write_ratios: torch.Tensor
    sample_rates: torch.Tensor
    expected_errors: torch.Tensor
    kind: str


def _urd_sizes(dist: torch.Tensor, n_tenants: int, bounds: list[int],
               percentile: float,
               curves: BatchedHitRatioFunctions) -> torch.Tensor:
    """Batched ``urd_cache_blocks`` (max sample + 1, or percentile)."""
    if percentile >= 100.0:
        # max sample + 1 == the curve's largest breakpoint, already stacked
        return curves.max_useful_sizes.clone()
    out = []
    for i in range(n_tenants):                   # rare config; no recount
        seg = dist[bounds[i]:bounds[i + 1]]
        s = seg[seg >= 0]
        out.append(int(torch.quantile(s.to(torch.float64),
                                      percentile / 100.0)) + 1
                   if s.numel() else 0)
    return torch.tensor(out, dtype=torch.int64, device=dist.device)


def analyze_windows(traces: list[Trace], kind: str = "urd",
                    percentile: float = 100.0,
                    sample_rate: float | str | None = None,
                    window_seed: int = 0,
                    sample_target: int = 4096, sample_floor: int = 256,
                    precomputed_trd: list[torch.Tensor | None] | None = None,
                    tenant_ids: list[int] | None = None,
                    pipeline: str = "host",
                    profile: StageProfile | None = None,
                    device: str | torch.device | None = None,
                    fault_hook=None) -> MonitorResult:
    """Analyze every tenant's Δt window in one fused pass (see module doc).

    ``precomputed_trd[i]`` (host exact path only) carries tenant i's raw
    window-internal TRD sample tensor from the batch replay engine;
    missing entries are counted here.  ``sample_rate`` (a float in
    (0, 1] or ``"auto"``) turns on SHARDS; ``window_seed`` and
    ``tenant_ids`` (default: positions) pick each tenant's salt, and
    ``sample_target``/``sample_floor`` tune ``"auto"``.
    ``pipeline="device"`` runs the window through the device window
    pipeline (percentile 100 only); ``profile`` (a ``StageProfile``)
    records its stage times, host syncs and windows (on the host
    pipeline: the pass as stage ``monitor`` and the window).  Runs on
    ``device`` (default: the CUDA card).  ``fault_hook`` (fault
    injection) is called once at the dispatch boundary (module doc).
    """
    if kind not in ("trd", "urd"):
        raise ValueError(f"kind must be 'trd' or 'urd', got {kind!r}")
    if pipeline not in ("host", "device", "sharded"):
        raise ValueError(f"pipeline must be 'host', 'device' or 'sharded', "
                         f"got {pipeline!r}")
    if pipeline == "sharded":
        raise NotImplementedError(
            "pipeline='sharded' is not ported yet (ROADMAP: modules queue, "
            "item 4, core/shard_pipeline.py)")
    if pipeline != "host" and percentile < 100.0:
        raise ValueError(f"pipeline={pipeline!r} computes URD sizes from "
                         "the curve store (percentile=100); use the host "
                         "pipeline for percentile < 100")
    dev = resolve_device(device)
    if profile is not None:
        profile.bind(dev)
    if pipeline == "host" and profile is not None:
        with profile.stage("monitor"):
            out = analyze_windows(
                traces, kind, percentile, sample_rate, window_seed,
                sample_target, sample_floor, precomputed_trd, tenant_ids,
                device=dev, fault_hook=fault_hook)
        profile.windows += 1
        return out
    n = len(traces)
    lens_l = [len(t) for t in traces]
    bounds = [0]
    for ln in lens_l:
        bounds.append(bounds[-1] + ln)
    m = bounds[-1]
    if sample_rate is not None:
        ids = list(tenant_ids) if tenant_ids is not None else list(range(n))
        return _sampled(traces, kind, percentile, sample_rate, window_seed,
                        sample_target, sample_floor, ids, lens_l, dev,
                        pipeline, profile, fault_hook)
    i64 = dict(dtype=torch.int64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    is_read = (torch.cat([t.is_read.to(dev, torch.bool) for t in traces])
               if m else torch.zeros(0, dtype=torch.bool, device=dev))
    if pipeline == "device":
        addrs = (torch.cat([t.addrs.to(dev, torch.int64) for t in traces])
                 if m else torch.zeros(0, **i64))
        curves, urd, wr, _ = monitor_window_device(
            addrs, is_read, bounds, lens_l, kind=kind, profile=profile,
            launch_hook=fault_hook, device=dev)
        return MonitorResult(curves.to(dev), urd.to(dev), wr.to(dev),
                             torch.ones(n, **f64), torch.zeros(n, **f64),
                             kind)
    if fault_hook is not None:
        fault_hook()
    lens = torch.tensor(lens_l, **i64)
    tid = torch.repeat_interleave(torch.arange(n, **i64), lens)

    pre = precomputed_trd or []
    dist = torch.full((m,), -1, **i64)
    need = []
    for i in range(n):
        raw = pre[i] if i < len(pre) else None
        if raw is not None:
            dist[bounds[i]:bounds[i + 1]] = raw.to(dev)
        elif lens_l[i] > 0:
            need.append(i)
    if need:
        # only the tenants without precomputed distances are counted, on
        # a sub-tape of their windows (links severed per tenant)
        sub_addr = torch.cat([traces[i].addrs.to(dev, torch.int64)
                              for i in need])
        sub_lens = torch.tensor([lens_l[i] for i in need], **i64)
        sub_tid = torch.repeat_interleave(torch.arange(len(need), **i64),
                                          sub_lens)
        sub_end = torch.cumsum(sub_lens, 0)[sub_tid]
        prev, nxt_c, _, _ = segment_links(sub_addr, sub_tid, sub_end)
        sd = stack_distances(prev, nxt_c)
        o = 0
        for i in need:
            dist[bounds[i]:bounds[i + 1]] = sd[o:o + lens_l[i]]
            o += lens_l[i]
    hot = dist >= 0
    wr = (torch.bincount(tid[hot & ~is_read], minlength=n).to(torch.float64)
          / torch.clamp(lens, min=1).to(torch.float64))
    smask = (hot & is_read) if kind == "urd" else hot
    if kind == "urd" and percentile < 100.0:
        dist = torch.where(smask, dist, -1)
    curves = build_hit_ratio_functions(dist, tid, n, lens, mask=smask)
    urd = _urd_sizes(dist, n, bounds, percentile, curves)
    return MonitorResult(curves, urd, wr, torch.ones(n, **f64),
                         torch.zeros(n, **f64), kind)


def shards_subtape(traces: list[Trace], rates: list[float], window_seed: int,
                   tenant_ids: list[int], device: str | torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SHARDS-kept sub-tape of one window: ``(addrs, is_read, kept)``
    with ``kept[i]`` the accesses tenant i keeps, in tenant order.

    The filter runs over the whole window at once: each position carries
    its tenant's salt (``shards_salt(window_seed, tenant_ids[i])``) and
    hash threshold (2**32 keeps every address).
    """
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    n = len(traces)
    lens_l = [len(t) for t in traces]
    if not sum(lens_l):
        return (torch.zeros(0, **i64),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(n, **i64))
    addrs = torch.cat([t.addrs.to(dev, torch.int64) for t in traces])
    reads = torch.cat([t.is_read.to(dev, torch.bool) for t in traces])
    salts = torch.tensor([shards_salt(window_seed, i) for i in tenant_ids],
                         **i64)
    thr = torch.tensor([shards_threshold(r) for r in rates], **i64)
    lens = torch.tensor(lens_l, **i64)
    keep = (shards_hash(addrs, torch.repeat_interleave(salts, lens))
            < torch.repeat_interleave(thr, lens))
    tid = torch.repeat_interleave(torch.arange(n, **i64), lens)
    return (addrs[keep], reads[keep],
            torch.bincount(tid[keep], minlength=n))


def _sampled(traces: list[Trace], kind: str, percentile: float,
             sample_rate: float | str, window_seed: int, sample_target: int,
             sample_floor: int, ids: list[int], lens_l: list[int],
             dev: torch.device, pipeline: str = "host",
             profile: StageProfile | None = None,
             fault_hook=None) -> MonitorResult:
    """The SHARDS branch of ``analyze_windows`` (see module doc)."""
    n = len(traces)
    if sample_rate == "auto":
        rates_l = [auto_sample_rate(ln, sample_target, sample_floor)
                   for ln in lens_l]
    else:
        r = float(sample_rate)
        if not (0 < r <= 1):
            raise ValueError("sample_rate must be in (0, 1] or 'auto'")
        rates_l = [r] * n
    f64 = dict(dtype=torch.float64, device=dev)
    rates = torch.tensor(rates_l, **f64)
    addrs_s, read_s, kept = shards_subtape(traces, rates_l, window_seed, ids,
                                           dev)
    i64 = dict(dtype=torch.int64, device=dev)
    sub_bounds = torch.cat([torch.zeros(1, **i64), torch.cumsum(kept, 0)])
    sb = sub_bounds.cpu()                  # the kept lengths, on the host
    if pipeline == "device":
        if profile is not None and dev.type == "cuda":
            profile.sync()                 # that read, before the ingest
        curves, urd, wr, distinct = monitor_window_device(
            addrs_s, read_s, sb, lens_l, rates=rates_l, kind=kind,
            profile=profile, launch_hook=fault_hook, device=dev)
        curves, urd, wr = curves.to(dev), urd.to(dev), wr.to(dev)
        return MonitorResult(curves, urd, wr, rates,
                             _error_bars(distinct.tolist(), rates_l, dev),
                             kind)
    if fault_hook is not None:
        fault_hook()
    tid_s = torch.repeat_interleave(torch.arange(n, **i64), kept)
    prev, nxt_c, _, _ = segment_links(addrs_s, tid_s, sub_bounds[1:][tid_s])
    sd = stack_distances_segments(prev, nxt_c, sb)
    dist = torch.where(sd >= 0,
                       torch.round(sd.to(torch.float64)
                                   / torch.clamp(rates[tid_s], min=1e-300))
                       .to(torch.int64), -1)
    hot_w = (dist >= 0) & ~read_s
    wr = (torch.bincount(tid_s[hot_w], minlength=n).to(torch.float64)
          / torch.clamp(kept, min=1).to(torch.float64))
    if kind == "urd":
        dist = torch.where(read_s, dist, -1)
    curves = build_hit_ratio_functions(dist, tid_s, n, lens_l, rates=rates)
    urd = _urd_sizes(dist, n, sb.tolist(), percentile, curves)
    # error bars scale with the kept *distinct* addresses (the cold
    # accesses of the sub-tape)
    distinct = torch.bincount(tid_s[prev < 0], minlength=n).tolist()
    return MonitorResult(curves, urd, wr, rates,
                         _error_bars(distinct, rates_l, dev), kind)


def _error_bars(distinct: list[int], rates_l: list[float],
                dev: torch.device) -> torch.Tensor:
    """``1/sqrt(kept distinct addresses)`` per sampled tenant (0.0 where
    exact), on the host: math.sqrt is correctly rounded, torch's CPU root
    not always, and the error bars must not depend on the device."""
    return torch.tensor(
        [min(1.0, 1.0 / math.sqrt(max(d, 1))) if r < 1.0 else 0.0
         for d, r in zip(distinct, rates_l)], dtype=torch.float64,
        device=dev)
