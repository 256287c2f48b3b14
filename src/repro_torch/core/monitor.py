"""Fused multi-tenant Monitor/Analyzer: one pass for all tenants.

Port of the exact host pipeline of ``repro.core.monitor.analyze_windows``
onto tensors on one device.  All tenants' Δt window traces form one
tape with per-tenant segment offsets; URD/TRD samples, hit-ratio curves
(``build_hit_ratio_functions``), Alg.-3 write ratios (write re-touches
per tenant = one ``bincount``) and URD-based sizes all come from that
tape with no per-tenant loop.

The batch replay engine already counts each window's stack distances, so
the manager forwards them as ``precomputed_trd``; a tenant without them
is counted here with ``kernels.cache_sim.ops.stack_distances`` over its
severed sub-tape (the kernel on the card, the merge-tree route on the
CPU), which gives the same counts as the reference's padded pass.

Not ported yet: SHARDS-sampled monitoring, which the reference's
manager turns on at 256 tenants, and the device/sharded window programs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.batch_sim import segment_links
from repro_torch.core.mrc import (BatchedHitRatioFunctions,
                                  build_hit_ratio_functions)
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_sim.ops import stack_distances

__all__ = ["MonitorResult", "analyze_windows"]


@dataclasses.dataclass(frozen=True)
class MonitorResult:
    """Per-tenant Analyzer outputs for one Δt window, batched.

    curves: stacked hit-ratio step functions (feed the partitioners).
    urd_sizes: int64[N] — ``calculateURDbasedSize`` per tenant.
    write_ratios: float64[N] — Alg. 3 ``(WAW + WAR) / n`` per tenant.
    kind: "urd" | "trd".
    """

    curves: BatchedHitRatioFunctions
    urd_sizes: torch.Tensor
    write_ratios: torch.Tensor
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
                    precomputed_trd: list[torch.Tensor | None] | None = None,
                    device: str | torch.device | None = None
                    ) -> MonitorResult:
    """Analyze every tenant's Δt window in one fused pass (see module doc).

    ``precomputed_trd[i]`` carries tenant i's raw window-internal TRD
    sample tensor from the batch replay engine; missing entries are
    counted here.  Runs on ``device`` (default: the CUDA card).
    """
    if kind not in ("trd", "urd"):
        raise ValueError(f"kind must be 'trd' or 'urd', got {kind!r}")
    dev = resolve_device(device)
    n = len(traces)
    lens_l = [len(t) for t in traces]
    bounds = [0]
    for ln in lens_l:
        bounds.append(bounds[-1] + ln)
    m = bounds[-1]
    i64 = dict(dtype=torch.int64, device=dev)
    lens = torch.tensor(lens_l, **i64)
    is_read = (torch.cat([t.is_read.to(dev, torch.bool) for t in traces])
               if m else torch.zeros(0, dtype=torch.bool, device=dev))
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
    return MonitorResult(curves, urd, wr, kind)
