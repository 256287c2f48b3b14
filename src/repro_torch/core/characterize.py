"""ReCA-style online workload characterization (PAPERS.md, arxiv 1805.06747).

Port of ``repro.core.characterize``: a per-(tenant, window) feature pass
and a hysteresis phase detector, which let ``ECICacheManager`` (with
``phase_detect=True``) reconfigure on phase boundaries instead of only
on the clock.

Features (one ``WindowFeatures`` row per tenant per window; see the
reference module for their rationale):

  * ``stride_hist[:, 4]`` — normalized histogram of successive address
    deltas within a tenant's window, binned ``[+1, 0, 2 <= |s| <= 64,
    other]``; ``seq_fraction`` is its ``+1`` bin.
  * ``read_fraction`` — reads / accesses.
  * ``write_ratio`` — Alg. 3's ``(WAW + WAR) / n`` (write re-touches).
  * ``working_set`` — distinct addresses touched (Horvitz–Thompson
    scaled by ``1/rate`` when sampled).
  * ``jaccard_drift`` — ``1 - |A ∩ B| / |A ∪ B|`` between this window's
    distinct-address set and the previous window's.
  * ``reuse_intensity`` — re-touch fraction ``1 - distinct / n``.

``characterize_windows`` computes every tenant's row with tensor
reductions on the traces' device: the stream features from one
concatenated diff, the spatial ones from the replay engine's window
reuse distances (``dists[k]``, -1 at cold positions) where the caller
has them, otherwise from one occurrence-link pass
(``batch_sim.segment_links``) over the tenants' (possibly
SHARDS-filtered, ``shards_keep_mask`` with the window-stable
``characterize_salt``) sub-tape.  Every division is one IEEE float64
operation on integer counts, as in the reference, so the rows are
bit-identical to it on any device.  ``characterize_trace`` is the naive
single-tenant oracle (Python sets).

``PhaseDetector`` scores each tenant against an EMA baseline of its
feature vector and raises ``"phase"`` events past ``hi`` (re-armed
below ``lo``) and ``"write_ratio"`` events when the write ratio crosses
Alg. 3's threshold.  It runs on the host over numpy float64 scalars, the
reference's own arithmetic, so its scores, and the event log, match the
reference bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.batch_sim import segment_links
from repro_torch.core.reuse_distance import shards_keep_mask, shards_salt
from repro_torch.core.trace import Trace

__all__ = ["STRIDE_BINS", "PhaseDetector", "PhaseEvent", "WindowFeatures",
           "characterize_salt", "characterize_trace",
           "characterize_windows"]

# stride histogram bins: [+1 (sequential), 0 (repeat), 2<=|s|<=64 (local
# seek / semi-sequential), other (random)]
STRIDE_BINS = 4
_LOCAL_REACH = 64

# fixed seed for the characterization SHARDS filter: per-tenant salts are
# stable across windows so kept-set Jaccard drift is comparable
_CHAR_SEED = 0x5EC4


def characterize_salt(tenant: int) -> int:
    """Window-stable SHARDS salt for the characterization filter."""
    return shards_salt(_CHAR_SEED, int(tenant))


@dataclasses.dataclass(frozen=True)
class WindowFeatures:
    """Per-tenant workload features for one Δt window (see module doc).

    ``address_sets[k]`` is tenant k's sorted distinct (kept) address
    tensor — feed it back as ``prev_sets`` for the next window so
    ``jaccard_drift`` is populated.  ``sample_rates`` records the
    effective SHARDS rate per tenant (1.0 exact).
    """

    stride_hist: torch.Tensor      # float64[N, STRIDE_BINS], rows sum to 1
    seq_fraction: torch.Tensor     # float64[N] == stride_hist[:, 0]
    read_fraction: torch.Tensor    # float64[N]
    write_ratio: torch.Tensor      # float64[N]  Alg. 3 (WAW+WAR)/n
    working_set: torch.Tensor      # float64[N]  (HT-corrected when sampled)
    jaccard_drift: torch.Tensor    # float64[N]  1 - Jaccard vs prev window
    reuse_intensity: torch.Tensor  # float64[N]  re-touch fraction
    sample_rates: torch.Tensor     # float64[N]
    address_sets: list             # [N] sorted int64 distinct kept addrs


def _drift(cur: torch.Tensor, prev_set: torch.Tensor | None) -> float:
    """``1 - |cur ∩ prev| / |cur ∪ prev|`` of two sorted distinct address
    sets (0 without a previous set, or when both are empty)."""
    if prev_set is None or (cur.numel() == 0 and prev_set.numel() == 0):
        return 0.0
    prev_set = prev_set.to(cur.device)
    inter = int(torch.isin(cur, prev_set).sum())
    union = cur.numel() + prev_set.numel() - inter
    return 1.0 - inter / union


def characterize_trace(trace: Trace, prev_set: torch.Tensor | None = None,
                       rate: float = 1.0, salt: int | None = None
                       ) -> WindowFeatures:
    """Naive single-tenant oracle (Python sets and loops): one row of
    ``characterize_windows``, exact at ``rate == 1.0`` and on the
    identically filtered sub-trace otherwise."""
    dev = trace.addrs.device
    f64 = dict(dtype=torch.float64, device=dev)
    n = len(trace)
    addrs_l = trace.addrs.tolist()
    counts = [0] * STRIDE_BINS
    for a, b in zip(addrs_l[:-1], addrs_l[1:]):
        d = b - a
        counts[0 if d == 1 else 1 if d == 0
               else 2 if 2 <= abs(d) <= _LOCAL_REACH else 3] += 1
    den = max(sum(counts), 1)
    hist = [c / den for c in counts]
    read_fraction = float(trace.is_read.to(torch.bool).sum()) / max(n, 1)

    if rate < 1.0:
        keep = shards_keep_mask(trace.addrs, rate,
                                characterize_salt(0) if salt is None
                                else salt)
        addrs, is_read = trace.addrs[keep], trace.is_read[keep]
    else:
        addrs, is_read = trace.addrs, trace.is_read
    kept = addrs.shape[0]
    seen: set[int] = set()
    retouch_writes = retouches = 0
    for a, rd in zip(addrs.tolist(), is_read.to(torch.bool).tolist()):
        if a in seen:
            retouches += 1
            if not rd:
                retouch_writes += 1
        else:
            seen.add(a)
    distinct = len(seen)
    cur = torch.tensor(sorted(seen), dtype=torch.int64, device=dev)
    return WindowFeatures(
        stride_hist=torch.tensor([hist], **f64),
        seq_fraction=torch.tensor([hist[0]], **f64),
        read_fraction=torch.tensor([read_fraction], **f64),
        write_ratio=torch.tensor([retouch_writes / max(kept, 1)], **f64),
        working_set=torch.tensor([distinct / max(rate, 1e-300)], **f64),
        jaccard_drift=torch.tensor([_drift(cur, prev_set)], **f64),
        reuse_intensity=torch.tensor([retouches / max(kept, 1)], **f64),
        sample_rates=torch.tensor([float(rate)], **f64),
        address_sets=[cur])


def characterize_windows(traces: list[Trace],
                         prev_sets: list[torch.Tensor | None] | None = None,
                         dists: list[torch.Tensor | None] | None = None,
                         sample_rate: float | None = None,
                         tenant_ids: list[int] | None = None,
                         device: str | torch.device | None = None
                         ) -> WindowFeatures:
    """Batched per-(tenant, window) feature pass (see module doc).

    ``dists[k]`` optionally carries tenant k's window reuse-distance
    tensor (-1 at cold positions) from ``simulate_many(...,
    return_window_rd=True)``; those tenants need no link pass.
    ``prev_sets[k]`` is the previous window's ``address_sets[k]``.
    ``sample_rate`` routes tenants without distances through the SHARDS
    filter, salted by ``tenant_ids`` (default: positions).  Runs on
    ``device`` (default: the first trace's).
    """
    n = len(traces)
    dev = (torch.device(device) if device is not None
           else traces[0].addrs.device if traces else torch.device("cpu"))
    i64 = dict(dtype=torch.int64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    lens_l = [len(t) for t in traces]
    lens = torch.tensor(lens_l, **i64)
    prev_sets = prev_sets if prev_sets is not None else [None] * n
    dists = dists if dists is not None else [None] * n
    ids = list(tenant_ids) if tenant_ids is not None else list(range(n))
    addr_of = [t.addrs.to(dev, torch.int64) for t in traces]
    read_of = [t.is_read.to(dev, torch.bool) for t in traces]

    # ------------------------------------------ stream features, exact
    # successive deltas on the raw stream: one concatenated diff with the
    # window boundaries masked out
    hist = torch.zeros((n, STRIDE_BINS), **f64)
    read_fraction = torch.zeros(n, **f64)
    if sum(lens_l):
        addrs_all = torch.cat(addr_of)
        reads_all = torch.cat(read_of)
        tid = torch.repeat_interleave(torch.arange(n, **i64), lens)
        d = addrs_all[1:] - addrs_all[:-1]
        internal = tid[1:] == tid[:-1]          # sever at window boundaries
        a = torch.abs(d)
        bin_idx = torch.where(
            d == 1, 0, torch.where(
                d == 0, 1, torch.where((a >= 2) & (a <= _LOCAL_REACH), 2, 3)))
        key = tid[1:] * STRIDE_BINS + bin_idx
        counts = torch.bincount(key[internal], minlength=n * STRIDE_BINS
                                ).reshape(n, STRIDE_BINS)
        hist = (counts.to(torch.float64)
                / torch.clamp(counts.sum(1, keepdim=True), min=1)
                .to(torch.float64))
        read_fraction = (torch.bincount(tid[reads_all], minlength=n)
                         .to(torch.float64)
                         / torch.clamp(lens, min=1).to(torch.float64))
    seq_fraction = hist[:, 0].clone()

    # ------------------------------------------------ spatial features
    rates = [1.0] * n
    kept = [float(x) for x in lens_l]
    retouch, retouch_w, distinct = [0] * n, [0] * n, [0] * n
    sets: list[torch.Tensor | None] = [None] * n
    need = []
    for k in range(n):
        dk = dists[k]
        if dk is None:
            if lens_l[k] > 0:
                need.append(k)
            else:
                sets[k] = torch.zeros(0, **i64)
                if sample_rate is not None:
                    rates[k] = float(sample_rate)
            continue
        hot = dk.to(dev) >= 0
        retouch[k] = int(hot.sum())
        retouch_w[k] = int((hot & ~read_of[k]).sum())
        distinct[k] = lens_l[k] - retouch[k]
        sets[k] = torch.sort(addr_of[k][~hot]).values

    if need:
        if sample_rate is not None:
            r = float(sample_rate)
            if not (0 < r <= 1):
                raise ValueError("sample_rate must be in (0, 1]")
            keeps = [shards_keep_mask(addr_of[k], r,
                                      characterize_salt(int(ids[k])))
                     for k in need]
            for k in need:
                rates[k] = r
        else:
            keeps = [torch.ones(lens_l[k], dtype=torch.bool, device=dev)
                     for k in need]
        sub_addr = torch.cat([addr_of[k][kp] for k, kp in zip(need, keeps)])
        sub_read = torch.cat([read_of[k][kp] for k, kp in zip(need, keeps)])
        sub_lens = torch.stack([kp.sum() for kp in keeps]).to(torch.int64)
        sub_tid = torch.repeat_interleave(
            torch.arange(len(need), **i64), sub_lens)
        sub_end = torch.cumsum(sub_lens, 0)[sub_tid]
        prev, _, _, _ = segment_links(sub_addr, sub_tid, sub_end)
        cold = prev < 0
        nn = len(need)
        r_c = torch.bincount(sub_tid[~cold], minlength=nn).tolist()
        r_w = torch.bincount(sub_tid[~cold & ~sub_read], minlength=nn).tolist()
        d_c = torch.bincount(sub_tid[cold], minlength=nn).tolist()
        bounds = [0] + torch.cumsum(sub_lens, 0).tolist()
        for j, k in enumerate(need):
            kept[k] = float(bounds[j + 1] - bounds[j])
            retouch[k], retouch_w[k], distinct[k] = r_c[j], r_w[j], d_c[j]
            seg = slice(bounds[j], bounds[j + 1])
            sets[k] = torch.sort(sub_addr[seg][cold[seg]]).values

    rates_t = torch.tensor(rates, **f64)
    kept_t = torch.clamp(torch.tensor(kept, **f64), min=1.0)
    working_set = (torch.tensor(distinct, **i64).to(torch.float64)
                   / torch.clamp(rates_t, min=1e-300))
    write_ratio = torch.tensor(retouch_w, **i64).to(torch.float64) / kept_t
    reuse_intensity = torch.tensor(retouch, **i64).to(torch.float64) / kept_t
    drift = torch.tensor([_drift(sets[k], prev_sets[k]) for k in range(n)],
                         **f64)
    return WindowFeatures(
        stride_hist=hist, seq_fraction=seq_fraction,
        read_fraction=read_fraction, write_ratio=write_ratio,
        working_set=working_set, jaccard_drift=drift,
        reuse_intensity=reuse_intensity, sample_rates=rates_t,
        address_sets=sets)


# --------------------------------------------------------- phase detection
@dataclasses.dataclass(frozen=True)
class PhaseEvent:
    """One detected phase change: tenant, window, why, how large."""

    window: int
    tenant: int
    reason: str          # "phase" | "write_ratio"
    score: float


class PhaseDetector:
    """Hysteresis-thresholded per-tenant change detector (see module doc).

    ``hi``/``lo`` are the trigger/re-arm thresholds on the change score,
    ``ema`` the baseline update weight, ``ws_scale`` the log2 working-set
    normalization, ``drift_weight`` the weight of excess Jaccard drift,
    ``w_threshold`` (optional) the Alg.-3 boundary whose crossing always
    raises a ``"write_ratio"`` event, ``warmup`` the post-init windows
    scored into the baseline before triggers arm.
    """

    def __init__(self, hi: float = 0.25, lo: float = 0.10,
                 ema: float = 0.5, ws_scale: float = 3.0,
                 drift_weight: float = 0.5,
                 w_threshold: float | None = None, warmup: int = 1):
        if not (0.0 <= lo <= hi):
            raise ValueError(f"need 0 <= lo <= hi, got lo={lo} hi={hi}")
        self.hi, self.lo = float(hi), float(lo)
        self.ema = float(ema)
        self.ws_scale = float(ws_scale)
        self.drift_weight = float(drift_weight)
        self.w_threshold = (None if w_threshold is None
                            else float(w_threshold))
        self.warmup = max(int(warmup), 0)
        self._base: dict[int, np.ndarray] = {}
        self._base_wr: dict[int, float] = {}
        self._base_drift: dict[int, float | None] = {}
        self._armed: dict[int, bool] = {}
        self._seen: dict[int, int] = {}

    def _fvec(self, f: dict[str, np.ndarray], k: int) -> np.ndarray:
        return np.array([
            f["seq_fraction"][k],
            f["read_fraction"][k],
            f["write_ratio"][k],
            f["reuse_intensity"][k],
            np.log2(max(f["working_set"][k], 0.0) + 1.0) / self.ws_scale,
        ])

    def forget(self, tenant: int) -> None:
        """Drop a retired tenant's state (a later re-join is a cold start)."""
        self._base.pop(tenant, None)
        self._base_wr.pop(tenant, None)
        self._base_drift.pop(tenant, None)
        self._armed.pop(tenant, None)
        self._seen.pop(tenant, None)

    def update(self, feats: WindowFeatures, window: int,
               tenant_ids=None) -> list[PhaseEvent]:
        """Score one window's features; return triggered events."""
        f = {name: getattr(feats, name).cpu().numpy()
             for name in ("seq_fraction", "read_fraction", "write_ratio",
                          "reuse_intensity", "working_set",
                          "jaccard_drift")}
        n = f["read_fraction"].shape[0]
        ids = list(tenant_ids) if tenant_ids is not None else list(range(n))
        events: list[PhaseEvent] = []
        for k, t in enumerate(ids):
            t = int(t)
            fvec = self._fvec(f, k)
            wr = float(f["write_ratio"][k])
            drift = float(f["jaccard_drift"][k])
            base = self._base.get(t)
            if base is None:                     # cold start: baseline only
                self._base[t] = fvec
                self._base_wr[t] = wr
                self._base_drift[t] = None
                self._armed[t] = True
                self._seen[t] = 1
                continue
            self._seen[t] += 1
            if self._seen[t] <= self.warmup + 1:
                # warm-up: replace the baseline with this warmed window
                # rather than averaging the cold-start transient in
                self._base[t] = fvec
                self._base_wr[t] = wr
                self._base_drift[t] = drift
                continue
            score = float(np.max(np.abs(fvec - base)))
            bd = self._base_drift[t]
            if bd is not None:
                score = max(score, self.drift_weight * max(0.0, drift - bd))
            crossed = (self.w_threshold is not None
                       and (self._base_wr[t] >= self.w_threshold)
                       != (wr >= self.w_threshold))
            armed = self._armed[t]
            if armed and (score >= self.hi or crossed):
                events.append(PhaseEvent(
                    window, t, "write_ratio" if crossed else "phase",
                    score))
                # full cold restart: the next window becomes the reference
                self.forget(t)
                continue
            if not armed and score < self.lo:
                self._armed[t] = True
            a = self.ema
            self._base[t] = (1.0 - a) * base + a * fvec
            self._base_wr[t] = (1.0 - a) * self._base_wr[t] + a * wr
            self._base_drift[t] = (drift if bd is None
                                   else (1.0 - a) * bd + a * drift)
        return events
