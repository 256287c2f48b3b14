"""Monitor → Analyzer → Actuator loop (paper Fig. 8, Alg. 1/3/4).

``ECICacheManager`` is the hypervisor-level controller:

  * ``Monitor``  — accumulates per-tenant (addr, r/w) events for the
    current Δt window.
  * ``Analyzer`` — at window boundaries computes URD (or TRD for the
    Centaur baseline), builds H_i(c), estimates URD-based sizes, checks
    feasibility, and — when infeasible — runs the Eq.-2 partitioner;
    also assigns write policies (Alg. 3).
  * ``Actuator`` — resizes the per-tenant LRU partitions (evicting
    LRU-first on shrink) and switches write policies.

Port of ``repro.core.manager`` for the fault-free deployment, with one
cache level or the ETICA two-level hierarchy (``capacity2 > 0``): each
``run_window`` replays every tenant's window in one
``batch_sim.simulate_many`` pass (or, with ``engine="lru"``, through the
per-access interpreter ``simulator.simulate``), analyzes it with
``monitor.analyze_windows``, solves Eq. 2 per level with
``two_level_solve`` (``pgd_solve`` by default), checks the decision with
``guard.validate_decision`` and actuates it.  The monitor is exact below
``auto_sample_tenants`` (256) tenants, reusing the replay pass's reuse
distances, and SHARDS-sampled from there on (or whenever
``sample_rate`` is set; see ``effective_sample_rate``).

With ``phase_detect=True`` the analyze/actuate half is event-driven
(ReCA-style): each replayed window is characterized
(``core.characterize``, on the replay's window reuse distances) and a
hysteresis ``PhaseDetector`` scores every tenant; the Analyzer runs only
on a phase change, an Alg.-3 write-ratio crossing, a tenant joining
(``add_tenant``) or retiring, or every ``reconfig_interval`` windows.
Windows in between accumulate in the Monitor, and the analyze that ends
them re-counts the whole span.  Everything runs on the manager's
``device`` — the CUDA card unless the caller asks for the CPU.  With
``pipeline="device"`` each analyze runs through the device window
pipeline (``core.device_pipeline``; percentile 100 only, below it the
host pipeline).  The reference's sharded pipeline (item 4) and its fault
injection and degradation ladder (item 3b) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch.core.batch_sim import simulate_many
from repro_torch.core.characterize import PhaseDetector, characterize_windows
from repro_torch.core.guard import validate_decision
from repro_torch.core.monitor import analyze_windows
from repro_torch.core.mrc import HitRatioFunction
from repro_torch.core.partitioner import (PartitionResult, pgd_solve,
                                          two_level_solve)
from repro_torch.core.profile import StageProfile, pstage
from repro_torch.core.simulator import LRUCache, SimResult, simulate
from repro_torch.core.trace import Trace, validate_trace_arrays
from repro_torch.core.write_policy import WritePolicy
from repro_torch.device import resolve_device

__all__ = ["TenantState", "AnalyzerDecision", "ReconfigEvent",
           "ECICacheManager"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


@dataclasses.dataclass
class TenantState:
    name: str
    cache: LRUCache
    policy: WritePolicy = WritePolicy.WB        # paper: WB initially
    h_fn: HitRatioFunction | None = None
    urd_size: int = 0
    window_addrs: list[torch.Tensor] = dataclasses.field(default_factory=list)
    window_reads: list[torch.Tensor] = dataclasses.field(default_factory=list)
    result: SimResult = dataclasses.field(default_factory=SimResult)
    active: bool = True                         # finished tenants are excluded
    # second hierarchy level (ETICA): its partition and write policy
    cache2: LRUCache = dataclasses.field(
        default_factory=lambda: LRUCache(0))
    policy2: WritePolicy = WritePolicy.WB

    def window_trace(self) -> Trace:
        dev = self.cache.state_arrays()[0].device
        if not self.window_addrs:
            return Trace(torch.zeros(0, dtype=torch.int64, device=dev),
                         torch.zeros(0, dtype=torch.bool, device=dev),
                         self.name)
        return Trace(torch.cat(self.window_addrs),
                     torch.cat(self.window_reads), self.name)

    def clear_window(self) -> None:
        self.window_addrs.clear()
        self.window_reads.clear()


@dataclasses.dataclass(frozen=True)
class ReconfigEvent:
    """Why the Analyzer ran (event-driven mode telemetry).

    reason: "phase" (detector score crossed ``hi``), "write_ratio"
    (Alg.-3 threshold crossing), "interval" (the fixed-Δt fallback
    clock), "join" / "retire" (tenant churn).  ``tenant`` is the manager
    index, -1 for deployment-wide triggers.
    """

    window: int
    tenant: int
    reason: str
    score: float = 0.0


@dataclasses.dataclass(frozen=True)
class AnalyzerDecision:
    sizes: torch.Tensor                # int64[N] on the host
    policies: list[WritePolicy]
    feasible: bool
    partition: PartitionResult
    # the second level (zeros / WB / None for a single-level manager)
    sizes2: torch.Tensor | None = None
    policies2: list[WritePolicy] | None = None
    partition2: PartitionResult | None = None
    trigger: tuple[ReconfigEvent, ...] = ()
    # guard violations detected (non-empty = an actuated violation)
    guard: tuple[str, ...] = ()
    # the monitor's SHARDS rate per analyzed tenant (1.0 = exact)
    sample_rates: torch.Tensor | None = None


class ECICacheManager:
    """Dynamic per-tenant cache sizing (URD) + write-policy assignment.

    Parameters mirror the paper's setup: ``capacity`` in blocks,
    ``c_min`` initial/minimum per-tenant blocks, ``w_threshold`` for
    Alg. 3, ``t_fast``/``t_slow`` the fast/slow tier service times.
    ``rd_kind='trd'`` + ``adaptive_policy=False`` turns this manager into
    the **Centaur** baseline (TRD sizing, WB everywhere).

    ``sample_rate`` selects the Monitor's SHARDS spatial sampling:
    ``None`` (exact below ``auto_sample_tenants`` tenants, ``"auto"``
    from there on), a fixed rate in (0, 1], or ``"auto"`` (aim for
    ``sample_target`` kept accesses per tenant window, exact below
    ``sample_floor``).

    ``capacity2 > 0`` makes each tenant's partition an ETICA two-level
    hierarchy: an L1 and an L2 LRU partition, sized by
    ``two_level_solve`` (the level-2 Eq. 2 on the residual curves with
    service time ``t_fast2``, default ``3 * t_fast``), with per-level
    Alg. 3 (``w_threshold`` for L1, the stricter ``w_threshold2`` for
    L2, whose clean policy flushes dirty victims at demotion).
    ``capacity2 == 0`` is the single-level scheme.  ``phase_detect``
    turns on event-driven reconfiguration (module docstring) with the
    fallback clock ``reconfig_interval`` (1 analyzes every window); the
    detector keeps ``PhaseDetector``'s default thresholds.  ``engine="lru"``
    replays through the per-access interpreter instead of the batch
    engine; both give the same results.

    ``device`` is where the replay, the monitor and the partitioner run:
    ``None`` means the CUDA card (an error names ``device="cpu"`` when
    none is visible).  ``profile`` (a ``StageProfile``) times the stages
    of each window: ``tape``, ``ro_replay``, ``count``, ``replay``,
    ``monitor`` and ``pgd`` (the manager binds it to its ``device``).
    ``pipeline`` is ``"host"`` (the fused host monitor, reusing the
    replay's distances) or ``"device"`` (the device window pipeline,
    which recounts; percentile 100 only).  ``history_limit`` bounds the retained
    decisions and events.
    """

    def __init__(self, capacity: int, tenant_names: list[str],
                 c_min: int = 1000, w_threshold: float = 0.5,
                 t_fast: float = 1.0, t_slow: float = 20.0,
                 t_write_bypass: float | None = None, flush_cost: float = 0.0,
                 rd_kind: str = "urd",
                 # the adaptive write policy IS the paper's ECI scheme
                 # (Alg. 2) — shipping it on is the reproduction contract;
                 # the off-path is the Centaur baseline, pinned against
                 # the goldens in test_torch_control_loop.
                 adaptive_policy: bool = True,  # repro-lint: disable=RL003
                 sample_rate: float | str | None = None,
                 sample_target: int = 4096, sample_floor: int = 256,
                 initial_blocks: int | None = None,
                 percentile: float = 100.0,
                 partition_fn: Callable = pgd_solve,
                 engine: str = "batch",
                 capacity2: int = 0, t_fast2: float | None = None,
                 w_threshold2: float = 0.3,
                 history_limit: int | None = 256,
                 auto_sample_tenants: int = 256,
                 phase_detect: bool = False, reconfig_interval: int = 1,
                 pipeline: str = "host",
                 faults=None, fault_tolerant: bool | None = None,
                 device: str | torch.device | None = None,
                 profile: StageProfile | None = None):
        if engine not in ("batch", "lru"):
            raise ValueError(f"engine must be 'batch' or 'lru', got "
                             f"{engine!r}")
        if pipeline not in ("host", "device", "sharded"):
            raise ValueError(f"pipeline must be 'host', 'device' or "
                             f"'sharded', got {pipeline!r}")
        if pipeline == "sharded":
            raise _not_ported("pipeline='sharded'",
                              "modules queue, item 4, core/shard_pipeline.py")
        if faults is not None or fault_tolerant:
            raise _not_ported("fault injection and the degradation ladder",
                              "modules queue, item 3b, faults.py and the "
                              "ladder")
        self.device = resolve_device(device)
        self.profile = (profile.bind(self.device) if profile is not None
                        else None)
        # "device" analyzes each window through the device window
        # pipeline (one host sync a window); the host pipeline serves
        # percentiles below 100
        self.pipeline = pipeline
        self.capacity = int(capacity)
        self.capacity2 = int(capacity2)
        self.c_min = int(c_min)
        self.w_threshold = float(w_threshold)
        self.w_threshold2 = float(w_threshold2)
        self.t_fast, self.t_slow = float(t_fast), float(t_slow)
        self.t_fast2 = (3.0 * t_fast if t_fast2 is None else float(t_fast2))
        self.t_write_bypass = (1.2 * t_fast if t_write_bypass is None
                               else float(t_write_bypass))
        self.flush_cost = float(flush_cost)
        self.rd_kind = rd_kind
        self.adaptive_policy = adaptive_policy
        self.sample_rate = sample_rate
        self.sample_target = int(sample_target)
        self.sample_floor = int(sample_floor)
        self.auto_sample_tenants = int(auto_sample_tenants)
        self.percentile = percentile
        self.partition_fn = partition_fn
        self.engine = engine
        init = int(initial_blocks if initial_blocks is not None else c_min)
        self.tenants = [TenantState(nm, LRUCache(init, self.device),
                                    cache2=LRUCache(0, self.device))
                        for nm in tenant_names]
        self.history: collections.deque[AnalyzerDecision] = \
            collections.deque(maxlen=history_limit)
        self.events: collections.deque[ReconfigEvent] = \
            collections.deque(maxlen=history_limit)
        self.windows_analyzed = 0
        self.tenant_windows = 0         # replayed tenant-windows
        self.windows_run = 0            # run_window calls (>= analyzed)
        # event-driven reconfiguration (off: analyze every window)
        self.reconfig_interval = max(int(reconfig_interval), 1)
        self.detector = (PhaseDetector(
            w_threshold=(w_threshold if adaptive_policy else None))
            if phase_detect else None)
        self._pending_windows = 0       # replayed but not yet analyzed
        self._prev_sets: dict[int, torch.Tensor] = {}  # drift continuity
        self._joined: list[int] = []    # tenants added since last window
        self.reconfig_events = 0        # total events ever (deque is bounded)
        self.guard_violations_observed = 0
        self.guard_violations_actuated = 0
        # tenant-windows the batch engine replayed through the interpreter
        # (degenerate two-level windows only)
        self.ro_fallback_windows = 0

    # ------------------------------------------------------------- Monitor
    def record(self, tenant: int, addrs, is_read) -> None:
        """Ingest one tenant's window events (raises ``TraceError`` with
        (tenant, window) coordinates on a malformed tape)."""
        validate_trace_arrays(addrs, is_read, tenant=tenant,
                              window=self.windows_run)
        t = self.tenants[tenant]
        t.window_addrs.append(
            torch.as_tensor(addrs).to(self.device, torch.int64))
        t.window_reads.append(
            torch.as_tensor(is_read).to(self.device, torch.bool))

    def add_tenant(self, name: str,
                   initial_blocks: int | None = None) -> int:
        """Tenant churn: a workload joins mid-run.  Returns its index.

        The next ``run_window`` records a ``"join"`` event; in
        event-driven mode that forces an analyze, so the newcomer is
        sized from its first window.
        """
        init = int(initial_blocks if initial_blocks is not None
                   else self.c_min)
        self.tenants.append(TenantState(name, LRUCache(init, self.device),
                                        cache2=LRUCache(0, self.device)))
        i = len(self.tenants) - 1
        self._joined.append(i)
        return i

    def retire_tenant(self, tenant: int) -> None:
        """Workload finished: release its partition (paper §6.3)."""
        t = self.tenants[tenant]
        t.active = False
        t.cache.resize(0)
        t.cache2.resize(0)
        self._prev_sets.pop(tenant, None)
        if self.detector is not None:
            self.detector.forget(tenant)

    # ------------------------------------------------------------ Analyzer
    def effective_sample_rate(self) -> float | str | None:
        """Resolve the Monitor's sampling mode for the current deployment."""
        if self.sample_rate is None \
                and len(self.tenants) >= self.auto_sample_tenants:
            return "auto"
        return self.sample_rate

    def _build_decision(self, mon, act: list[int],
                        trigger: tuple[ReconfigEvent, ...]
                        ) -> tuple[AnalyzerDecision, torch.Tensor]:
        """Alg. 3 + Eq. 2 over one monitor result.  Returns the decision
        and the guard floors."""
        urd = mon.urd_sizes.tolist()
        wrs = mon.write_ratios.tolist()
        for k, i in enumerate(act):
            t = self.tenants[i]
            t.h_fn = mon.curves[k]
            t.urd_size = int(urd[k])
            if self.adaptive_policy:
                # Alg. 3 writeRatio = (WAW + WAR)/n: write re-touches are
                # exactly the writes with a TRD sample
                t.policy = (WritePolicy.RO if wrs[k] >= self.w_threshold
                            else WritePolicy.WB)
                if self.capacity2 > 0:
                    # per-level Alg. 3: the endurance-sensitive L2 turns
                    # clean at a stricter threshold
                    t.policy2 = (WritePolicy.RO if wrs[k] >= self.w_threshold2
                                 else WritePolicy.WB)
        with pstage(self.profile, "pgd"):
            part, part2 = two_level_solve(
                mon.curves, self.capacity, self.capacity2, self.t_fast,
                self.t_fast2, self.t_slow, c_min=self.c_min,
                partition_fn=self.partition_fn)
        n_ten = len(self.tenants)
        sizes_full = torch.zeros(n_ten, dtype=torch.int64)
        sizes2_full = torch.zeros(n_ten, dtype=torch.int64)
        floors = torch.zeros(n_ten, dtype=torch.int64)
        part_sizes = part.sizes.tolist()
        part2_sizes = part2.sizes.tolist() if part2 is not None else None
        k = 0
        for i, t in enumerate(self.tenants):
            if not t.active:
                continue
            sizes_full[i] = part_sizes[k]
            if part2_sizes is not None:
                sizes2_full[i] = part2_sizes[k]
            floors[i] = min(self.c_min, t.urd_size)
            k += 1
        decision = AnalyzerDecision(sizes_full,
                                    [t.policy for t in self.tenants],
                                    part.feasible, part,
                                    sizes2=sizes2_full,
                                    policies2=[t.policy2
                                               for t in self.tenants],
                                    partition2=part2,
                                    trigger=tuple(trigger),
                                    sample_rates=mon.sample_rates.cpu())
        return decision, floors

    def analyze(self, window_trd: dict[int, torch.Tensor] | None = None,
                trigger: tuple[ReconfigEvent, ...] = ()
                ) -> AnalyzerDecision:
        """Alg. 1 / Alg. 4: run at every Δt window boundary.

        All active tenants are analyzed in one fused pass
        (``analyze_windows``), SHARDS-sampled when
        ``effective_sample_rate()`` says so; ``window_trd`` carries the
        per-tenant TRD sample tensors the batch engine already counted,
        which the exact path reuses instead of re-counting.  The decision
        is checked by the guard; a violation is recorded on the decision
        (and counted when actuated).
        """
        window_trd = window_trd or {}
        rate = self.effective_sample_rate()
        act = [i for i, t in enumerate(self.tenants) if t.active]
        pipe = self.pipeline if self.percentile >= 100.0 else "host"
        with pstage(self.profile, "monitor"):
            # the device pipeline recounts on the device: the replay's
            # distances go to the host pipeline only
            mon = analyze_windows(
                [self.tenants[i].window_trace() for i in act],
                kind=self.rd_kind, percentile=self.percentile,
                sample_rate=rate, window_seed=self.windows_analyzed,
                sample_target=self.sample_target,
                sample_floor=self.sample_floor,
                precomputed_trd=(None if rate is not None or pipe != "host"
                                 else [window_trd.get(i) for i in act]),
                tenant_ids=act, pipeline=pipe, device=self.device)
        self.windows_analyzed += 1
        decision, floors = self._build_decision(mon, act, trigger)
        report = validate_decision(decision, self.capacity, self.capacity2,
                                   floors=floors,
                                   floor_budget=self.capacity)
        if not report.ok:
            self.guard_violations_observed += len(report.violations)
            decision = dataclasses.replace(decision,
                                           guard=report.violations)
        self.history.append(decision)
        return decision

    # ------------------------------------------------------------ Actuator
    def actuate(self, decision: AnalyzerDecision) -> None:
        if decision.guard:
            # a violating decision is shipped; count it so garbage never
            # actuates silently
            self.guard_violations_actuated += 1
        sizes2 = (decision.sizes2 if decision.sizes2 is not None
                  else torch.zeros(len(self.tenants), dtype=torch.int64))
        for t, size, size2 in zip(self.tenants, decision.sizes.tolist(),
                                  sizes2.tolist()):
            if t.active:
                t.cache.resize(int(size))
                if self.capacity2 > 0 or t.cache2.capacity > 0:
                    t.cache2.resize(int(size2))
                t.clear_window()

    # --------------------------------------------------------- trace replay
    def _accumulate(self, t: TenantState, res: SimResult) -> None:
        agg = t.result
        agg.reads += res.reads; agg.read_hits += res.read_hits
        agg.writes += res.writes; agg.write_hits += res.write_hits
        agg.cache_writes += res.cache_writes
        agg.total_latency += res.total_latency
        agg.read_hits_l2 += res.read_hits_l2
        agg.write_hits_l2 += res.write_hits_l2
        agg.cache_writes_l2 += res.cache_writes_l2
        agg.fallback += res.fallback
        agg.capacity = t.cache.capacity
        agg.capacity2 = t.cache2.capacity
        agg.policy = t.policy.value
        agg.policy2 = t.policy2.value

    def _drain_joined(self, window: int) -> list[ReconfigEvent]:
        """Pending ``add_tenant`` joins -> churn events (not yet recorded)."""
        evs = [ReconfigEvent(window, i, "join") for i in self._joined]
        self._joined.clear()
        return evs

    def _record_events(self, events: list[ReconfigEvent]) -> None:
        self.events.extend(events)
        self.reconfig_events += len(events)

    def run_window(self, traces: list[Trace | None]) -> None:
        """Replay one Δt window for every tenant, then analyze + actuate.

        ``traces[i] is None`` marks tenant i as finished (a "retire"
        event).  With ``phase_detect`` the analyze/actuate half runs only
        when the detector, a churn event or the ``reconfig_interval``
        clock triggers it; the replay half always runs.
        """
        win = self.windows_run
        events = self._drain_joined(win)
        for i, tr in enumerate(traces):
            if tr is None and self.tenants[i].active:
                self.retire_tenant(i)
                events.append(ReconfigEvent(win, i, "retire"))

        idx = [i for i, tr in enumerate(traces) if tr is not None]
        for i in idx:
            self.record(i, traces[i].addrs, traces[i].is_read)

        window_trd: dict[int, torch.Tensor] = {}
        if self.engine == "batch":
            results, rds = simulate_many(
                [traces[i] for i in idx],
                policies=[self.tenants[i].policy for i in idx],
                t_fast=self.t_fast, t_slow=self.t_slow,
                t_write_bypass=self.t_write_bypass,
                flush_cost=self.flush_cost,
                caches=[self.tenants[i].cache for i in idx],
                policies2=[self.tenants[i].policy2 for i in idx],
                caches2=[self.tenants[i].cache2 for i in idx],
                t_fast2=self.t_fast2,
                return_window_rd=True, device=self.device,
                profile=self.profile)
            window_trd = {i: rd for i, rd in zip(idx, rds) if rd is not None}
            self.ro_fallback_windows += sum(r.fallback for r in results)
        else:
            results = []
            with pstage(self.profile, "replay"):
                for i in idx:
                    t = self.tenants[i]
                    results.append(simulate(
                        traces[i], t.cache.capacity, t.policy, self.t_fast,
                        self.t_slow, t_write_bypass=self.t_write_bypass,
                        flush_cost=self.flush_cost, cache=t.cache,
                        capacity2=t.cache2.capacity, policy2=t.policy2,
                        t_fast2=self.t_fast2, cache2=t.cache2))
        for i, res in zip(idx, results):
            self._accumulate(self.tenants[i], res)
        self.tenant_windows += len(idx)
        self.windows_run += 1

        if self.detector is None:
            # fixed-Δt mode: analyze + actuate every window (churn events
            # are telemetry only)
            self._record_events(events)
            self.actuate(self.analyze(window_trd))
            return

        # ------------------------------------- event-driven mode (ReCA)
        # characterize this window on the replay's window reuse distances
        feats = characterize_windows(
            [traces[i] for i in idx],
            prev_sets=[self._prev_sets.get(i) for i in idx],
            dists=[window_trd.get(i) for i in idx], tenant_ids=idx,
            device=self.device)
        for k, i in enumerate(idx):
            self._prev_sets[i] = feats.address_sets[k]
        events.extend(ReconfigEvent(win, e.tenant, e.reason, e.score)
                      for e in self.detector.update(feats, win, idx))
        self._pending_windows += 1
        if self._pending_windows >= self.reconfig_interval:
            events.append(ReconfigEvent(win, -1, "interval"))
        if events:
            # a multi-window accumulation invalidates the single-window
            # distances: the Analyzer re-counts the whole span
            wtrd = window_trd if self._pending_windows == 1 else None
            self._record_events(events)
            self.actuate(self.analyze(wtrd, trigger=tuple(events)))
            self._pending_windows = 0

    # ------------------------------------------------------------- metrics
    def allocated_sizes(self) -> torch.Tensor:
        return torch.tensor([t.cache.capacity for t in self.tenants],
                            dtype=torch.int64)

    def allocated_sizes2(self) -> torch.Tensor:
        return torch.tensor([t.cache2.capacity for t in self.tenants],
                            dtype=torch.int64)

    def summary(self) -> dict[str, float]:
        res = [t.result for t in self.tenants]
        n = sum(r.n for r in res)
        lat = sum(r.total_latency for r in res)
        writes = sum(r.cache_writes for r in res)
        alloc = int(self.allocated_sizes().sum())
        mean_lat = lat / n if n else 0.0
        return {
            "accesses": n,
            "mean_latency": mean_lat,
            "performance": 1.0 / mean_lat if mean_lat else 0.0,
            "cache_writes": writes,
            "allocated_blocks": alloc,
            "perf_per_cost": (1.0 / mean_lat) / alloc if mean_lat and alloc else 0.0,
            "read_hit_ratio": (sum(r.read_hits for r in res)
                               / max(sum(r.reads for r in res), 1)),
            "cache_writes_l2": sum(r.cache_writes_l2 for r in res),
            "allocated_blocks_l2": int(self.allocated_sizes2().sum()),
            "read_hit_ratio_l2": (sum(r.read_hits_l2 for r in res)
                                  / max(sum(r.reads for r in res), 1)),
            # tenant-windows the batch engine replayed through the
            # interpreter (degenerate two-level windows only)
            "ro_fallback_windows": self.ro_fallback_windows,
            "tenant_windows": self.tenant_windows,
            "windows_run": self.windows_run,
            "windows_analyzed": self.windows_analyzed,
            "reconfig_events": self.reconfig_events,
            # decisions that broke a guard invariant (all 0 when healthy)
            "guard_violations_observed": self.guard_violations_observed,
            "guard_violations_actuated": self.guard_violations_actuated,
        }
