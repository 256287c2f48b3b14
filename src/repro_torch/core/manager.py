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

Port of ``repro.core.manager`` for the fixed-Δt, single-level,
fault-free deployment: each ``run_window`` replays every tenant's window
in one ``batch_sim.simulate_many`` pass, analyzes it with
``monitor.analyze_windows``, solves Eq. 2 with ``pgd_solve``, checks the
decision with ``guard.validate_decision`` and actuates it.  The monitor
is exact below ``auto_sample_tenants`` (256) tenants, reusing the replay
pass's reuse distances, and SHARDS-sampled from there on (or whenever
``sample_rate`` is set; see ``effective_sample_rate``).  Everything runs
on the manager's ``device`` — the CUDA card unless the caller asks for
the CPU.  The reference's other paths (event-driven reconfiguration,
fault injection and the degradation ladder, the device and sharded
pipelines, the two-level hierarchy, the per-access interpreter) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch.core.batch_sim import simulate_many
from repro_torch.core.guard import validate_decision
from repro_torch.core.monitor import analyze_windows
from repro_torch.core.mrc import HitRatioFunction
from repro_torch.core.partitioner import (PartitionResult, pgd_solve,
                                          two_level_solve)
from repro_torch.core.profile import StageProfile, pstage
from repro_torch.core.simulator import LRUCache, SimResult
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
    """Tenant churn telemetry: reason "retire"; ``tenant`` is the
    manager index."""

    window: int
    tenant: int
    reason: str


@dataclasses.dataclass(frozen=True)
class AnalyzerDecision:
    sizes: torch.Tensor                # int64[N] on the host
    policies: list[WritePolicy]
    feasible: bool
    partition: PartitionResult
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

    ``device`` is where the replay, the monitor and the partitioner run:
    ``None`` means the CUDA card (an error names ``device="cpu"`` when
    none is visible).  ``profile`` (a ``StageProfile``) times the stages
    of each window: ``tape``, ``ro_replay``, ``count``, ``replay``,
    ``monitor`` and ``pgd``.  ``history_limit`` bounds the retained
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
                 capacity2: int = 0,
                 history_limit: int | None = 256,
                 auto_sample_tenants: int = 256,
                 phase_detect: bool = False, pipeline: str = "host",
                 faults=None, fault_tolerant: bool | None = None,
                 device: str | torch.device | None = None,
                 profile: StageProfile | None = None):
        if engine != "batch":
            raise _not_ported(f"engine={engine!r} (the per-access "
                              "interpreter)", "modules queue, simulate")
        if pipeline != "host":
            raise _not_ported(f"pipeline={pipeline!r}",
                              "modules queue, device and shard pipelines")
        if capacity2 > 0:
            raise _not_ported("the two-level hierarchy (capacity2 > 0)",
                              "modules queue, two-level")
        if phase_detect:
            raise _not_ported("event-driven reconfiguration (phase_detect)",
                              "modules queue, characterize/faults/scenarios")
        if faults is not None or fault_tolerant:
            raise _not_ported("fault injection and the degradation ladder",
                              "modules queue, characterize/faults/scenarios")
        self.device = resolve_device(device)
        self.profile = profile
        self.capacity = int(capacity)
        self.c_min = int(c_min)
        self.w_threshold = float(w_threshold)
        self.t_fast, self.t_slow = float(t_fast), float(t_slow)
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
        init = int(initial_blocks if initial_blocks is not None else c_min)
        self.tenants = [TenantState(nm, LRUCache(init, self.device))
                        for nm in tenant_names]
        self.history: collections.deque[AnalyzerDecision] = \
            collections.deque(maxlen=history_limit)
        self.events: collections.deque[ReconfigEvent] = \
            collections.deque(maxlen=history_limit)
        self.windows_analyzed = 0
        self.tenant_windows = 0         # replayed tenant-windows
        self.windows_run = 0
        self.reconfig_events = 0        # total events ever (deque is bounded)
        self.guard_violations_observed = 0
        self.guard_violations_actuated = 0

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

    def retire_tenant(self, tenant: int) -> None:
        """Workload finished: release its partition (paper §6.3)."""
        t = self.tenants[tenant]
        t.active = False
        t.cache.resize(0)

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
        with pstage(self.profile, "pgd"):
            part, _ = two_level_solve(
                mon.curves, self.capacity, 0, self.t_fast, 3.0 * self.t_fast,
                self.t_slow, c_min=self.c_min, partition_fn=self.partition_fn)
        n_ten = len(self.tenants)
        sizes_full = torch.zeros(n_ten, dtype=torch.int64)
        floors = torch.zeros(n_ten, dtype=torch.int64)
        part_sizes = part.sizes.tolist()
        k = 0
        for i, t in enumerate(self.tenants):
            if not t.active:
                continue
            sizes_full[i] = part_sizes[k]
            floors[i] = min(self.c_min, t.urd_size)
            k += 1
        decision = AnalyzerDecision(sizes_full,
                                    [t.policy for t in self.tenants],
                                    part.feasible, part,
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
        with pstage(self.profile, "monitor"):
            mon = analyze_windows(
                [self.tenants[i].window_trace() for i in act],
                kind=self.rd_kind, percentile=self.percentile,
                sample_rate=rate, window_seed=self.windows_analyzed,
                sample_target=self.sample_target,
                sample_floor=self.sample_floor,
                precomputed_trd=(None if rate is not None
                                 else [window_trd.get(i) for i in act]),
                tenant_ids=act, device=self.device)
        self.windows_analyzed += 1
        decision, floors = self._build_decision(mon, act, trigger)
        report = validate_decision(decision, self.capacity, floors=floors,
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
        for t, size in zip(self.tenants, decision.sizes.tolist()):
            if t.active:
                t.cache.resize(int(size))
                t.clear_window()

    # --------------------------------------------------------- trace replay
    def _accumulate(self, t: TenantState, res: SimResult) -> None:
        agg = t.result
        agg.reads += res.reads; agg.read_hits += res.read_hits
        agg.writes += res.writes; agg.write_hits += res.write_hits
        agg.cache_writes += res.cache_writes
        agg.total_latency += res.total_latency
        agg.capacity = t.cache.capacity
        agg.policy = t.policy.value

    def run_window(self, traces: list[Trace | None]) -> None:
        """Replay one Δt window for every tenant, then analyze + actuate.

        ``traces[i] is None`` marks tenant i as finished (a "retire"
        event).
        """
        win = self.windows_run
        events = []
        for i, tr in enumerate(traces):
            if tr is None and self.tenants[i].active:
                self.retire_tenant(i)
                events.append(ReconfigEvent(win, i, "retire"))

        idx = [i for i, tr in enumerate(traces) if tr is not None]
        for i in idx:
            self.record(i, traces[i].addrs, traces[i].is_read)

        results, rds = simulate_many(
            [traces[i] for i in idx],
            policies=[self.tenants[i].policy for i in idx],
            t_fast=self.t_fast, t_slow=self.t_slow,
            t_write_bypass=self.t_write_bypass,
            flush_cost=self.flush_cost,
            caches=[self.tenants[i].cache for i in idx],
            return_window_rd=True, device=self.device,
            profile=self.profile)
        window_trd = {i: rd for i, rd in zip(idx, rds) if rd is not None}
        for i, res in zip(idx, results):
            self._accumulate(self.tenants[i], res)
        self.tenant_windows += len(idx)
        self.windows_run += 1

        # fixed-Δt mode: analyze + actuate every window (churn events are
        # telemetry only)
        self.events.extend(events)
        self.reconfig_events += len(events)
        decision = self.analyze(window_trd)
        self.actuate(decision)

    # ------------------------------------------------------------- metrics
    def allocated_sizes(self) -> torch.Tensor:
        return torch.tensor([t.cache.capacity for t in self.tenants],
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
            "tenant_windows": self.tenant_windows,
            "windows_run": self.windows_run,
            "windows_analyzed": self.windows_analyzed,
            "reconfig_events": self.reconfig_events,
            # decisions that broke a guard invariant (all 0 when healthy)
            "guard_violations_observed": self.guard_violations_observed,
            "guard_violations_actuated": self.guard_violations_actuated,
        }
