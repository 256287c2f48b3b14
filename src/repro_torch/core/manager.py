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
host pipeline); with ``pipeline="sharded"`` through the sharded window
pipeline over the default shard mesh (``core.shard_pipeline``, the
manager's device's ``control_plane_mesh``), with the same decisions.

Failure domains and the degradation ladder
------------------------------------------
With a ``FaultPlan`` attached (``faults=``, ``core.faults``) or
``fault_tolerant=True``, the manager survives control-plane and tier
failures instead of crashing or actuating garbage.  All of it is off by
default, and the manager is then the fault-free one bit for bit.

  * **Monitor ladder** (``_monitor_ladder``).  Each analyze walks the
    rungs ``sharded -> device -> host -> tenant`` from the manager's
    ``pipeline`` down (``device -> host -> tenant`` for
    ``pipeline="device"``, ``host -> tenant`` for ``"host"``): each
    non-terminal rung gets ``retry_limit`` retries (backoff
    ``backoff_base * 2**attempt`` seconds, at most 1, 0 = none); a failed
    sharded rung (a shard's launch failure kills the whole window's mesh
    program) steps down to the single-device pipeline
    (``sharded_stepdowns``), a failed device rung to the fused host pass
    (``device_stepdowns``), a failed host rung to per-tenant solo passes
    on the manager's device (``host_stepdowns``), whose failed tenants
    are quarantined at their last-known-good size and policy
    (``tenant_quarantines``).  If every rung fails, the last-known-good
    decision is re-applied (``lkg_decisions``).  **A rung fails on
    ``InjectedFault`` only**: a kernel that fails to build or launch, a
    CUDA error or an out-of-memory error propagates with its traceback,
    and so does ``TraceError``.  (The reference catches every
    ``Exception`` there; that would turn a broken kernel into a quiet step
    down to the host.)
  * **Decision guard.**  Every decision is validated (``core.guard``).
    A tolerant manager retries a sampled analyze once exactly
    (``sampled_exact_retries``; that retry catches nothing) and otherwise
    quarantines the decision behind the last-known-good allocation
    (``guard_quarantines``), rolling back the pass's Alg. 3 policy flips;
    an intolerant one counts the shipped violation
    (``guard_violations_actuated``).
  * **Ingest validation.**  A malformed tape raises ``TraceError`` with
    (tenant, window) coordinates; a tolerant ``run_window`` quarantines
    the tenant-window instead (an empty tape, held at last-known-good;
    ``poisoned_windows``).  A straggler's tape is held out of this
    window's analyze and folded into the next (``straggler_windows``).
  * **Tier loss and write-policy demotion.**  ``fail_tier(level)`` /
    ``note_tier_loss`` drop the level's residents, count the lost dirty
    blocks (``dirty_loss``: the cost the paper's Alg. 3 restricts WB to
    bound) and demote every WB tenant of that level to ``demote_policy``
    (default WT) for the outage plus ``demote_cooldown`` analyzes after
    ``note_tier_recovery``.  While a level is down its budget is 0 and
    the partitioner is ``greedy_allocate`` (the PGD box projection cannot
    go below its floors).  A recovered manager matches the fault-free run
    within ``K = demote_cooldown + 2`` windows of the last fault.

Every degradation is a ``DegradeEvent`` in the shared ``events`` deque
(beside the ``ReconfigEvent``s) and is counted once in ``summary()``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.batch_sim import simulate_many
from repro_torch.core.characterize import PhaseDetector, characterize_windows
from repro_torch.core.faults import FaultPlan, InjectedFault
from repro_torch.core.guard import validate_decision
from repro_torch.core.monitor import MonitorResult, analyze_windows
from repro_torch.core.mrc import HitRatioFunction
from repro_torch.core.partitioner import (PartitionResult, greedy_allocate,
                                          pgd_solve, two_level_solve)
from repro_torch.core.profile import StageProfile, pstage
from repro_torch.core.simulator import LRUCache, SimResult, simulate
from repro_torch.core.trace import (Trace, TraceError, validate_trace,
                                    validate_trace_arrays)
from repro_torch.core.write_policy import WritePolicy
from repro_torch.device import resolve_device

__all__ = ["TenantState", "AnalyzerDecision", "ReconfigEvent",
           "DegradeEvent", "ECICacheManager"]


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
class DegradeEvent:
    """One degradation action (fault-tolerance telemetry).

    Lives in the same ``events`` deque as ``ReconfigEvent`` (the same
    ``window``/``tenant``/``reason`` contract).  reason: "tier_loss" /
    "tier_recover" (``level``, ``blocks`` = lost dirty blocks),
    "stepdown" (``rung`` = the rung that failed), "straggler",
    "poisoned" (a quarantined tenant-window), "tenant_quarantine" (a solo
    analyze failed), "guard_quarantine", "monitor_outage" (every rung
    failed: last-known-good).  ``tenant`` is -1 for deployment-wide
    events.
    """

    window: int
    tenant: int
    reason: str
    level: int = 0
    blocks: int = 0
    rung: str = ""


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
    # fault tolerance (all defaults on the healthy path): ``quarantined``
    # marks a last-known-good fallback (sizes are the current
    # allocations), ``guard`` the guard violations detected (non-empty and
    # not quarantined = an actuated violation, intolerant managers only),
    # ``degraded`` the degradation reason, ``held`` tenants kept out of
    # this analyze (at their current size and policy), ``deferred``
    # tenants whose window tape the Actuator keeps (stragglers)
    quarantined: bool = False
    guard: tuple[str, ...] = ()
    degraded: str = ""
    held: tuple[int, ...] = ()
    deferred: tuple[int, ...] = ()
    # the monitor's SHARDS rate per analyzed tenant (1.0 = exact; None on
    # a last-known-good fallback)
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
    replay's distances), ``"device"`` (the device window pipeline, which
    recounts; percentile 100 only) or ``"sharded"`` (the same over the
    default shard mesh of ``device``).  ``history_limit`` bounds the
    retained decisions and events.

    ``faults`` (a ``FaultPlan``) and ``fault_tolerant`` arm the
    degradation machinery (off by default; the module docstring has the
    failure model): ``retry_limit`` retries a rung with ``backoff_base *
    2**attempt`` seconds between (0 = no sleep, at most 1 s); on a tier
    loss every WB tenant of the level demotes to ``demote_policy``
    (default WT) for the outage plus ``demote_cooldown`` analyzes.
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
                 faults: FaultPlan | None = None,
                 fault_tolerant: bool | None = None,
                 retry_limit: int = 2, backoff_base: float = 0.0,
                 demote_cooldown: int = 2,
                 demote_policy: WritePolicy | str = WritePolicy.WT,
                 device: str | torch.device | None = None,
                 profile: StageProfile | None = None):
        if engine not in ("batch", "lru"):
            raise ValueError(f"engine must be 'batch' or 'lru', got "
                             f"{engine!r}")
        if pipeline not in ("host", "device", "sharded"):
            raise ValueError(f"pipeline must be 'host', 'device' or "
                             f"'sharded', got {pipeline!r}")
        self.device = resolve_device(device)
        self.profile = (profile.bind(self.device) if profile is not None
                        else None)
        # "device" analyzes each window through the device window
        # pipeline (one host sync a window), "sharded" through its mesh
        # twin; the host pipeline serves percentiles below 100
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
        # tenant-windows the batch engine replayed through the interpreter
        # (degenerate two-level windows only)
        self.ro_fallback_windows = 0
        # ---------------- fault tolerance (see the module docstring) ------
        # ``faults`` injects; ``fault_tolerant`` arms the ladder, guard
        # and quarantine machinery (on exactly when a plan is attached,
        # unless given).  With both off every path above is the
        # fault-free manager's.
        self.faults = faults
        self.fault_tolerant = (faults is not None if fault_tolerant is None
                               else bool(fault_tolerant))
        self.retry_limit = max(int(retry_limit), 0)
        self.backoff_base = float(backoff_base)
        self.demote_cooldown = max(int(demote_cooldown), 0)
        self.demote_policy = (WritePolicy(demote_policy)
                              if isinstance(demote_policy, str)
                              else demote_policy)
        self._down_levels: set[int] = set()       # levels currently failed
        self._tier_restore_at: dict[int, int] = {}  # level -> restore window
        # (tenant, level) -> analyze count when the demotion expires (None:
        # the level is still down; the expiry is stamped at recovery)
        self._demoted_until: dict[tuple[int, int], int | None] = {}
        self._held: set[int] = set()              # held out of this analyze
        self._defer_clear: set[int] = set()       # straggler tapes to keep
        self._cur_window = 0                      # window under analysis
        self._accumulated: set[int] = set()       # multi-window tapes
        self._lkg: AnalyzerDecision | None = None
        # degrade counters (each increments once per event; in summary())
        self.dirty_loss = 0
        self.tier_failures = 0
        self.guard_quarantines = 0
        self.guard_violations_observed = 0
        self.guard_violations_actuated = 0
        self.sharded_stepdowns = 0
        self.device_stepdowns = 0
        self.host_stepdowns = 0
        self.tenant_quarantines = 0
        self.lkg_decisions = 0
        self.sampled_exact_retries = 0
        self.poisoned_windows = 0
        self.straggler_windows = 0
        self.degrade_events = 0

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

    def _record_degrade(self, ev: DegradeEvent) -> None:
        self.events.append(ev)
        self.degrade_events += 1

    def _launch_hook(self, win: int, rung: str, attempt: int):
        """Fault-injection hook for one monitor launch (None = no plan)."""
        if self.faults is None or not self.faults.enabled:
            return None

        def hook() -> None:
            if self.faults.launch_should_fail(win, rung, attempt):
                raise InjectedFault(
                    f"injected {rung} launch failure "
                    f"(window={win}, attempt={attempt})")
        return hook

    def _monitor_kwargs(self, act: list[int]) -> dict:
        return dict(kind=self.rd_kind, percentile=self.percentile,
                    sample_rate=self.effective_sample_rate(),
                    window_seed=self.windows_analyzed,
                    sample_target=self.sample_target,
                    sample_floor=self.sample_floor, tenant_ids=act,
                    device=self.device)

    def _per_tenant_monitor(self, act: list[int], traces: list[Trace],
                            kw: dict, win: int
                            ) -> tuple[MonitorResult, list[int]]:
        """The bottom rung: a solo host-pipeline analyze per tenant, so one
        bad tenant no longer takes the whole deployment's analyze down.
        A tenant whose launch fails (``InjectedFault``) is quarantined
        (held at last-known-good)."""
        curves, urds, wrs, rates, errs, ok = [], [], [], [], [], []
        for trace, i in zip(traces, act):
            try:
                m = analyze_windows([trace], **{**kw, "tenant_ids": [i]},
                                    pipeline="host",
                                    fault_hook=self._launch_hook(
                                        win, "tenant", 0))
            except InjectedFault:
                self._held.add(i)
                self.tenant_quarantines += 1
                self._record_degrade(
                    DegradeEvent(win, i, "tenant_quarantine"))
                continue
            ok.append(i)
            curves.append(m.curves[0])
            urds.append(int(m.urd_sizes[0]))
            wrs.append(float(m.write_ratios[0]))
            rates.append(float(m.sample_rates[0]))
            errs.append(float(m.expected_errors[0]))
        f64 = dict(dtype=torch.float64, device=self.device)
        mon = MonitorResult(curves, torch.tensor(urds, dtype=torch.int64,
                                                 device=self.device),
                            torch.tensor(wrs, **f64),
                            torch.tensor(rates, **f64),
                            torch.tensor(errs, **f64), self.rd_kind)
        return mon, ok

    def _monitor_ladder(self, act: list[int],
                        window_trd: dict[int, torch.Tensor]
                        ) -> tuple[MonitorResult | None, list[int]]:
        """Run the monitor pass down the degradation ladder.

        Returns ``(result, analyzed tenants)``; ``result`` is None only
        when every rung failed (a total outage: last-known-good).
        Without fault tolerance this is the single fused call.  A rung
        fails on ``InjectedFault`` only; any other error propagates."""
        rate = self.effective_sample_rate()
        pipe = self.pipeline if self.percentile >= 100.0 else "host"
        traces = [self.tenants[i].window_trace() for i in act]
        # the device pipelines recount on the device: the replay's
        # distances go to the host pipeline only, and not for a deferred
        # (straggler) tape, which spans more than one window
        pre = ([None if i in self._accumulated else window_trd.get(i)
                for i in act]
               if rate is None and pipe == "host" else None)
        kw = self._monitor_kwargs(act)
        if not self.fault_tolerant:
            mon = analyze_windows(traces, precomputed_trd=pre, pipeline=pipe,
                                  **kw)
            self.windows_analyzed += 1
            return mon, act
        win = self._cur_window
        attempts = self.retry_limit + 1
        rungs = {"sharded": ["sharded", "device"],
                 "device": ["device"]}.get(pipe, []) + ["host"]
        for rung in rungs:
            for attempt in range(attempts):
                try:
                    mon = analyze_windows(
                        traces,
                        precomputed_trd=(pre if rung == "host" else None),
                        pipeline=rung,
                        fault_hook=self._launch_hook(win, rung, attempt),
                        **kw)
                    self.windows_analyzed += 1
                    return mon, act
                except InjectedFault:
                    if self.backoff_base > 0 and attempt + 1 < attempts:
                        time.sleep(min(self.backoff_base * (2 ** attempt),
                                       1.0))
            if rung == "sharded":
                self.sharded_stepdowns += 1
            elif rung == "device":
                self.device_stepdowns += 1
            else:
                self.host_stepdowns += 1
            self._record_degrade(DegradeEvent(win, -1, "stepdown",
                                              rung=rung))
        # the bottom rung, one attempt: solo passes per tenant
        mon, ok = self._per_tenant_monitor(act, traces, kw, win)
        if not ok and act:
            return None, act       # every solo pass died too: an outage
        self.windows_analyzed += 1
        return mon, ok

    def _fallback_decision(self, trigger: tuple[ReconfigEvent, ...],
                           reason: str,
                           violations: tuple[str, ...] = ()
                           ) -> AnalyzerDecision:
        """Last-known-good: keep every tenant at its current size and
        policy."""
        self.lkg_decisions += 1
        sizes = self.allocated_sizes()
        sizes2 = self.allocated_sizes2()
        act = torch.tensor([i for i, t in enumerate(self.tenants)
                            if t.active], dtype=torch.int64)
        part = PartitionResult(sizes[act], False, 0.0,
                               torch.zeros(act.numel(),
                                           dtype=torch.float64))
        decision = AnalyzerDecision(
            sizes, [t.policy for t in self.tenants], False, part,
            sizes2=sizes2, policies2=[t.policy2 for t in self.tenants],
            partition2=None, trigger=tuple(trigger), quarantined=True,
            guard=tuple(violations), degraded=reason,
            deferred=tuple(sorted(self._defer_clear)))
        self._record_degrade(DegradeEvent(self._cur_window, -1, reason))
        self.history.append(decision)
        return decision

    def _apply_demotions(self) -> None:
        """Hold the WB tenants of a failed (and recovering) tier on the
        demoted policy until ``demote_cooldown`` analyzes after
        recovery."""
        if not self._demoted_until:
            return
        for (i, lv), until in list(self._demoted_until.items()):
            if until is not None and self.windows_analyzed >= until:
                del self._demoted_until[(i, lv)]
                continue
            t = self.tenants[i]
            if lv == 1 and t.policy is WritePolicy.WB:
                t.policy = self.demote_policy
            elif lv == 2 and t.policy2 is WritePolicy.WB:
                t.policy2 = self.demote_policy

    def _build_decision(self, mon: MonitorResult, act: list[int],
                        held: set[int],
                        trigger: tuple[ReconfigEvent, ...]
                        ) -> tuple[AnalyzerDecision, torch.Tensor, int]:
        """Alg. 3 + Eq. 2 over one monitor result.  Returns the decision,
        the guard floors and the partitioned L1 budget."""
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
        self._apply_demotions()

        down1 = 1 in self._down_levels
        down2 = 2 in self._down_levels
        cap1, cap2 = self.capacity, self.capacity2
        pfn = self.partition_fn
        if self.fault_tolerant and (down1 or down2 or held):
            # held tenants keep their partitions: the rest share the
            # residual budget; a down level's budget is 0
            held_sz = sum(int(self.tenants[i].cache.capacity) for i in held)
            held_sz2 = sum(int(self.tenants[i].cache2.capacity)
                           for i in held)
            cap1 = 0 if down1 else max(self.capacity - held_sz, 0)
            cap2 = 0 if down2 else max(self.capacity2 - held_sz2, 0)
            if down1 or down2 or cap1 <= 0:
                # the discrete greedy takes an empty budget exactly (the
                # PGD box projection cannot go below its floors)
                pfn = greedy_allocate
        with pstage(self.profile, "pgd"):
            part, part2 = two_level_solve(
                mon.curves, cap1, cap2, self.t_fast, self.t_fast2,
                self.t_slow, c_min=self.c_min, partition_fn=pfn)
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
            if i in held:
                sizes_full[i] = t.cache.capacity
                sizes2_full[i] = t.cache2.capacity
                continue
            sizes_full[i] = part_sizes[k]
            if part2_sizes is not None:
                sizes2_full[i] = part2_sizes[k]
            if not down1:
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
                                    held=tuple(sorted(held)),
                                    deferred=tuple(sorted(
                                        self._defer_clear & held)),
                                    sample_rates=mon.sample_rates.cpu())
        return decision, floors, cap1

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
        (and counted when actuated).  With fault tolerance the monitor
        pass walks the degradation ladder and a violating or unobtainable
        decision degrades to the last-known-good allocation (module
        docstring).
        """
        window_trd = window_trd or {}
        held = {i for i in self._held if self.tenants[i].active}
        act = [i for i, t in enumerate(self.tenants)
               if t.active and i not in held]
        # the guard's rollback point: a quarantined decision must not leak
        # the corrupted pass's Alg. 3 policy flips
        pol_snap = [(t.policy, t.policy2) for t in self.tenants]
        with pstage(self.profile, "monitor"):
            mon, act = self._monitor_ladder(act, window_trd)
        try:
            if mon is None:
                return self._fallback_decision(trigger, "monitor_outage")
            held = {i for i in self._held if self.tenants[i].active}
            if self.faults is not None:
                self.faults.corrupt_monitor(mon, act, self._cur_window)
            decision, floors, budget = self._build_decision(
                mon, act, held, trigger)
            report = validate_decision(decision, self.capacity,
                                       self.capacity2, floors=floors,
                                       floor_budget=budget)
            if not report.ok:
                self.guard_violations_observed += len(report.violations)
                if self.fault_tolerant:
                    retried = False
                    if any(r < 1.0 for r in mon.sample_rates.tolist()):
                        # a sampled pass can violate by estimation noise:
                        # retry once exactly before giving up on the
                        # window (any error here propagates)
                        self.sampled_exact_retries += 1
                        retried = True
                        kw = {**self._monitor_kwargs(act),
                              "sample_rate": None}
                        mon2 = analyze_windows(
                            [self.tenants[i].window_trace() for i in act],
                            pipeline="host", **kw)
                        self.windows_analyzed += 1
                        if self.faults is not None:
                            self.faults.corrupt_monitor(
                                mon2, act, self._cur_window)
                        decision, floors, budget = self._build_decision(
                            mon2, act, held, trigger)
                        report = validate_decision(
                            decision, self.capacity, self.capacity2,
                            floors=floors, floor_budget=budget)
                        if not report.ok:
                            self.guard_violations_observed += \
                                len(report.violations)
                    if not report.ok:
                        self.guard_quarantines += 1
                        for t, (p, p2) in zip(self.tenants, pol_snap):
                            t.policy, t.policy2 = p, p2
                        return self._fallback_decision(
                            trigger, "guard_quarantine", report.violations)
                else:
                    # intolerant: the violation will be actuated; count it
                    # so garbage never ships silently
                    decision = dataclasses.replace(
                        decision, guard=report.violations)
            if report.ok:
                self._lkg = decision
            self.history.append(decision)
            return decision
        finally:
            self._held = set()
            self._defer_clear = set()

    # ------------------------------------------------------------ Actuator
    def actuate(self, decision: AnalyzerDecision) -> None:
        if decision.guard and not decision.quarantined:
            # an intolerant manager ships the violating decision; count it
            # once so garbage never actuates silently
            self.guard_violations_actuated += 1
        sizes2 = (decision.sizes2 if decision.sizes2 is not None
                  else torch.zeros(len(self.tenants), dtype=torch.int64))
        defer = set(decision.deferred)
        for i, (t, size, size2) in enumerate(zip(
                self.tenants, decision.sizes.tolist(), sizes2.tolist())):
            if t.active:
                t.cache.resize(int(size))
                if self.capacity2 > 0 or t.cache2.capacity > 0:
                    t.cache2.resize(int(size2))
                if i not in defer:
                    t.clear_window()
        # deferred (straggler) tapes now span more than one window: their
        # single-window distances are invalid at the next analyze
        self._accumulated = defer

    # ------------------------------------------------- tier failure domain
    def fail_tier(self, level: int, duration: int | None = None) -> int:
        """The cache device of hierarchy ``level`` (1 = L1, 2 = L2)
        crashes: drop every tenant's residents on that level, count the
        lost dirty blocks (``dirty_loss``) and demote WB tenants (see
        ``note_tier_loss``).  ``duration`` (trace replay) restores the
        tier after that many windows; ``None`` waits for
        ``note_tier_recovery``.  Returns the dirty-block count."""
        dirty = 0
        for t in self.tenants:
            cache = t.cache if level == 1 else t.cache2
            if len(cache):
                _, d = cache.state_arrays()
                if d is not None:
                    dirty += int(d.sum())
            cache.resize(0)
        self.note_tier_loss(level, dirty)
        if duration is not None:
            self._tier_restore_at[level] = \
                self.windows_run + max(int(duration), 1)
        return dirty

    def note_tier_loss(self, level: int, dirty_blocks: int = 0) -> None:
        """Register a tier failure (the serving path's ``TieredKVCache``
        calls this after dropping its own residents).  Marks the level
        down (its budget is 0 until recovery) and demotes every WB tenant
        on it to ``demote_policy`` (paper §3: WB's dirty blocks are what
        a cache-device crash loses)."""
        self.tier_failures += 1
        self.dirty_loss += int(dirty_blocks)
        self._down_levels.add(int(level))
        for i, t in enumerate(self.tenants):
            if not t.active:
                continue
            pol = t.policy if level == 1 else t.policy2
            if pol is WritePolicy.WB:
                # the expiry is stamped at recovery (None: still down)
                self._demoted_until.setdefault((i, int(level)), None)
                if level == 1:
                    t.policy = self.demote_policy
                else:
                    t.policy2 = self.demote_policy
        self._record_degrade(DegradeEvent(
            self.windows_run, -1, "tier_loss", level=int(level),
            blocks=int(dirty_blocks)))

    def note_tier_recovery(self, level: int) -> None:
        """The failed tier is back: restore its budget and start the WB
        demotion cooldown (``demote_cooldown`` analyzes)."""
        level = int(level)
        if level not in self._down_levels:
            return
        self._down_levels.discard(level)
        self._tier_restore_at.pop(level, None)
        until = self.windows_analyzed + 1 + self.demote_cooldown
        for key, u in list(self._demoted_until.items()):
            if key[1] == level and u is None:
                self._demoted_until[key] = until
        self._record_degrade(DegradeEvent(
            self.windows_run, -1, "tier_recover", level=level))

    def tier_is_down(self, level: int) -> bool:
        return int(level) in self._down_levels

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

    def _fault_preamble(self, traces: list[Trace | None],
                        win: int) -> list[Trace | None]:
        """Apply the window's scheduled faults and quarantine bad tapes.

        Runs only on a tolerant (or fault-injected) manager: restores the
        tiers whose outage expired, injects the plan's tape corruption,
        tier losses and stragglers, and validates every incoming tape (a
        malformed one is replaced by an empty tape, its tenant held at
        last-known-good, instead of raising)."""
        for lv, at in list(self._tier_restore_at.items()):
            if win >= at:
                self.note_tier_recovery(lv)
        self._held = set()
        self._defer_clear = set()
        if self.faults is not None and self.faults.enabled:
            traces = self.faults.corrupt_traces(traces, win)
            for spec in self.faults.at(win, "tier_loss"):
                if spec.level not in self._down_levels:
                    self.fail_tier(spec.level, duration=spec.duration)
            for i in sorted(self.faults.stragglers(win)):
                if 0 <= i < len(traces) and traces[i] is not None \
                        and self.tenants[i].active:
                    self._held.add(i)
                    self._defer_clear.add(i)
                    self.straggler_windows += 1
                    self._record_degrade(DegradeEvent(win, i, "straggler"))
        if self.fault_tolerant:
            for i, tr in enumerate(traces):
                if tr is None:
                    continue
                try:
                    validate_trace(tr, tenant=i, window=win)
                except TraceError:
                    traces[i] = Trace(
                        torch.zeros(0, dtype=torch.int64,
                                    device=self.device),
                        torch.zeros(0, dtype=torch.bool,
                                    device=self.device), tr.name)
                    self._held.add(i)
                    self.poisoned_windows += 1
                    self._record_degrade(DegradeEvent(win, i, "poisoned"))
        return traces

    def run_window(self, traces: list[Trace | None]) -> None:
        """Replay one Δt window for every tenant, then analyze + actuate.

        ``traces[i] is None`` marks tenant i as finished (a "retire"
        event).  With ``phase_detect`` the analyze/actuate half runs only
        when the detector, a churn event or the ``reconfig_interval``
        clock triggers it; the replay half always runs.
        """
        win = self.windows_run
        self._cur_window = win
        if self.fault_tolerant or self.faults is not None:
            traces = self._fault_preamble(list(traces), win)
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
            # the degrade telemetry (each counter increments once per
            # event; all 0 on a healthy fault-free run)
            "dirty_loss": self.dirty_loss,
            "tier_failures": self.tier_failures,
            "guard_quarantines": self.guard_quarantines,
            "guard_violations_observed": self.guard_violations_observed,
            "guard_violations_actuated": self.guard_violations_actuated,
            "sharded_stepdowns": self.sharded_stepdowns,
            "device_stepdowns": self.device_stepdowns,
            "host_stepdowns": self.host_stepdowns,
            "tenant_quarantines": self.tenant_quarantines,
            "lkg_decisions": self.lkg_decisions,
            "sampled_exact_retries": self.sampled_exact_retries,
            "poisoned_windows": self.poisoned_windows,
            "straggler_windows": self.straggler_windows,
            "degrade_events": self.degrade_events,
        }
