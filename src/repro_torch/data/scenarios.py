"""Deterministic labeled multi-tenant scenario generator (test artifact).

A copy of ``repro.data.scenarios`` for the port: the traces come from the
port's ``data.traces.generate_trace`` (numpy draws, bit-identical to the
reference's), laid out as the port's tensor ``Trace``.  The reference's
fault scenarios (``FaultScenario``, ``faulted_*``) wait for the port of
``core/faults.py`` and are left out here.

The trace suite that exercises the *online* half of ECI-Cache: every
scenario is a sequence of Δt windows per tenant where each tenant moves
through explicitly labeled workload *phases* (ReCA's regimes — PAPERS.md,
arxiv 1805.06747), so phase-detection quality is measurable against ground
truth instead of eyeballed.  Every access carries its phase label (all
accesses of a (window, tenant) cell share the cell's label —
``access_labels``), and ``changes[w, t]`` marks exactly the windows where
tenant t entered a new phase (the detection targets; a tenant's very first
active window is a cold start, not a change).

Scenarios (all deterministic in ``seed``; see ``SCENARIOS``):

  * ``diurnal``     — every tenant alternates day (read-heavy hot-set,
    high load) and night (write-heavy batch, low load) regimes.
  * ``bursty``      — stationary background with deterministic burst
    windows per tenant: 5× load on a tight hot set, then back.
  * ``churn``       — tenants join and retire mid-run (plus one joiner
    that changes phase after joining): the scenario for the manager's
    churn invariants.
  * ``scan_flood``  — adversarial noisy neighbor: victims run stationary
    cache-friendly workloads while the aggressor flips mid-run from a
    benign mix to a high-rate sequential scan flood (the classic
    partition-stealing attack; feeds the isolation metric in
    ``benchmarks.bench_scenarios``).
  * ``correlated``  — every tenant changes phase in the *same* window
    (the hardest re-partitioning spike).

Phase-address disjointness: each (tenant, phase) run draws from its own
address-space slot (``_addr_offset``), so a phase change also moves the
working set — Jaccard drift is a real signal, and cross-tenant addresses
never collide.  Within a phase the accesses are one continuous
``generate_trace`` stream chopped into windows, so consecutive same-phase
windows overlap addresses the way a stationary workload does.

``replay_scenario`` drives an ``ECICacheManager`` (or anything with its
``run_window``/``add_tenant`` interface) through a scenario — handling
join/retire churn — and supports *differential replay*: ``exclude`` a
tenant (e.g. the aggressor) and every other tenant sees the identical
per-window traces, which is exactly the counterfactual the isolation
metric needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.trace import Trace
from repro_torch.data.traces import WorkloadProfile, generate_trace

__all__ = [
    "Phase", "ScenarioRun", "SCENARIOS",
    "PH_MIXED", "PH_READ_HOT", "PH_WRITE_BATCH", "PH_BURST", "PH_SCAN",
    "diurnal", "bursty", "churn", "scan_flood", "correlated",
    "build_scenario", "replay_scenario", "per_tenant_latency",
]


# ------------------------------------------------------- phase vocabulary
# Profiles are chosen so adjacent phases are far apart along the
# characterization axes (read mix, sequentiality, working set, reuse):
# a detector with hi=0.25 sees scores well above threshold at every
# labeled change and well below it within a phase.

#: benign balanced mix (the background phase almost everywhere)
PH_MIXED = WorkloadProfile(0.08, 0.06, 0.40, 0.16, 0.10, 0.20,
                           working_set=2048, read_reach=256)
#: read-heavy hot-set serving (day regime)
PH_READ_HOT = WorkloadProfile(0.08, 0.02, 0.78, 0.05, 0.02, 0.05,
                              working_set=2048, read_reach=256)
#: write-heavy batch (night regime; write_ratio crosses w_threshold=0.5)
PH_WRITE_BATCH = WorkloadProfile(0.03, 0.12, 0.05, 0.05, 0.25, 0.50,
                                 working_set=4096, read_reach=128)
#: burst: very tight hot set, reuse-dominated
PH_BURST = WorkloadProfile(0.03, 0.02, 0.80, 0.10, 0.02, 0.03,
                           working_set=256, read_reach=64)
#: sequential scan flood (cold-dominated streaming; defeats caching)
PH_SCAN = WorkloadProfile(0.75, 0.20, 0.02, 0.01, 0.01, 0.01,
                          sequential=True)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One labeled phase of one tenant: a profile and per-window loads.

    ``cycle`` switches the phase from the profile generator to a pure
    cyclic read scan over ``cycle`` distinct blocks — the LRU-cliff
    workload (hit ratio is a step at exactly ``cycle`` blocks, URD =
    ``cycle``), the canonical capacity-sensitive victim for isolation
    experiments.  ``profile`` is ignored when ``cycle`` is set.
    """

    profile: WorkloadProfile
    label: int
    lengths: tuple[int, ...]          # accesses per window, len = #windows
    cycle: int | None = None


@dataclasses.dataclass(frozen=True)
class ScenarioRun:
    """A materialized scenario: labeled per-(window, tenant) traces.

    ``traces[w][t]`` is ``None`` while tenant t is inactive (not yet
    joined, or retired).  ``labels[w, t]`` is the ground-truth phase id
    (-1 inactive); ``changes[w, t]`` marks phase-transition windows.
    """

    name: str
    n_windows: int
    tenant_names: list[str]
    traces: list[list[Trace | None]]
    labels: np.ndarray                # int64[windows, tenants]
    changes: np.ndarray               # bool[windows, tenants]
    join_windows: np.ndarray          # int64[tenants]
    retire_windows: np.ndarray        # int64[tenants]; n_windows = never
    aggressor: int | None = None
    seed: int = 0

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_names)

    def access_labels(self, window: int, tenant: int) -> np.ndarray:
        """Ground-truth phase label per access of one (window, tenant)."""
        tr = self.traces[window][tenant]
        n = 0 if tr is None else len(tr)
        return np.full(n, self.labels[window, tenant], dtype=np.int64)

    def true_changes(self) -> list[tuple[int, int]]:
        """(window, tenant) pairs of every labeled phase change."""
        w, t = np.nonzero(self.changes)
        return list(zip(w.tolist(), t.tolist()))


def _addr_offset(tenant: int, phase: int) -> int:
    """Disjoint address-space slot per (tenant, phase) run.

    Slots stay below 2**43 so the monitor's composite-key sort path
    (address bits + position bits <= 62) keeps working at every scale the
    suite uses.
    """
    if not (0 <= tenant < 64 and 0 <= phase < 32):
        raise ValueError(f"scenario slot out of range: ({tenant}, {phase})")
    return (tenant * 32 + phase + 1) << 32


def _mix_seed(seed: int, tenant: int, phase: int) -> int:
    return (seed * 1_000_003 + tenant * 8_191 + phase * 131) & 0x7FFFFFFF


def build_scenario(name: str, tenant_names: list[str],
                   phase_plans: list[list[Phase]],
                   join_windows: list[int] | None = None,
                   n_windows: int | None = None,
                   aggressor: int | None = None,
                   seed: int = 0) -> ScenarioRun:
    """Materialize per-tenant phase plans into a labeled ``ScenarioRun``.

    Tenant t is active from ``join_windows[t]`` for
    ``sum(len(p.lengths) for p in phase_plans[t])`` windows, then retires
    (``n_windows`` extends the run past the last retirement; tenants whose
    plan reaches the end never retire).
    """
    nt = len(tenant_names)
    joins = list(join_windows) if join_windows is not None else [0] * nt
    spans = [sum(len(p.lengths) for p in plans) for plans in phase_plans]
    total = n_windows if n_windows is not None else max(
        j + s for j, s in zip(joins, spans))
    traces: list[list[Trace | None]] = [[None] * nt for _ in range(total)]
    labels = np.full((total, nt), -1, dtype=np.int64)
    changes = np.zeros((total, nt), dtype=bool)
    retire = np.full(nt, total, dtype=np.int64)

    for t, plans in enumerate(phase_plans):
        w = joins[t]
        for p_idx, ph in enumerate(plans):
            n_total = int(sum(ph.lengths))
            if ph.cycle is not None:
                addrs = (torch.arange(n_total, dtype=torch.int64)
                         % int(ph.cycle))
                tr = Trace(addrs, torch.ones(n_total, dtype=torch.bool),
                           tenant_names[t])
            else:
                tr = generate_trace(ph.profile, n_total,
                                    seed=_mix_seed(seed, t, p_idx),
                                    name=tenant_names[t])
            addrs = tr.addrs + _addr_offset(t, p_idx)
            cuts = np.concatenate(
                [[0], np.cumsum(np.asarray(ph.lengths, dtype=np.int64))]
            ).tolist()
            for j in range(len(ph.lengths)):
                if w >= total:
                    break
                traces[w][t] = Trace(addrs[cuts[j]:cuts[j + 1]],
                                     tr.is_read[cuts[j]:cuts[j + 1]],
                                     tenant_names[t])
                labels[w, t] = ph.label
                # the first window of a *later* phase is a change target
                changes[w, t] = (j == 0 and p_idx > 0)
                w += 1
        if w < total:
            retire[t] = w
    return ScenarioRun(name, total, list(tenant_names), traces, labels,
                       changes, np.asarray(joins, dtype=np.int64), retire,
                       aggressor=aggressor, seed=seed)


# ------------------------------------------------------------- scenarios
def diurnal(n_tenants: int = 4, cycles: int = 2, day: int = 3,
            night: int = 3, n_day: int = 900, n_night: int = 400,
            seed: int = 0) -> ScenarioRun:
    """Day/night regime alternation: load and mix swing together."""
    plans = []
    for _t in range(n_tenants):
        phases = []
        for _c in range(cycles):
            phases.append(Phase(PH_READ_HOT, 0, (n_day,) * day))
            phases.append(Phase(PH_WRITE_BATCH, 1, (n_night,) * night))
        plans.append(phases)
    return build_scenario("diurnal", [f"d{t}" for t in range(n_tenants)],
                          plans, seed=seed)


def bursty(n_tenants: int = 4, n_windows: int = 10, n_base: int = 400,
           burst_mult: int = 5, seed: int = 0) -> ScenarioRun:
    """Stationary background with deterministic per-tenant burst windows."""
    rng = np.random.default_rng(seed)
    plans = []
    for t in range(n_tenants):
        # bursts last 3 windows: the detector cold-restarts after a
        # trigger, so phases shorter than warmup+2 windows are beneath its
        # resolution (the burst's *exit* would land inside the warm-up)
        burst_at = int(rng.integers(2, n_windows - 3))
        phases = [Phase(PH_MIXED, 0, (n_base,) * burst_at),
                  Phase(PH_BURST, 1, (n_base * burst_mult,) * 3),
                  Phase(PH_MIXED, 2, (n_base,) * (n_windows - burst_at - 3))]
        plans.append(phases)
    return build_scenario("bursty", [f"b{t}" for t in range(n_tenants)],
                          plans, n_windows=n_windows, seed=seed)


def churn(n_stable: int = 3, n_windows: int = 10, n_base: int = 500,
          seed: int = 0) -> ScenarioRun:
    """Join/retire churn: stable core, an early-retiring tenant, a late
    joiner, and a joiner that changes phase after joining."""
    names, plans, joins = [], [], []
    for t in range(n_stable):
        names.append(f"stable{t}")
        plans.append([Phase(PH_MIXED, 0, (n_base,) * n_windows)])
        joins.append(0)
    names.append("retiree")
    plans.append([Phase(PH_READ_HOT, 0, (n_base,) * (n_windows // 2))])
    joins.append(0)
    names.append("joiner")
    plans.append([Phase(PH_READ_HOT, 0, (n_base,) * (n_windows - 3))])
    joins.append(3)
    names.append("shifter")
    plans.append([Phase(PH_READ_HOT, 0, (n_base,) * 3),
                  Phase(PH_WRITE_BATCH, 1, (n_base,) * (n_windows - 5))])
    joins.append(2)
    return build_scenario("churn", names, plans, join_windows=joins,
                          n_windows=n_windows, seed=seed)


def scan_flood(n_victims: int = 4, n_windows: int = 10, flood_at: int = 4,
               n_victim: int = 2500, n_benign: int = 1200,
               flood_mult: int = 4, cycle_base: int = 1500,
               cycle_step: int = 200, seed: int = 0) -> ScenarioRun:
    """Noisy neighbor: the last tenant turns into a sequential scan flood.

    Victims are cyclic LRU-cliff workloads with staggered cycle sizes
    (``cycle_base + t * cycle_step`` blocks): each victim's hit ratio is a
    step function at its cycle, so losing even a slice of capacity to the
    aggressor collapses it from all-hits to all-misses — the
    capacity-sensitive tenant the isolation metric needs.  (A Zipf victim
    saturates long before realistic shares and would mask the theft.)
    """
    names = [f"victim{t}" for t in range(n_victims)] + ["aggressor"]
    plans = [[Phase(PH_READ_HOT, 0, (n_victim,) * n_windows,
                    cycle=cycle_base + t * cycle_step)]
             for t in range(n_victims)]
    plans.append([Phase(PH_MIXED, 0, (n_benign,) * flood_at),
                  Phase(PH_SCAN, 1,
                        (n_benign * flood_mult,) * (n_windows - flood_at))])
    return build_scenario("scan_flood", names, plans, n_windows=n_windows,
                          aggressor=n_victims, seed=seed)


def correlated(n_tenants: int = 5, n_windows: int = 8, switch_at: int = 4,
               n_base: int = 600, seed: int = 0) -> ScenarioRun:
    """Every tenant changes phase in the same window (correlated spike)."""
    before = (PH_READ_HOT, PH_MIXED)
    after = (PH_WRITE_BATCH, PH_SCAN)
    plans = []
    for t in range(n_tenants):
        plans.append([Phase(before[t % 2], 0, (n_base,) * switch_at),
                      Phase(after[t % 2], 1,
                            (n_base,) * (n_windows - switch_at))])
    return build_scenario("correlated", [f"c{t}" for t in range(n_tenants)],
                          plans, n_windows=n_windows, seed=seed)


#: name -> builder (all deterministic in their ``seed`` kwarg)
SCENARIOS = {
    "diurnal": diurnal,
    "bursty": bursty,
    "churn": churn,
    "scan_flood": scan_flood,
    "correlated": correlated,
}


# ------------------------------------------------------------ replay glue
def replay_scenario(run: ScenarioRun, manager_factory,
                    exclude: frozenset[int] | set[int] = frozenset()):
    """Drive a manager through a scenario, handling join/retire churn.

    ``manager_factory(names)`` builds the manager over the tenants active
    in window 0 (scenario order); later joiners enter via
    ``manager.add_tenant``.  ``exclude`` drops scenario tenants entirely
    (differential replay: every remaining tenant sees identical traces).
    Returns ``(manager, index_map)`` with ``index_map[scenario_tenant] =
    manager_tenant`` for every replayed tenant.
    """
    excl = set(exclude)
    order = [t for t in range(run.n_tenants) if t not in excl]
    initial = [t for t in order if run.join_windows[t] == 0]
    mgr = manager_factory([run.tenant_names[t] for t in initial])
    imap = {t: k for k, t in enumerate(initial)}
    for w in range(run.n_windows):
        for t in order:
            if t not in imap and run.join_windows[t] == w:
                imap[t] = mgr.add_tenant(run.tenant_names[t])
        traces: list[Trace | None] = [None] * len(mgr.tenants)
        for t, k in imap.items():
            traces[k] = run.traces[w][t]
        mgr.run_window(traces)
    return mgr, imap


def per_tenant_latency(mgr, imap: dict[int, int]) -> dict[int, float]:
    """Mean replay latency per *scenario* tenant index."""
    out = {}
    for t, k in imap.items():
        res = mgr.tenants[k].result
        out[t] = res.total_latency / max(res.n, 1)
    return out
