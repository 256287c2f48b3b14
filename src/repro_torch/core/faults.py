"""Deterministic, seeded fault injection for the control plane and tiers.

Port of ``repro.core.faults``.  ECI-Cache's write-policy assignment is a
*reliability* decision (paper §3: WB maximizes hits but loses dirty data
on a cache-device crash, which is why Alg. 3 restricts it), and a
reproduction with no failure model can never exercise that rationale.
``FaultPlan`` is the failure model: a frozen, seed-deterministic schedule
of injected faults at chosen ``(tenant, window)`` coordinates that the
``ECICacheManager`` (and the serving tiers) consult while running.  With
no plan attached, or an empty one, every consumer takes the fault-free
code path bit for bit.

Fault taxonomy (``FaultSpec.kind``):

  ``tier_loss``   the cache device of hierarchy level ``level`` (1 =
                  HBM/SSD, 2 = host/SSD-2) crashes at ``window`` for
                  ``duration`` windows: residents drop, dirty blocks are
                  lost (``dirty_loss``), WB tenants demote (see manager).
  ``poison``      tenant ``tenant``'s window tape is corrupted in a
                  *detectable* way (negative or non-integer addresses, op
                  codes outside {0, 1}): the ``TraceError`` ingest
                  validation and quarantine path.
  ``truncate``    the tenant's tape is cut to a ``1 - param`` fraction (a
                  short but valid window).
  ``curve_nan``   the monitor's outputs for ``tenant`` are corrupted after
                  the pass (NaN or inf curve heights, a negative URD;
                  ``param`` selects the mode): the decision guard must
                  quarantine instead of actuating.
  ``pipeline``    a monitor launch failure: the ladder rung named by
                  ``rung`` ("sharded" | "device" | "host" | "tenant", ""
                  = all) raises ``InjectedFault`` at dispatch for the
                  first ``count`` attempts of each matching window.
  ``straggler``   the tenant's window tape arrives late: the manager holds
                  the tenant out of this window's analyze (last-known-good
                  size and policy) and folds the deferred tape into the
                  next.

Every draw that materializes a fault (which addresses to poison) is a
numpy ``default_rng`` seeded from ``(seed, window)`` exactly as in the
reference, so both packages corrupt the same positions; the corrupted
tapes are the port's tensor ``Trace``s on the incoming tape's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.trace import Trace

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultPlan", "InjectedFault"]

FAULT_KINDS = ("tier_loss", "poison", "truncate", "curve_nan", "pipeline",
               "straggler")


class InjectedFault(RuntimeError):
    """Raised by injected launch failures.  The only error a tolerant
    manager's ladder steps down on: every other error propagates."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault (see the module docstring for the kinds).

    ``window`` is the first affected ``run_window`` index; the fault stays
    active for ``duration`` windows.  ``tenant`` is the manager tenant
    index (-1 = not tenant-scoped), ``level`` the hierarchy level for
    ``tier_loss``.  ``count`` bounds how many launch *attempts* a
    ``pipeline`` fault kills per window (1 = the retry succeeds; more than
    the manager's ``retry_limit`` forces a rung step-down).  ``param`` is
    a kind-specific knob (truncation fraction, corruption mode).  ``rung``
    restricts ``pipeline`` faults to one ladder rung.
    """

    kind: str
    window: int
    tenant: int = -1
    level: int = 1
    duration: int = 1
    count: int = 1
    rung: str = ""
    param: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.duration < 1:
            raise ValueError("fault duration must be >= 1 window")

    def active(self, window: int) -> bool:
        return self.window <= window < self.window + self.duration


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable schedule of ``FaultSpec``s.

    Queries (all pure; the manager calls them per window):
      ``at(window, kind)``       specs of ``kind`` *starting* at ``window``
      ``active(window, kind)``   specs of ``kind`` covering ``window``
      ``stragglers(window)``     tenant indices straggling this window
      ``launch_should_fail``     should this (window, rung, attempt) die
      ``corrupt_traces``         apply poison/truncate faults to a window
      ``corrupt_monitor``        apply curve_nan faults to a MonitorResult
    """

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "specs", tuple(self.specs))

    @property
    def enabled(self) -> bool:
        return bool(self.specs)

    # ------------------------------------------------------------- queries
    def at(self, window: int, kind: str) -> list[FaultSpec]:
        return [s for s in self.specs
                if s.kind == kind and s.window == window]

    def active(self, window: int, kind: str) -> list[FaultSpec]:
        return [s for s in self.specs
                if s.kind == kind and s.active(window)]

    def stragglers(self, window: int) -> set[int]:
        return {s.tenant for s in self.active(window, "straggler")
                if s.tenant >= 0}

    def launch_should_fail(self, window: int, rung: str,
                           attempt: int) -> bool:
        for s in self.active(window, "pipeline"):
            if s.rung in ("", rung) and attempt < s.count:
                return True
        return False

    def last_fault_window(self) -> int:
        """Last window any fault is still active (-1: empty plan)."""
        if not self.specs:
            return -1
        return max(s.window + s.duration - 1 for s in self.specs)

    def reconverge_bound(self, demote_cooldown: int) -> int:
        """K: windows after ``last_fault_window()`` within which a tolerant
        manager must match the no-fault decision again.

        One window flushes deferred straggler tapes out of the monitor,
        ``demote_cooldown`` analyzes hold recovered-tier WB tenants on the
        demoted policy, and one more window re-runs Alg. 1/3 on clean
        state.
        """
        return int(demote_cooldown) + 2

    # ----------------------------------------------------- trace corruption
    def _rng(self, window: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 0x9E3779B1 + window * 1_000_003 + 7) & 0x7FFFFFFF)

    def corrupt_traces(self, traces: list[Trace | None],
                       window: int) -> list[Trace | None]:
        """Apply poison/truncate faults to one window's tapes (pure)."""
        out = list(traces)
        rng = self._rng(window)
        for s in self.active(window, "poison"):
            i = s.tenant
            if 0 <= i < len(out) and out[i] is not None:
                out[i] = _poison_trace(out[i], rng, int(s.param))
        for s in self.active(window, "truncate"):
            i = s.tenant
            if 0 <= i < len(out) and out[i] is not None:
                frac = s.param if 0.0 < s.param < 1.0 else 0.75
                keep = int(len(out[i]) * (1.0 - frac))
                out[i] = out[i].slice(0, max(keep, 0))
        return out

    def corrupt_monitor(self, mon, act: list[int], window: int) -> None:
        """Apply curve_nan faults in place to one analyze's outputs.

        Modes 0 and 1 write NaN or inf into the tenant's curve heights
        (the stacked ``heights[offsets[k]:offsets[k+1]]``, or a solo
        curve's ``heights``); a curve without heights, and mode 2, set the
        tenant's URD size to -7 instead (the reference's fall-through).
        """
        for s in self.active(window, "curve_nan"):
            if s.tenant not in act:
                continue
            k = act.index(s.tenant)
            mode = int(s.param)
            curves = mon.curves
            if mode in (0, 1):
                bad = float("nan") if mode == 0 else float("inf")
                if hasattr(curves, "heights") and hasattr(curves, "offsets"):
                    lo = int(curves.offsets[k])
                    hi = int(curves.offsets[k + 1])
                    curves.heights[lo:hi] = bad
                    continue
                c = curves[k]
                if getattr(c, "heights", None) is not None \
                        and len(c.heights):
                    c.heights[:] = bad
                    continue
            mon.urd_sizes[k] = -7

    # ------------------------------------------------------------ factories
    @classmethod
    def standard(cls, n_tenants: int, n_windows: int,
                 seed: int = 0) -> "FaultPlan":
        """The canonical mixed plan: one of everything.

        Exercises in one run: trace quarantine (poison and truncate), an
        in-rung launch retry, a forced host -> per-tenant step-down, a
        mid-run L1 loss (dirty loss, WB demotion and recovery), a
        straggler hold, and a guard quarantine (NaN curve).
        """
        nt, nw = int(n_tenants), int(n_windows)
        if nt < 1 or nw < 8:
            raise ValueError("standard plan needs >= 1 tenant, >= 8 windows")
        mid = nw // 2
        return cls(specs=(
            FaultSpec("poison", window=1, tenant=0),
            FaultSpec("pipeline", window=2, rung="host", count=1),
            FaultSpec("straggler", window=max(mid - 2, 1),
                      tenant=min(1, nt - 1)),
            FaultSpec("tier_loss", window=mid, level=1, duration=1),
            FaultSpec("pipeline", window=mid + 1, rung="host", count=99),
            FaultSpec("curve_nan", window=nw - 3, tenant=min(2, nt - 1)),
            FaultSpec("truncate", window=nw - 2, tenant=0, param=0.5),
        ), seed=seed)

    @classmethod
    def chaos(cls, n_tenants: int, n_windows: int, seed: int = 0,
              max_faults: int = 4) -> "FaultPlan":
        """A random but deterministic plan (the chaos suite's)."""
        rng = np.random.default_rng(seed)
        n_faults = int(rng.integers(1, max(max_faults, 1) + 1))
        specs = []
        for _ in range(n_faults):
            kind = FAULT_KINDS[int(rng.integers(len(FAULT_KINDS)))]
            window = int(rng.integers(1, max(n_windows - 3, 2)))
            specs.append(FaultSpec(
                kind, window=window,
                tenant=int(rng.integers(n_tenants)),
                level=1, duration=int(rng.integers(1, 3)),
                count=int(rng.integers(1, 4)),
                rung=("", "host", "sharded")[int(rng.integers(3))]
                     if kind == "pipeline" else "",
                param=float(rng.integers(3)) if kind in ("curve_nan",
                                                         "poison")
                      else (0.5 if kind == "truncate" else 0.0)))
        return cls(specs=tuple(specs), seed=seed)


def _poison_trace(tr: Trace, rng: np.random.Generator, mode: int) -> Trace:
    """Corrupt a tape *detectably* (the ingest validator must catch it);
    the positions are the reference's numpy draws."""
    n = len(tr)
    dev = tr.addrs.device
    if n == 0:
        return Trace(torch.tensor([-1], dtype=torch.int64, device=dev),
                     torch.tensor([True], device=dev), tr.name)
    if mode == 0:                      # negative block addresses
        addrs = tr.addrs.clone()
        k = max(1, n // 8)
        pos = torch.as_tensor(rng.choice(n, size=min(k, n), replace=False),
                              device=dev)
        addrs[pos] = -1 - torch.abs(addrs[pos])
        return Trace(addrs, tr.is_read.clone(), tr.name)
    if mode == 1:                      # op codes outside {read, write}
        ops = tr.is_read.to(torch.int8)
        pos = torch.as_tensor(rng.choice(n, size=max(1, n // 8),
                                         replace=False), device=dev)
        ops[pos] = 2
        return Trace(tr.addrs.clone(), ops, tr.name)
    # non-integer addresses (a float tape)
    return Trace(tr.addrs.to(torch.float64) + 0.5, tr.is_read.clone(),
                 tr.name)
