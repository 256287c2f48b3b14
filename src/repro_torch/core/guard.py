"""Decision guard: hard invariants every ``AnalyzerDecision`` must satisfy.

The Analyzer's outputs drive real resizes and policy flips, so every
decision is checked before it is actuated:

  * every size is finite and >= 0, and Σ sizes <= capacity (the
    reference's second-level checks wait for the two-level port);
  * per-tenant ``c_min`` floors hold — ``floors[i] = min(c_min, urd_i)``,
    checked only when the floors fit the partitioned budget;
  * the partition objective and hit ratios are finite, hit ratios within
    [0, 1];
  * every policy is a ``WritePolicy`` member (WB/WT/RO).

Pure and cheap (a handful of reductions on host tensors); the manager
runs it on every analyze.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.write_policy import WritePolicy

__all__ = ["GuardReport", "validate_decision"]


@dataclasses.dataclass(frozen=True)
class GuardReport:
    """Outcome of one decision validation: empty ``violations`` = pass."""

    violations: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.violations


def _check_level(v: list[str], sizes, capacity: int, tag: str) -> None:
    fs = torch.as_tensor(sizes).to(torch.float64)
    if fs.numel() == 0:
        return
    if not bool(torch.isfinite(fs).all()):
        v.append(f"non-finite {tag} size")
        return
    if float(fs.min()) < 0:
        v.append(f"negative {tag} size")
    if float(fs.sum()) > capacity + 0.5:
        v.append(f"{tag} sizes exceed capacity "
                 f"({int(fs.sum())} > {int(capacity)})")


def _check_policies(v: list[str], policies, tag: str) -> None:
    if policies is None:
        return
    for p in policies:
        if not isinstance(p, WritePolicy):
            v.append(f"invalid {tag} policy {p!r}")
            return


def validate_decision(decision, capacity: int, floors=None,
                      floor_budget: int | None = None) -> GuardReport:
    """Validate one ``AnalyzerDecision`` against the hard invariants.

    ``floors`` (optional, aligned with ``decision.sizes``) carries the
    per-tenant minimums ``min(c_min, urd_i)``; ``floor_budget`` is the
    capacity the partitioner actually had (defaults to ``capacity``);
    floors are only enforced when they fit it.
    """
    v: list[str] = []
    _check_level(v, decision.sizes, int(capacity), "L1")
    _check_policies(v, decision.policies, "L1")

    part = decision.partition
    if part is not None:
        if not math.isfinite(float(part.latency)):
            v.append("non-finite partition latency")
        hr = torch.as_tensor(part.hit_ratios).to(torch.float64)
        if hr.numel() and not bool(torch.isfinite(hr).all()):
            v.append("non-finite hit ratios")
        elif hr.numel() and (float(hr.min()) < -1e-9
                             or float(hr.max()) > 1.0 + 1e-9):
            v.append("hit ratios outside [0, 1]")

    if floors is not None and not v:
        fl = torch.as_tensor(floors).to(torch.float64)
        budget = int(capacity if floor_budget is None else floor_budget)
        if fl.numel() and float(fl.min()) < 0:
            # a negative floor means the monitor reported a negative URD
            v.append("negative c_min floor (corrupt URD size)")
        elif float(fl.sum()) <= budget:
            fs = torch.as_tensor(decision.sizes).to(torch.float64)
            short = torch.nonzero(fs < fl - 0.5).squeeze(1)
            if short.numel():
                v.append(f"c_min floor violated for tenants "
                         f"{short.tolist()}")
    return GuardReport(tuple(v))
