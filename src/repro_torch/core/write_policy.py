"""Per-tenant write-policy assignment (paper Alg. 3).

Policies:
  WB — write-back: writes are buffered in the fast tier, flushed on
       eviction.  Best write performance, worst endurance.
  WT — write-through: buffered *and* propagated immediately.
  RO — read-only / write-around: writes bypass the fast tier; only read
       misses install blocks.  Best endurance + reliability.

Assignment rule (Alg. 3):  RO  iff  (WAW + WAR) / total >= wThreshold.
"""
from __future__ import annotations

import enum

from repro_torch.core.trace import AccessClass, Trace, classify_accesses

__all__ = ["WritePolicy", "write_ratio", "assign_write_policy",
           "assign_write_policy_levels"]


class WritePolicy(enum.Enum):
    WB = "wb"
    WT = "wt"
    RO = "ro"


def write_ratio(trace: Trace) -> float:
    """writeRatio = (#WAW + #WAR) / #requests (paper Alg. 3 line 4)."""
    if len(trace) == 0:
        return 0.0
    codes = classify_accesses(trace)
    unref = int(((codes == AccessClass.WAW)
                 | (codes == AccessClass.WAR)).sum())
    return float(unref) / len(trace)


def assign_write_policy(trace: Trace, w_threshold: float = 0.5) -> WritePolicy:
    """RO when unreferenced-write re-touches dominate, else WB (Alg. 3)."""
    return (WritePolicy.RO if write_ratio(trace) >= w_threshold
            else WritePolicy.WB)


def assign_write_policy_levels(trace: Trace, w_threshold: float = 0.5,
                               w_threshold2: float = 0.3
                               ) -> tuple[WritePolicy, WritePolicy]:
    """ETICA's per-level Alg. 3 from one writeRatio: each level applies
    the rule at its own threshold; L2 (the larger, endurance-sensitive
    level) uses the stricter, lower one, so it turns clean (RO) first."""
    wr = write_ratio(trace)
    return (WritePolicy.RO if wr >= w_threshold else WritePolicy.WB,
            WritePolicy.RO if wr >= w_threshold2 else WritePolicy.WB)
