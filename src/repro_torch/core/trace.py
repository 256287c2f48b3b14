"""Block-access trace representation and request-type classification.

Port of ``repro.core.trace`` onto tensors: a trace is an int64 address
tensor and a bool read mask.  The request-type taxonomy (paper §4,
Fig. 6) is unchanged:

  first touch of an address:   CR (cold read) / CW (cold write)
  re-touch, classified by (previous type, current type):
      RAR  read  after read
      RAW  read  after write
      WAR  write after read
      WAW  write after write
"""
from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = [
    "AccessClass",
    "Trace",
    "TraceError",
    "classify_accesses",
    "prev_next_occurrence",
    "request_type_mix",
    "total_cache_writes_wb",
    "validate_trace",
    "validate_trace_arrays",
]

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8, torch.uint16, torch.uint32, torch.uint64)


class TraceError(ValueError):
    """A malformed trace at the Monitor/manager ingest boundary.

    Carries the (tenant, window) coordinates of the offending tape.
    """

    def __init__(self, msg: str, tenant: int = -1, window: int = -1):
        self.tenant = int(tenant)
        self.window = int(window)
        super().__init__(f"{msg} (tenant={self.tenant}, window={self.window})")


def validate_trace_arrays(addrs, is_read, tenant: int = -1,
                          window: int = -1) -> None:
    """Validate one window tape's raw arrays; raise ``TraceError`` if bad.

    Checks: 1-D arrays of equal length, integer block addresses,
    non-negative addresses, op codes either bool or integers restricted
    to {0 (write), 1 (read)}.  Empty tapes are valid.  Accepts tensors
    or anything ``torch.as_tensor`` takes.
    """
    a = torch.as_tensor(addrs)
    r = torch.as_tensor(is_read)
    if a.dim() != 1 or r.dim() != 1:
        raise TraceError("trace arrays must be 1-D", tenant, window)
    if a.shape != r.shape:
        raise TraceError(
            f"addrs length {a.shape[0]} != is_read length {r.shape[0]}",
            tenant, window)
    if a.dtype not in _INT_DTYPES:
        raise TraceError(
            f"non-integer block addresses (dtype {a.dtype})", tenant, window)
    if a.numel() and int(a.min()) < 0:
        raise TraceError(
            f"negative block address {int(a.min())}", tenant, window)
    if r.dtype != torch.bool:
        if r.dtype not in _INT_DTYPES:
            raise TraceError(
                f"op codes must be bool or {{0,1}} ints (dtype {r.dtype})",
                tenant, window)
        if r.numel():
            bad = (r != 0) & (r != 1)
            if bool(bad.any()):
                raise TraceError(
                    f"unknown op code {int(r[bad][0])} (expected 0=write, "
                    f"1=read)", tenant, window)


def validate_trace(trace: "Trace", tenant: int = -1,
                   window: int = -1) -> None:
    """``validate_trace_arrays`` over a ``Trace`` (same raises)."""
    validate_trace_arrays(trace.addrs, trace.is_read, tenant, window)


class AccessClass(enum.IntEnum):
    """Per-access classification codes (stable ints: used in tensors)."""

    CR = 0   # cold read
    CW = 1   # cold write
    RAR = 2  # read after read
    RAW = 3  # read after write
    WAR = 4  # write after read
    WAW = 5  # write after write


@dataclasses.dataclass(frozen=True)
class Trace:
    """A single tenant's block-access trace.

    Attributes:
      addrs:    int64[n]  block addresses (opaque ids).
      is_read:  bool[n]   True = read, False = write.
      name:     workload label (e.g. ``wdev_0``).

    numpy arrays are taken as tensors (sharing memory).
    """

    addrs: torch.Tensor
    is_read: torch.Tensor
    name: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(self, "addrs", torch.as_tensor(self.addrs))
        object.__setattr__(self, "is_read", torch.as_tensor(self.is_read))
        if self.addrs.shape != self.is_read.shape:
            raise ValueError(
                f"addrs {tuple(self.addrs.shape)} vs is_read "
                f"{tuple(self.is_read.shape)}")
        if self.addrs.dim() != 1:
            raise ValueError("trace arrays must be 1-D")

    def __len__(self) -> int:
        return int(self.addrs.shape[0])


def prev_next_occurrence(addrs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prev/next occurrence indices per position (int64).

    prev[i] = largest j < i with addrs[j] == addrs[i], else -1.
    nxt[j]  = smallest i > j with addrs[i] == addrs[j], else n.

    O(n log n) via a stable sort on the address (ties keep position
    order, like the reference's ``np.argsort(kind="stable")``).
    """
    n = addrs.shape[0]
    dev = addrs.device
    order = torch.sort(addrs, stable=True).indices
    sa = addrs[order]
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = sa[1:] == sa[:-1]
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev[order[1:]] = torch.where(same[1:], order[:-1], -1)
    nxt = torch.full((n,), n, dtype=torch.int64, device=dev)
    nxt[order[:-1]] = torch.where(same[1:], order[1:], n)
    return prev, nxt


def classify_accesses(trace: Trace) -> torch.Tensor:
    """Return AccessClass code per access (paper Fig. 6 taxonomy)."""
    prev, _ = prev_next_occurrence(trace.addrs)
    is_read = trace.is_read.to(torch.bool)
    hot = prev >= 0
    prev_read = hot & is_read[torch.clamp(prev, min=0)]
    # code = 2 + 2 * (current is a write) + (previous touch was a write)
    code = 2 + 2 * (~is_read).to(torch.int64) + (~prev_read).to(torch.int64)
    return torch.where(hot, code, (~is_read).to(torch.int64))


def request_type_mix(trace: Trace) -> dict[str, float]:
    """Fraction of each AccessClass in the trace (paper Fig. 12)."""
    counts = torch.bincount(classify_accesses(trace),
                            minlength=len(AccessClass)).tolist()
    n = max(len(trace), 1)
    return {c.name: float(counts[c]) / n for c in AccessClass}


def total_cache_writes_wb(trace: Trace) -> int:
    """Paper Eq. 3: TotalWrites = CR + CW + WAR + WAW under the WB policy.

    Every cold access installs a block (1 SSD write); every write re-touch
    modifies a cached block (1 SSD write).  RAR/RAW re-touches are pure
    reads.
    """
    codes = classify_accesses(trace)
    writes = torch.tensor([AccessClass.CR, AccessClass.CW, AccessClass.WAR,
                           AccessClass.WAW], device=codes.device)
    return int(torch.isin(codes, writes).sum())
