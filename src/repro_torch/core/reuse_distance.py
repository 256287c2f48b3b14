"""Reuse-distance results (TRD and URD) and the URD-based cache size.

Definitions (paper §4): a reuse-distance sample at access ``i`` with a
previous access to the same address at ``p`` is the number of distinct
addresses touched strictly between ``p`` and ``i``.  TRD samples every
re-touch; URD only read re-touches (RAR, RAW).  The distances themselves
come from one of three exact engines, which give the same integers:

  * ``reuse_distances``            — the Fenwick-tree oracle, O(n log n),
                                     a host loop (the classic
                                     Bennett–Kruskal / Olken formulation);
  * ``reuse_distances_vectorized`` — dense masked counting on the
                                     ``prev``/``nxt`` occurrence links,
                                     ``urd_scan``'s plain version;
  * ``batch_sim.reuse_distances_fast`` — the stack-distance count of the
                                     batch engine (``cache_sim_scan`` on
                                     the card, the merge tree on the CPU).

The Analyzer's kernel route is ``kernels.urd_scan.ops.
reuse_distances_accel``.

SHARDS (Waldspurger et al., FAST'15) samples spatially: an address is
kept when its salted multiplicative hash falls below ``rate``, every
access of a kept address is measured on the filtered sub-trace, and
distances are scaled back by ``1/rate``.  The salt, the hash and the
rate tuner repeat the reference's integers exactly, so the port keeps
the same addresses as the reference on any device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.trace import Trace, prev_next_occurrence
from repro_torch.kernels.cache_sim.ops import stack_distances
from repro_torch.kernels.urd_scan.ref import urd_scan_ref

__all__ = ["RDResult", "auto_sample_rate", "max_rd", "reuse_distances",
           "reuse_distances_vectorized", "sampled_reuse_distances", "shards_hash", "shards_keep_mask",
           "shards_salt", "shards_threshold", "urd_cache_blocks"]

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
_HASH_MUL = 2654435761                 # Knuth's multiplicative constant


@dataclasses.dataclass(frozen=True)
class RDResult:
    """Per-access reuse-distance samples.

    distances: int64[n] — RD sample per access; -1 where the access
      produced no sample (cold access, or — for URD — a write access).
    kind: "trd" | "urd".
    rate: spatial sampling rate the samples were measured at (1.0 =
      exact; sampled distances are already scaled back by 1/rate).
    expected_error: expected absolute curve error, ~1/sqrt(kept distinct
      addresses) when sampled, 0.0 when exact.
    """

    distances: torch.Tensor
    kind: str
    rate: float = 1.0
    expected_error: float = 0.0

    @property
    def samples(self) -> torch.Tensor:
        return self.distances[self.distances >= 0]

    def histogram(self, max_bins: int | None = None) -> torch.Tensor:
        """int64 counts of each distance (the last bin gathers everything
        at or above ``max_bins - 1``); ``[0]`` when there are no samples."""
        s = self.samples
        if s.numel() == 0:
            return torch.zeros(1, dtype=torch.int64,
                               device=self.distances.device)
        hi = int(s.max()) + 1 if max_bins is None else int(max_bins)
        return torch.bincount(torch.clamp(s, max=hi - 1), minlength=hi)


def _check_kind(kind: str) -> None:
    if kind not in ("trd", "urd"):
        raise ValueError(f"kind must be 'trd' or 'urd', got {kind!r}")


def reuse_distances(trace: Trace, kind: str = "urd") -> RDResult:
    """Exact reuse distances via a Fenwick tree, O(n log n): the oracle.

    The tree holds a 1 at the position of the last occurrence of every
    address seen so far; the ones strictly between ``prev`` and the
    current position are the distinct intervening addresses.  A host
    loop over Python integers; the result lies on the trace's device.
    """
    _check_kind(kind)
    n = len(trace)
    addrs = trace.addrs.tolist()
    reads = trace.is_read.to(torch.bool).tolist()
    tree = [0] * (n + 1)
    last: dict[int, int] = {}
    out = [-1] * n
    for i in range(n):
        a = addrs[i]
        p = last.get(a)
        if p is not None:
            if kind == "trd" or reads[i]:
                s, k = 0, i                    # prefix(i) - prefix(p + 1)
                while k > 0:
                    s += tree[k]
                    k -= k & -k
                k = p + 1
                while k > 0:
                    s -= tree[k]
                    k -= k & -k
                out[i] = s
            k = p + 1                          # add(p, -1)
            while k <= n:
                tree[k] -= 1
                k += k & -k
        k = i + 1                              # add(i, +1)
        while k <= n:
            tree[k] += 1
            k += k & -k
        last[a] = i
    return RDResult(torch.tensor(out, dtype=torch.int64,
                                 device=trace.addrs.device), kind)


def reuse_distances_vectorized(trace: Trace, kind: str = "urd") -> RDResult:
    """Exact reuse distances by dense masked counting, O(n²) tensor ops.

    ``RD(i) = #{ j : prev[i] < j < i and nxt[j] >= i }``: each distinct
    intervening address contributes exactly its last occurrence inside
    the interval.  The count is ``urd_scan``'s plain version
    (``kernels.urd_scan.ref.urd_scan_ref``), on the trace's device.
    """
    _check_kind(kind)
    prev, nxt = prev_next_occurrence(trace.addrs)
    mask = prev >= 0
    if kind == "urd":
        mask &= trace.is_read.to(torch.bool)
    counts = urd_scan_ref(prev, nxt).to(torch.int64)
    return RDResult(torch.where(mask, counts, -1), kind)


def max_rd(result: RDResult, percentile: float = 100.0) -> int:
    """Max (or percentile) reuse distance; -1 when no samples exist.

    The percentile interpolates linearly between order statistics, as
    ``np.percentile``'s default does."""
    s = result.samples
    if s.numel() == 0:
        return -1
    if percentile >= 100.0:
        return int(s.max())
    return int(torch.quantile(s.to(torch.float64), percentile / 100.0))


def urd_cache_blocks(result: RDResult, percentile: float = 100.0) -> int:
    """Paper ``calculateURDbasedSize``: a reuse at distance d needs d + 1
    resident blocks (Fig. 5: max URD 1 -> 2 blocks)."""
    m = max_rd(result, percentile)
    return m + 1 if m >= 0 else 0


def shards_salt(seed: int, tenant: int = 0) -> int:
    """Deterministic SHARDS hash salt in ``[1, 2**31 - 3]``.

    A splitmix64-style mix of ``(seed, tenant)`` in Python integers: the
    same (tenant, window) pair always keeps the same address subset,
    while distinct tenants and windows decorrelate.
    """
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(tenant) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return int(z % (2**31 - 3)) + 1


def auto_sample_rate(n: int, target: int = 4096, floor: int = 256) -> float:
    """SHARDS rate tuner: aim for ``target`` kept accesses per window;
    windows shorter than ``max(target, floor)`` are measured exactly."""
    n = int(n)
    if n <= 0:
        return 1.0
    want = max(int(target), int(floor), 1)
    return min(1.0, want / n)


def shards_threshold(rate: float) -> int:
    """The integer hash threshold ``ceil(rate * 2**32)``; ``>= 2**32``
    keeps every address."""
    return math.ceil(rate * float(2**32))


def shards_hash(addrs: torch.Tensor, salt) -> torch.Tensor:
    """``((addr mod 2**32) * 2654435761 + salt) mod 2**32`` in int64.

    The 64-bit product could overflow int64, so the multiplier is split
    into 16-bit halves: ``a * lo`` and ``a * hi`` each stay below 2**48,
    and only the low 16 bits of ``a * hi`` survive the shift by 16 under
    the final mod.  ``salt`` is an int or an int64 tensor (per access).
    """
    a = addrs.to(torch.int64) & _MASK32
    lo, hi = _HASH_MUL & 0xFFFF, _HASH_MUL >> 16
    h = a * lo + (((a * hi) & 0xFFFF) << 16) + salt
    return h & _MASK32


def shards_keep_mask(addrs: torch.Tensor, rate: float,
                     salt: int) -> torch.Tensor:
    """bool[n]: the SHARDS spatial filter ``hash(addr) < rate`` (salted),
    exactly the reference's uint32 test."""
    thr = shards_threshold(rate)
    if thr >= 2**32:        # rate == 1 (or within 2**-32 of it): keep all
        return torch.ones(addrs.shape[0], dtype=torch.bool,
                          device=addrs.device)
    return shards_hash(addrs, int(salt)) < thr


def sampled_reuse_distances(trace: Trace, kind: str = "urd",
                            rate: float | str = 0.1, seed: int = 0,
                            salt: int | None = None,
                            target_samples: int = 4096,
                            min_samples: int = 256) -> RDResult:
    """SHARDS-sampled reuse distances of one trace, scaled by ``1/rate``.

    ``rate="auto"`` picks ``auto_sample_rate(len(trace), target_samples,
    min_samples)``.  The kept sub-trace is counted by
    ``kernels.cache_sim.ops.stack_distances`` on the trace's device;
    scaled values round half to even, as ``np.round`` does.  A window
    that keeps nothing returns no samples and an error bar of 1.0.
    """
    _check_kind(kind)
    if rate == "auto":
        rate = auto_sample_rate(len(trace), target_samples, min_samples)
    rate = float(rate)
    if not (0 < rate <= 1):
        raise ValueError("rate must be in (0, 1]")
    if salt is None:
        salt = shards_salt(seed)
    n = len(trace)
    dev = trace.addrs.device
    keep = shards_keep_mask(trace.addrs, rate, salt)
    scaled = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if not bool(keep.any()):
        return RDResult(scaled, kind, rate=rate,
                        expected_error=0.0 if n == 0 else 1.0)
    sub_addr = trace.addrs[keep].to(torch.int64)
    prev, nxt = prev_next_occurrence(sub_addr)
    sd = stack_distances(prev, nxt)
    if kind == "urd":
        sd = torch.where(trace.is_read[keep].to(torch.bool), sd, -1)
    # a tensor divisor: CUDA would multiply by a Python number's reciprocal
    r = torch.tensor(rate, dtype=torch.float64, device=dev)
    vals = torch.where(sd >= 0,
                       torch.round(sd.to(torch.float64) / r)
                       .to(torch.int64), -1)
    scaled[keep] = vals
    distinct = int((prev < 0).sum())
    err = (0.0 if rate >= 1.0
           else min(1.0, 1.0 / math.sqrt(max(distinct, 1))))
    return RDResult(scaled, kind, rate=rate, expected_error=err)
