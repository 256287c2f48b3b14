"""Miss-ratio curves and the paper's hit-ratio step function H_i(c).

Paper Alg. 2: ``H_i(c)`` is a non-decreasing step function of cache size
— an access with reuse distance ``d`` hits an LRU cache of ``c`` blocks
iff ``d < c``.  The breakpoints are the distinct observed reuse
distances (+1), the plateau values the cumulative fraction of accesses
whose distance falls below each breakpoint.  For URD-based curves the
numerator counts only read re-uses; the denominator is all accesses.

Heights are float64 and computed by the same integer cumsums over the
same denominators as the reference (one IEEE division each, always by a
tensor: CUDA divides by a Python number as a multiply by its
reciprocal), so they are bit-identical on any device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.reuse_distance import RDResult

__all__ = ["HitRatioFunction", "BatchedHitRatioFunctions",
           "build_hit_ratio_function", "build_hit_ratio_functions"]


@dataclasses.dataclass(frozen=True)
class HitRatioFunction:
    """Piecewise-constant h(c) = heights[k] for c in [edges[k], edges[k+1]).

    edges:   int64[k], edges[0] == 0, strictly increasing.
    heights: float64[k], non-decreasing (flat at heights[-1] beyond).
    n_accesses: denominator used (for latency weighting across tenants).
    """

    edges: torch.Tensor
    heights: torch.Tensor
    n_accesses: int

    def __call__(self, c) -> torch.Tensor | float:
        scalar = not isinstance(c, torch.Tensor)
        c_t = torch.as_tensor(c, device=self.edges.device)
        edges = (self.edges.to(c_t.dtype) if c_t.is_floating_point()
                 else self.edges)
        idx = torch.searchsorted(edges, c_t, right=True) - 1
        idx = torch.clamp(idx, 0, self.heights.shape[0] - 1)
        out = torch.where(c_t <= 0, 0.0, self.heights[idx])
        return float(out) if scalar else out

    @property
    def max_useful_size(self) -> int:
        """Smallest c achieving the maximum hit ratio (== URD-based size)."""
        return int(self.edges[-1])

    @property
    def max_hit_ratio(self) -> float:
        return float(self.heights[-1]) if self.heights.numel() else 0.0

    def marginal_gain(self, c: int) -> tuple[int, float]:
        """From size c: (next breakpoint size, hit-ratio gain going there).

        Returns (c, 0.0) when the curve is already saturated.
        """
        k = int(torch.searchsorted(
            self.edges, torch.tensor([int(c)], device=self.edges.device),
            right=True)[0])
        if k >= self.edges.shape[0]:
            return c, 0.0
        nxt = int(self.edges[k])
        cur = self(c)
        return nxt, float(self.heights[min(k, self.heights.shape[0] - 1)]) \
            - cur

    def shifted(self, base: int) -> "HitRatioFunction":
        """Residual curve ``h~(c) = h(base + c) - h(base)``: level-2 input.

        With ``base`` L1 blocks granted, ``c`` more L2 blocks turn exactly
        the accesses with reuse distance in ``[base, base + c)`` into L2
        hits (the union of the levels is one LRU stack).  The same
        ``searchsorted`` split and float64 subtractions as the reference,
        so the curve is bit-identical.  ``shifted(0) == self``.
        """
        base = max(int(base), 0)
        dev = self.edges.device
        k = int(torch.searchsorted(
            self.edges, torch.tensor([base], device=dev), right=True)[0])
        h0 = float(self(base)) if base > 0 else float(self.heights[0])
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        edges = torch.cat([zero, self.edges[k:] - base])
        heights = torch.cat([zero.to(torch.float64), self.heights[k:] - h0])
        return HitRatioFunction(edges, heights, self.n_accesses)


def build_hit_ratio_function(rd: RDResult, n_accesses: int | None = None
                             ) -> HitRatioFunction:
    """Construct H(c) from exact reuse-distance samples.

    An access with distance d hits a cache of size c iff d + 1 <= c;
    cold accesses and (for URD) write re-touches never hit.
    """
    samples = rd.samples
    dev = rd.distances.device
    n = max(int(n_accesses if n_accesses is not None
                else rd.distances.shape[0]), 1)
    if samples.numel() == 0:
        return HitRatioFunction(torch.zeros(1, dtype=torch.int64,
                                            device=dev),
                                torch.zeros(1, dtype=torch.float64,
                                            device=dev), n)
    sizes, counts = torch.unique(samples + 1, return_counts=True)
    # divide by a tensor on the device: a CUDA tensor divided by a Python
    # number is multiplied by its reciprocal, which is not correctly
    # rounded (3 / 5 != 3 * (1 / 5))
    heights = (torch.cumsum(counts, 0).to(torch.float64)
               / torch.tensor(float(n), dtype=torch.float64, device=dev))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return HitRatioFunction(torch.cat([zero, sizes]),
                            torch.cat([zero.to(torch.float64), heights]), n)


@dataclasses.dataclass(frozen=True)
class BatchedHitRatioFunctions:
    """N hit-ratio step curves backed by stacked breakpoint tensors.

    Curve ``i`` owns ``edges[offsets[i]:offsets[i+1]]`` (int64, starts at
    0, strictly increasing) and the matching ``heights`` slice.  Behaves
    as a read-only sequence of :class:`HitRatioFunction` views.
    """

    edges: torch.Tensor       # int64[M] concatenated breakpoint sizes
    heights: torch.Tensor     # float64[M] concatenated plateau values
    offsets: torch.Tensor     # int64[N+1] curve boundaries
    n_accesses: torch.Tensor  # int64[N] per-curve denominators

    def __len__(self) -> int:
        return int(self.n_accesses.shape[0])

    def __getitem__(self, i: int) -> HitRatioFunction:
        i = range(len(self))[int(i)]
        o, o2 = self.offsets[i:i + 2].tolist()
        return HitRatioFunction(self.edges[o:o2], self.heights[o:o2],
                                int(self.n_accesses[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def to(self, device: str | torch.device) -> "BatchedHitRatioFunctions":
        return BatchedHitRatioFunctions(
            self.edges.to(device), self.heights.to(device),
            self.offsets.to(device), self.n_accesses.to(device))

    @classmethod
    def from_curves(cls, hs) -> "BatchedHitRatioFunctions":
        """Stack a list of curves (no-op passthrough if already batched)."""
        if isinstance(hs, cls):
            return hs
        hs = list(hs)
        if not hs:
            z = torch.zeros(0, dtype=torch.int64)
            return cls(z, z.to(torch.float64), torch.zeros(1, dtype=torch.int64),
                       z)
        dev = hs[0].edges.device
        lens = torch.tensor([h.edges.shape[0] for h in hs], dtype=torch.int64,
                            device=dev)
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(lens, 0)])
        return cls(torch.cat([h.edges.to(torch.int64) for h in hs]),
                   torch.cat([h.heights.to(torch.float64) for h in hs]),
                   offsets,
                   torch.tensor([h.n_accesses for h in hs], dtype=torch.int64,
                                device=dev))

    # ------------------------------------------------------------ queries
    @property
    def max_useful_sizes(self) -> torch.Tensor:
        """int64[N]: each curve's smallest saturating size (URD sizes)."""
        return self.edges[self.offsets[1:] - 1]

    @property
    def max_hit_ratios(self) -> torch.Tensor:
        """float64[N]: each curve's plateau (its largest hit ratio)."""
        return self.heights[self.offsets[1:] - 1]

    def _composite(self, queries: torch.Tensor) -> torch.Tensor:
        """Global insertion positions of per-curve queries (side='right')."""
        lens = torch.diff(self.offsets)
        big = int(self.edges.max()) + 2 if self.edges.numel() else 2
        n = len(self)
        ar = torch.arange(n, dtype=torch.int64, device=self.edges.device)
        seg = torch.repeat_interleave(ar, lens)
        q = torch.clamp(queries.to(torch.int64), 0, big - 1)
        return torch.searchsorted(seg * big + self.edges, ar * big + q,
                                  right=True)

    def evaluate(self, sizes) -> torch.Tensor:
        """Vectorized ``h_i(sizes[i])`` for all curves (one searchsorted),
        bit-identical to calling each :class:`HitRatioFunction` view."""
        c = torch.as_tensor(sizes, device=self.edges.device)
        if len(self) == 0:
            return torch.zeros(0, dtype=torch.float64,
                               device=self.edges.device)
        lens = torch.diff(self.offsets)
        idx = self._composite(c) - 1 - self.offsets[:-1]
        idx = torch.minimum(torch.clamp(idx, min=0), lens - 1)
        out = self.heights[self.offsets[:-1] + idx]
        return torch.where(c <= 0, 0.0, out)

    def shifted(self, bases) -> "BatchedHitRatioFunctions":
        """Vectorized residual curves ``h~_i(c) = h_i(base_i + c) -
        h_i(base_i)``, bit-for-bit ``HitRatioFunction.shifted`` per curve
        (the same split, the same float64 subtractions); the level-2
        stage of ``two_level_solve`` runs on it with no loop over
        tenants."""
        dev = self.edges.device
        b = torch.clamp(torch.as_tensor(bases, dtype=torch.int64,
                                        device=dev), min=0)
        n = len(self)
        if n == 0:
            return self
        i64 = dict(dtype=torch.int64, device=dev)
        lens = torch.diff(self.offsets)
        k = self._composite(b) - self.offsets[:-1]        # per-curve split
        h0 = torch.where(b > 0, self.evaluate(b),
                         self.heights[self.offsets[:-1]])
        tail = lens - k                                    # kept breakpoints
        new_off = torch.cat([torch.zeros(1, **i64),
                             torch.cumsum(tail + 1, 0)])   # +1: the 0 head
        total_new = int(new_off[-1])
        edges = torch.zeros(total_new, **i64)
        heights = torch.zeros(total_new, dtype=torch.float64, device=dev)
        total = int(tail.sum())
        if total:
            rank = (torch.arange(total, **i64)
                    - torch.repeat_interleave(torch.cumsum(tail, 0) - tail,
                                              tail))
            src = torch.repeat_interleave(self.offsets[:-1] + k, tail) + rank
            dst = torch.repeat_interleave(new_off[:-1] + 1, tail) + rank
            edges[dst] = self.edges[src] - torch.repeat_interleave(b, tail)
            heights[dst] = self.heights[src] \
                - torch.repeat_interleave(h0, tail)
        return BatchedHitRatioFunctions(edges, heights, new_off,
                                        self.n_accesses.clone())


def build_hit_ratio_functions(dist: torch.Tensor, tid: torch.Tensor,
                              n_tenants: int, n_accesses: torch.Tensor,
                              rates: torch.Tensor | None = None,
                              mask: torch.Tensor | None = None
                              ) -> BatchedHitRatioFunctions:
    """Batched ``build_hit_ratio_function``: every tenant in one sort.

    ``dist`` holds all tenants' reuse-distance samples concatenated (-1 =
    no sample), ``tid`` the tenant id per position.  Per-(tenant, size)
    counts come from one sort of composite keys and segmented reductions;
    plateau heights are the same integer cumsums over the same
    denominators as the per-tenant constructor.  ``mask`` selects the
    samples (default: ``dist >= 0``).  ``rates`` (per-tenant SHARDS rates)
    switches the heights to the scaled-and-clipped sampled estimator
    ``min(cum / (n_acc * r), 1)``, in the reference's operation order.
    """
    dev = dist.device
    n_acc = torch.clamp(torch.as_tensor(n_accesses, dtype=torch.int64,
                                        device=dev), min=1)
    if mask is None:
        mask = dist >= 0
    s = dist[mask] + 1
    t = tid[mask]
    i64 = dict(dtype=torch.int64, device=dev)
    if s.numel():
        big = int(s.max()) + 1
        if n_tenants * big < 2**62:
            ks = torch.sort(t * big + s).values
            ts = ks // big
            ss = ks - ts * big
        else:
            order = torch.sort(s, stable=True).indices
            order = order[torch.sort(t[order], stable=True).indices]
            ss, ts = s[order], t[order]
        new = torch.ones(ss.shape[0], dtype=torch.bool, device=dev)
        new[1:] = (ss[1:] != ss[:-1]) | (ts[1:] != ts[:-1])
        uidx = torch.nonzero(new).squeeze(1)
        sizes_u, t_u = ss[uidx], ts[uidx]
        counts = torch.diff(uidx, append=torch.tensor([ss.shape[0]], **i64))
        csum = torch.cumsum(counts, 0)
        head = torch.ones(t_u.shape[0], dtype=torch.bool, device=dev)
        head[1:] = t_u[1:] != t_u[:-1]
        starts = torch.nonzero(head).squeeze(1)
        seg_lens = torch.diff(starts,
                              append=torch.tensor([t_u.shape[0]], **i64))
        base = torch.repeat_interleave(csum[starts] - counts[starts],
                                       seg_lens)
        cum_in = csum - base            # within-tenant cumulative counts
    else:
        sizes_u = t_u = cum_in = starts = seg_lens = torch.zeros(0, **i64)
    k_per = torch.bincount(t_u, minlength=n_tenants)
    off = torch.cat([torch.zeros(1, **i64), torch.cumsum(k_per + 1, 0)])
    total = int(off[-1])
    edges = torch.zeros(total, **i64)
    heights = torch.zeros(total, dtype=torch.float64, device=dev)
    if s.numel():
        rank = (torch.arange(t_u.shape[0], **i64)
                - torch.repeat_interleave(starts, seg_lens))
        dst = off[t_u] + 1 + rank
        edges[dst] = sizes_u
        cum = cum_in.to(torch.float64)
        den = n_acc[t_u].to(torch.float64)
        if rates is None:
            heights[dst] = cum / den
        else:
            r = torch.as_tensor(rates, dtype=torch.float64, device=dev)
            heights[dst] = torch.clamp(cum / (den * r[t_u]), max=1.0)
    return BatchedHitRatioFunctions(edges, heights, off, n_acc)
