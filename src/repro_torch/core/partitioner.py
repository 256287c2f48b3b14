"""Cache-space partitioner solving the paper's Eq. 2.

    Latency_i(c_i) = h_i(c_i) * T_fast + (1 - h_i(c_i)) * T_slow
    minimize   sum_i w_i * Latency_i(c_i)
    subject to sum_i c_i <= C,    c_min <= c_i <= c_urd_i

``pgd_solve`` is the manager's default partitioner (the paper's
``fmincon`` analog): projected-gradient descent in float32 on the
piecewise-linear relaxation of each H_i, with a bisection projection onto
{ sum c <= C } ∩ box, then a snap down to breakpoints and a greedy
repair.  It is a port of the reference's jitted JAX loop:

  * the relaxation tables are resampled in float64 exactly as
    ``np.linspace`` + ``np.interp`` do, then rounded to float32;
  * the gradient of ``jnp.interp`` is the active segment's slope,
    ``(ct * df) / dx`` with ``ct = w * t_fast - w * t_slow``;
  * square roots are correctly rounded float32 roots (``_sqrt32``), as
    XLA's are;
  * ``lax.cond`` becomes ``torch.where``, so nothing is read back to
    the host inside the loop.

Sums over tenants take one of two routes, split at 32 tenants:

  * **Up to 32 tenants** they repeat XLA's CPU float32 order: left to
    right, with the squared norm and the step as fused multiply-adds
    (XLA contracts them), emulated in float64 — the product is exact
    there and the sum rounds twice, which can differ from one rounding
    only on an exact float32 halfway case.  The relaxed optimum is then
    bit-identical to the reference's (with ``torch.sum``, a float32
    ``torch.sqrt`` and unfused steps the trajectory drifts across
    segments and the decided sizes change).  The price is one launch
    per tenant in every sum.
  * **Past 32 tenants** XLA vectorises its sums, and no order the port
    can pick repeats it (none of left to right, or 4, 8, 16 or 32 lanes
    closed left to right or as a tree, matches its 256-element float32
    sum on most inputs).  So these sums are a pairwise tree instead:
    zero-padded to a power of two and halved, ⌈log2 n⌉ elementwise adds
    with no loop over tenants, and squares rounded to float32 before
    they are summed.  The relaxed optimum then differs from the
    reference's in the last bits (``tests/test_torch_core.py`` states
    the tolerance), and a decided size can differ only where the
    optimum lies at a breakpoint.

Every operation is an elementwise IEEE op or an exact reduction on one
device, so the card and the CPU produce the same bits on both routes.
``two_level_solve`` runs the partitioner twice for the ETICA hierarchy,
the second time on the residual curves.

``greedy_allocate`` is the breakpoint greedy (Centaur's convex-hull
walk): grant the jump with the best latency-reduction density
(Δlatency / Δblocks) until the budget is spent.  ``method="heap"`` is
the reference's one-pop-at-a-time loop, on the host (the oracle);
``method="fast"`` the vectorized walk on the curves' device, whose grant
order, and so its allocation, is bit-identical to the heap's: each
tenant's chain of steps is reduced to its prefix-min density envelope,
one stable sort merges the chains, and a prefix sum over Δc finds the
budget cut and the partial grant.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq

import torch

from repro_torch.core.mrc import BatchedHitRatioFunctions

__all__ = ["PartitionResult", "aggregate_latency", "greedy_allocate",
           "pgd_solve", "two_level_solve"]

_TABLE_PTS = 128
# np.spacing(np.finfo(np.float32).eps): jnp.interp's zero-width guard
_DX_EPS = 1.4210854715202004e-14


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    sizes: torch.Tensor        # int64[N] allocated blocks per tenant (host)
    feasible: bool             # True iff sum(urd sizes) <= C (paper's term)
    latency: float             # aggregate objective value at `sizes`
    hit_ratios: torch.Tensor   # float64[N] at `sizes` (host)
    # float32[N] continuous PGD optimum before the snap (None if feasible)
    relaxed: torch.Tensor | None = None


def aggregate_latency(hs, sizes, t_fast: float, t_slow: float,
                      weights=None) -> float:
    """Paper Eq. 2 objective at an allocation (vectorized over tenants)."""
    b = BatchedHitRatioFunctions.from_curves(hs)
    dev = b.edges.device
    w = (torch.ones(len(b), dtype=torch.float64, device=dev)
         if weights is None
         else torch.as_tensor(weights, dtype=torch.float64, device=dev))
    hr = b.evaluate(torch.as_tensor(sizes, device=dev))
    return float(torch.sum(w * (hr * t_fast + (1.0 - hr) * t_slow)))


def greedy_allocate(hs, capacity: int, t_fast: float, t_slow: float,
                    c_min: int = 0, weights=None,
                    method: str = "fast") -> PartitionResult:
    """Breakpoint-greedy partitioner (the discrete reference optimizer).

    Feasible case (paper Alg. 1 line 8): the URD-based sizes all fit and
    are granted outright.  Otherwise every tenant starts at
    ``min(c_min, urd size)`` (scaled down when even those do not fit) and
    the breakpoints are walked by best Δlatency/Δblocks until the budget
    is exhausted, the first step past it granted partially.  ``"fast"``
    walks on the curves' device, ``"heap"`` on the host; both give the
    same sizes.  Sizes and hit ratios come back on the host.
    """
    if method == "device":
        raise NotImplementedError(
            "greedy_allocate(method='device') is not ported yet (ROADMAP: "
            "modules queue, item 3, device and shard pipelines)")
    if method not in ("fast", "heap"):
        raise ValueError(f"method must be 'fast', 'heap' or 'device', got "
                         f"{method!r}")
    b = BatchedHitRatioFunctions.from_curves(hs)
    n = len(b)
    dev = b.edges.device
    w = (torch.ones(n, dtype=torch.float64, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float64, device=dev))
    urd_sizes = b.max_useful_sizes
    if int(urd_sizes.sum()) <= capacity:
        sizes = urd_sizes.clone()
        return PartitionResult(
            sizes.cpu(), True, aggregate_latency(b, sizes, t_fast, t_slow, w),
            b.evaluate(sizes).cpu())
    c_min_arr = torch.clamp(urd_sizes, max=int(c_min))
    sizes = c_min_arr.clone()
    budget = capacity - int(sizes.sum())
    if budget < 0:  # even the minimums do not fit: scale the minimums down
        den = torch.tensor(float(max(int(c_min_arr.sum()), 1)),
                           dtype=torch.float64, device=dev)
        sizes = torch.floor((c_min_arr * capacity).to(torch.float64) / den
                            ).to(torch.int64)
        budget = capacity - int(sizes.sum())
    gain = t_slow - t_fast  # latency saved per unit hit-ratio
    if method == "heap":
        sizes = _greedy_walk_heap(b.to("cpu"), sizes.cpu(), budget,
                                  w.cpu(), gain).to(dev)
    else:
        sizes = _greedy_walk_fast(b, sizes, budget, w, gain)
    return PartitionResult(
        sizes.cpu(), False, aggregate_latency(b, sizes, t_fast, t_slow, w),
        b.evaluate(sizes).cpu())


def _greedy_walk_heap(b: BatchedHitRatioFunctions, sizes: torch.Tensor,
                      budget: int, w: torch.Tensor,
                      gain: float) -> torch.Tensor:
    """The reference's heap loop (the oracle): pop the densest next
    breakpoint, grant it, push the tenant's following step.

    The curves are read as Python lists, and ``HitRatioFunction``'s
    ``marginal_gain`` is repeated on them (the same ``searchsorted``
    positions, the same float64 subtraction), so each pop costs
    microseconds.
    """
    n = len(b)
    off = b.offsets.tolist()
    edges_all, heights_all = b.edges.tolist(), b.heights.tolist()
    edges = [edges_all[off[i]:off[i + 1]] for i in range(n)]
    heights = [heights_all[off[i]:off[i + 1]] for i in range(n)]
    urd_sizes = [e[-1] for e in edges]
    wl = w.tolist()
    sz = sizes.tolist()
    heap: list[tuple[float, int, int, int, float]] = []

    def marginal_gain(i: int, c: int) -> tuple[int, float]:
        e, h = edges[i], heights[i]
        k = bisect.bisect_right(e, c)
        if k >= len(e):
            return c, 0.0
        cur = 0.0 if c <= 0 else h[min(max(k - 1, 0), len(h) - 1)]
        return e[k], h[min(k, len(h) - 1)] - cur

    def push(i: int) -> None:
        nxt, dh = marginal_gain(i, sz[i])
        dc = nxt - sz[i]
        if dh > 0 and dc > 0 and nxt <= urd_sizes[i]:
            density = wl[i] * dh * gain / dc
            heapq.heappush(heap, (-density, i, nxt, dc, dh))

    for i in range(n):
        push(i)
    while heap and budget > 0:
        _, i, nxt, dc, _ = heapq.heappop(heap)
        if nxt - sz[i] != dc:               # stale entry
            push(i)
            continue
        if dc > budget:                     # partial grant: no hit-ratio
            sz[i] += budget                 # step is crossed, but the
            budget = 0                      # budget is spent (paper's
            break                           # diff term)
        sz[i] = nxt
        budget -= dc
        push(i)
    return torch.tensor(sz, dtype=torch.int64)


def _greedy_walk_fast(b: BatchedHitRatioFunctions, sizes: torch.Tensor,
                      budget: int, w: torch.Tensor,
                      gain: float) -> torch.Tensor:
    """Vectorized replay of the heap walk (bit-identical grant order), on
    the curves' device.

    A tenant's chain of steps is consumed in curve order, so a step's
    priority under "always pop the densest head" is the running minimum
    of densities along its chain (its envelope); merging the chains by
    (envelope desc, tenant, step) reproduces the heap's pops, ties
    included.  The steps are laid out tenant by tenant and step by step,
    so that order is one stable sort on the negated envelope (the
    reference's ``np.lexsort((rank, st_tid, -e))``).  A prefix sum over
    Δc then finds the budget cut and the partial-grant step.  The
    densities are the heap's float64 operations in the heap's order.
    """
    n = len(b)
    if budget <= 0 or n == 0:
        return sizes
    dev = b.edges.device
    i64 = dict(dtype=torch.int64, device=dev)
    edges, heights, off = b.edges, b.heights, b.offsets
    lens = torch.diff(off)
    # first step per tenant: the first breakpoint above its current size
    k0 = b._composite(sizes) - off[:-1]
    n_steps = torch.clamp(lens - k0, min=0)
    total = int(n_steps.sum())
    if total == 0:
        return sizes
    st_tid = torch.repeat_interleave(torch.arange(n, **i64), n_steps)
    seg0 = torch.repeat_interleave(torch.cumsum(n_steps, 0) - n_steps,
                                   n_steps)
    rank = torch.arange(total, **i64) - seg0
    gk = off[st_tid] + k0[st_tid] + rank          # breakpoint per step
    h_cur0 = b.evaluate(sizes)                    # h at the starting sizes
    first = rank == 0
    gprev = torch.clamp(gk - 1, min=0)
    dh = heights[gk] - torch.where(first, h_cur0[st_tid], heights[gprev])
    dc = edges[gk] - torch.where(first, sizes[st_tid], edges[gprev])
    # the heap stops a chain at its first non-improving step
    bad = (dh <= 0).to(torch.int64)
    cbad = torch.cumsum(bad, 0)
    valid = (cbad - cbad[seg0] + bad[seg0]) == 0
    if not bool(valid.any()):
        return sizes
    st_tid, gk = st_tid[valid], gk[valid]
    nxt_s, dc = edges[gk], dc[valid]
    d = w[st_tid] * dh[valid] * gain / dc         # heap's density, same ops
    # prefix-min envelope per chain (doubling scan: log K passes)
    nv = d.shape[0]
    idx = torch.arange(nv, **i64)
    head = torch.ones(nv, dtype=torch.bool, device=dev)
    head[1:] = st_tid[1:] != st_tid[:-1]
    first_idx = torch.cummax(torch.where(head, idx, 0), 0).values
    e = d.clone()
    shift = 1
    inf = torch.full((nv,), float("inf"), dtype=torch.float64, device=dev)
    while shift < nv:
        can = idx - shift >= first_idx
        prev_e = torch.cat([inf[:shift], e[:-shift]])
        e = torch.where(can, torch.minimum(e, prev_e), e)
        shift *= 2
    order = torch.sort(-e, stable=True).indices
    cum = torch.cumsum(dc[order], 0)
    n_full = int(torch.searchsorted(
        cum, torch.tensor([budget], **i64), right=True)[0])
    granted = order[:n_full]
    sizes = sizes.clone()
    sizes.scatter_reduce_(0, st_tid[granted], nxt_s[granted], "amax",
                          include_self=True)
    rem = budget - (int(cum[n_full - 1]) if n_full else 0)
    if rem > 0 and n_full < nv:                   # partial-grant tail
        sizes[st_tid[order[n_full]]] += rem
    return sizes


def two_level_solve(hs, capacity: int, capacity2: int, t_fast: float,
                    t_fast2: float, t_slow: float, c_min: int = 0,
                    partition_fn=None, weights=None
                    ) -> tuple[PartitionResult, PartitionResult | None]:
    """Eq. 2 with per-level capacities and per-level service times.

    Stage 1 sizes L1 as the single-level problem (``capacity2 <= 0``
    reproduces it and returns ``(level1, None)``); stage 2 runs the same
    partitioner on the residual curves ``h_i.shifted(c1_i)`` against
    ``capacity2`` with gain ``t_slow - t_fast2`` and no per-tenant
    minimum.
    """
    fn = partition_fn if partition_fn is not None else pgd_solve
    kw = {} if weights is None else {"weights": weights}
    p1 = fn(hs, capacity, t_fast, t_slow, c_min=c_min, **kw)
    if capacity2 <= 0:
        return p1, None
    if isinstance(hs, BatchedHitRatioFunctions):
        shifted = hs.shifted(p1.sizes)       # vectorized residual curves
    else:
        shifted = [h.shifted(int(s)) for h, s in zip(hs, p1.sizes.tolist())]
    p2 = fn(shifted, capacity2, t_fast2, t_slow, c_min=0, **kw)
    return p1, p2


# XLA's CPU float32 sums run left to right up to this many elements
_SEQ_MAX = 32


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, left to right."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis as a pairwise tree: zero-padded to
    a power of two, then halved (element k added to element k + h)."""
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over tenants: XLA's order up to 32, the tree past it."""
    return _seq_sum(x) if x.shape[-1] <= _SEQ_MAX else _tree_sum(x)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over tenants.  Up to 32: left to right, each step a
    fused multiply-add (the product is exact in float64); past 32: the
    float32 squares summed by the tree."""
    if x.shape[-1] > _SEQ_MAX:
        return _tree_sum(x * x)
    x64 = x.to(torch.float64)
    s = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        s = (s.to(torch.float64) + x64[k] * x64[k]).to(torch.float32)
    return s


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of a float32 tensor.

    Neither torch's float32 nor its CPU float64 root is always correctly
    rounded, so the float64 root, rounded to float32, is corrected by one
    exact test: a float32 neighbour's midpoint has 25 significant bits,
    so its square is exact in float64 and compares exactly with ``x``
    (and never ties with it).  The result is the same on every device.
    """
    f = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    x64, f64 = x.to(torch.float64), f.to(torch.float64)
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    dn = torch.nextafter(f, torch.zeros_like(f))
    mid_up = (f64 + up.to(torch.float64)) * 0.5
    mid_dn = (f64 + dn.to(torch.float64)) * 0.5
    return torch.where(mid_up * mid_up < x64, up,
                       torch.where(mid_dn * mid_dn > x64, dn, f))


def _project_capacity_box(c: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, capacity: torch.Tensor,
                          iters: int = 50) -> torch.Tensor:
    """Project onto { lo <= c <= hi, sum(c) <= capacity } by bisection on
    the simplex Lagrange multiplier (both branches run; ``torch.where``
    picks, so no value is read back to the host)."""
    c0 = torch.clamp(c, lo, hi)
    tlo = torch.zeros((), dtype=torch.float32, device=c.device)
    thi = torch.max(c - lo) + 1.0
    for _ in range(iters):
        mid = 0.5 * (tlo + thi)
        over = _sum(torch.clamp(c - mid, lo, hi)) > capacity
        tlo, thi = torch.where(over, mid, tlo), torch.where(over, thi, mid)
    bis = torch.clamp(c - 0.5 * (tlo + thi), lo, hi)
    return torch.where(_sum(c0) > capacity, bis, c0)


def _interp_grad(c: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 ct: torch.Tensor) -> torch.Tensor:
    """d/dc of sum_i ct_i * interp(c_i, xs_i, ys_i): the active segment's
    slope, in ``jnp.interp``'s reverse-mode order ``(ct * df) / dx``."""
    pts = xs.shape[1]
    i = torch.clamp(torch.searchsorted(xs, c[:, None], right=True),
                    1, pts - 1)
    x0, x1 = xs.gather(1, i - 1)[:, 0], xs.gather(1, i)[:, 0]
    y0, y1 = ys.gather(1, i - 1)[:, 0], ys.gather(1, i)[:, 0]
    df = y1 - y0
    dx = x1 - x0
    dx0 = torch.abs(dx) <= _DX_EPS
    live = ~dx0 & ~(c < xs[:, 0]) & ~(c > xs[:, -1])
    g = (torch.where(live, ct, 0.0) * df) / torch.where(dx0, 1.0, dx)
    return g


def _pgd_core(xs: torch.Tensor, ys: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, cap: torch.Tensor, w: torch.Tensor,
              t_fast: torch.Tensor, t_slow: torch.Tensor, lr: torch.Tensor,
              steps: int) -> torch.Tensor:
    """The reference's jitted PGD loop, step for step in float32."""
    n = xs.shape[0]
    sqrt_n = _sqrt32(torch.tensor(float(n), dtype=torch.float32,
                                  device=xs.device)).to(torch.float64)
    ct = w * t_fast + -(w * t_slow)              # d objective / d h_i
    c = _project_capacity_box(hi * cap / (_sum(hi) + 1e-9), lo, hi, cap)
    for _ in range(steps):
        g = _interp_grad(c, xs, ys, ct)
        step = lr * g / (_sqrt32(_sum_squares(g)) + 1e-9)
        c = (c.to(torch.float64) - step.to(torch.float64) * sqrt_n) \
            .to(torch.float32)                   # fused multiply-add
        c = _project_capacity_box(c, lo, hi, cap)
    return c


def _interp_tables(b: BatchedHitRatioFunctions
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width relaxation tables ``(xs, ys)``, float32 [N, 128].

    Row i resamples curve i on ``np.linspace(0, max(e[-1], 1), 128)``
    with ``np.interp``'s float64 formula ``slope * (x - xp[j]) + fp[j]``,
    then rounds to float32.
    """
    dev = b.edges.device
    f64 = dict(dtype=torch.float64, device=dev)
    n = len(b)
    lens = torch.diff(b.offsets)
    stop = torch.clamp(b.max_useful_sizes.to(torch.float64), min=1.0)
    # the step divides by a tensor: CUDA multiplies by the reciprocal of
    # a Python divisor, which is not np.linspace's correctly rounded step
    grid = torch.arange(_TABLE_PTS, **f64)[None, :] \
        * (stop / torch.tensor(_TABLE_PTS - 1.0, **f64))[:, None]
    grid[:, -1] = stop
    # curves as padded rows (+inf past each curve's end)
    k = int(lens.max())
    row = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(b.edges.shape[0], device=dev) \
        - torch.repeat_interleave(b.offsets[:-1], lens)
    E = torch.full((n, k), float("inf"), **f64)
    Vh = torch.zeros((n, k), **f64)
    E[row, rank] = b.edges.to(torch.float64)
    Vh[row, rank] = b.heights
    last = (lens - 1)[:, None]
    j = torch.searchsorted(E, grid, right=True) - 1
    jc = torch.clamp(j, min=0)
    jn = torch.minimum(jc + 1, last)
    xj, yj = E.gather(1, jc), Vh.gather(1, jc)
    slope = (Vh.gather(1, jn) - yj) / (E.gather(1, jn) - xj)
    val = slope * (grid - xj) + yj
    y_last = Vh.gather(1, last)
    ys = torch.where(j < 0, Vh[:, :1],
                     torch.where(j >= last, y_last,
                                 torch.where(xj == grid, yj, val)))
    return grid.to(torch.float32), ys.to(torch.float32)


def pgd_solve(hs, capacity: int, t_fast: float, t_slow: float,
              c_min: int = 0, steps: int = 300, lr: float | None = None,
              weights=None) -> PartitionResult:
    """Projected-gradient solver on the piecewise-linear relaxation.

    The analog of the paper's MATLAB ``fmincon`` call: a first-order
    method on the smoothed MRC with the exact projection onto
    { sum c <= C } ∩ box.  The loop runs on the curves' device; the snap
    to breakpoints and the repair run on the host copy of the curves.
    """
    b = BatchedHitRatioFunctions.from_curves(hs)
    n = len(b)
    dev = b.edges.device
    host = b.to("cpu")
    w = (torch.ones(n, dtype=torch.float64) if weights is None
         else torch.as_tensor(weights, dtype=torch.float64))
    urd_sizes = host.max_useful_sizes
    if int(urd_sizes.sum()) <= capacity:
        sizes = urd_sizes.clone()
        return PartitionResult(
            sizes, True, aggregate_latency(host, sizes, t_fast, t_slow, w),
            host.evaluate(sizes))

    xs, ys = _interp_tables(b)
    f32 = dict(dtype=torch.float32, device=dev)
    urd_dev = b.max_useful_sizes
    lo = torch.minimum(torch.full((n,), float(c_min), dtype=torch.float64,
                                  device=dev),
                       urd_dev.to(torch.float64)).to(torch.float32)
    hi = urd_dev.to(torch.float32)
    if lr is None:
        lr = 0.05 * capacity / n
    c_star = _pgd_core(xs, ys, lo, hi, torch.tensor(float(capacity), **f32),
                       w.to(**f32), torch.tensor(t_fast, **f32),
                       torch.tensor(t_slow, **f32), torch.tensor(lr, **f32),
                       steps).cpu()

    # Snap each tenant down to its nearest breakpoint (never exceeds c*),
    # then spend any leftover with single marginal-density repair steps.
    curves = list(host)
    edges = [h.edges.tolist() for h in curves]
    sizes = [e[max(bisect.bisect_right(e, float(c)) - 1, 0)]
             for e, c in zip(edges, c_star.tolist())]
    leftover = capacity - sum(sizes)
    gain = t_slow - t_fast
    wl = w.tolist()
    while leftover > 0:
        best, best_i, best_nxt = 0.0, -1, 0
        for i, h in enumerate(curves):
            nxt, dh = h.marginal_gain(sizes[i])
            dc = nxt - sizes[i]
            if dh > 0 and 0 < dc <= leftover:
                d = wl[i] * dh * gain / dc
                if d > best:
                    best, best_i, best_nxt = d, i, nxt
        if best_i < 0:
            break
        leftover -= best_nxt - sizes[best_i]
        sizes[best_i] = best_nxt
    sizes_t = torch.tensor(sizes, dtype=torch.int64)
    return PartitionResult(
        sizes_t, False, aggregate_latency(host, sizes_t, t_fast, t_slow, w),
        host.evaluate(sizes_t), relaxed=c_star)
