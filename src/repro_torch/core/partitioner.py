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
The greedy breakpoint partitioner (``greedy_allocate``) and the ETICA
second level are not ported yet.
"""
from __future__ import annotations

import bisect
import dataclasses

import torch

from repro_torch.core.mrc import BatchedHitRatioFunctions

__all__ = ["PartitionResult", "aggregate_latency", "pgd_solve",
           "two_level_solve"]

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


def two_level_solve(hs, capacity: int, capacity2: int, t_fast: float,
                    t_fast2: float, t_slow: float, c_min: int = 0,
                    partition_fn=None, weights=None
                    ) -> tuple[PartitionResult, PartitionResult | None]:
    """Eq. 2 with per-level capacities; single level only in the port.

    Returns ``(level1, None)``: the second level (``capacity2 > 0``, the
    residual-curve ETICA stage) is not ported yet.
    """
    if capacity2 > 0:
        raise NotImplementedError(
            "two-level partitioning is not ported yet (ROADMAP: modules "
            "queue, two-level)")
    fn = partition_fn if partition_fn is not None else pgd_solve
    kw = {} if weights is None else {"weights": weights}
    return fn(hs, capacity, t_fast, t_slow, c_min=c_min, **kw), None


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
    grid = torch.arange(_TABLE_PTS, **f64)[None, :] \
        * (stop / (_TABLE_PTS - 1))[:, None]
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
