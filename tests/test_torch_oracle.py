"""Helpers shared by the port's differential tests, and their own tests.

``reference_relaxed`` runs the reference's jitted PGD loop on the
reference's own relaxation tables and returns its float32 relaxed
optimum (``repro.core.partitioner.pgd_solve`` does not return it).
``pgd_size_ties`` names the tenants whose decided size may differ
between two PGD runs whose relaxed optima differ: past 32 tenants the
port sums in another float32 order than XLA, so the optima differ by a
fraction of one step, and a size can differ only where that moves the
snap to a breakpoint, or where the greedy repair of either run moved the
tenant off its snap.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import partitioner as ref_part
from repro.core.mrc import HitRatioFunction

# Past 32 tenants the port's relaxed PGD optimum stays within this
# fraction of one step length (lr * sqrt(n)) of the reference's: the
# largest gap over seeds 0-23 at 48 and 256 tenants (curves as in
# test_torch_core) was 0.28 of a step (20.0 blocks at 256 tenants).
PGD_STEP_TOL = 0.5


def reference_relaxed(curves, capacity: int, c_min: int,
                      t_fast: float = 1.0, t_slow: float = 20.0,
                      steps: int = 300) -> np.ndarray:
    """float32[N]: the reference's PGD loop on the reference's tables."""
    n = len(curves)
    xs = np.zeros((n, 128), np.float32)
    ys = np.zeros((n, 128), np.float32)
    for i, h in enumerate(curves):
        e = h.edges.astype(np.float64)
        grid = np.linspace(0.0, max(float(e[-1]), 1.0), 128)
        xs[i], ys[i] = grid, np.interp(grid, e, h.heights)
    urd = np.array([h.max_useful_size for h in curves], np.int64)
    lo = np.minimum(np.full(n, float(c_min)), urd.astype(np.float32))
    return np.asarray(ref_part._pgd_core(n, steps)(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(lo),
        jnp.asarray(urd.astype(np.float32)), jnp.float32(capacity),
        jnp.ones(n, jnp.float32), jnp.float32(t_fast), jnp.float32(t_slow),
        jnp.float32(0.05 * capacity / n)))


def pgd_size_ties(curves, relaxed_a, relaxed_b, sizes_a, sizes_b
                  ) -> tuple[set[int], set[int]]:
    """``(snap_differs, repaired)``: tenants whose snap to the largest
    breakpoint at or below the relaxed optimum differs between the two
    runs, and tenants whose decided size is not their snap in either
    run.  With ``snap_differs`` empty the repair sees identical inputs,
    so the sizes must be equal; otherwise only these tenants may
    differ."""
    snap_differs, repaired = set(), set()
    for i, h in enumerate(curves):
        e = np.asarray(h.edges).tolist()
        sa = e[max(bisect.bisect_right(e, float(relaxed_a[i])) - 1, 0)]
        sb = e[max(bisect.bisect_right(e, float(relaxed_b[i])) - 1, 0)]
        if sa != sb:
            snap_differs.add(i)
        if int(sizes_a[i]) != sa or int(sizes_b[i]) != sb:
            repaired.add(i)
    return snap_differs, repaired


def assert_pgd_sizes_match(curves, relaxed_a, relaxed_b, sizes_a, sizes_b,
                           step: float) -> None:
    """The relaxed optima agree to ``PGD_STEP_TOL`` steps, and the
    decided sizes are equal except where ``pgd_size_ties`` allows."""
    ra = np.asarray(relaxed_a, np.float64)
    rb = np.asarray(relaxed_b, np.float64)
    gap = float(np.abs(ra - rb).max())
    assert gap <= PGD_STEP_TOL * step, (gap, step)
    snap_differs, repaired = pgd_size_ties(curves, ra, rb, sizes_a, sizes_b)
    diff = set(np.flatnonzero(np.asarray(sizes_a) != np.asarray(sizes_b))
               .tolist())
    if not snap_differs:
        assert not diff, diff
    assert diff <= snap_differs | repaired, diff - snap_differs - repaired


def _curve(edges):
    e = np.asarray(edges, np.int64)
    return HitRatioFunction(e, np.linspace(0.0, 0.9, e.size), 100)


def test_pgd_size_ties_flags_a_breakpoint_between_the_optima():
    curves = [_curve([0, 10, 20]), _curve([0, 5, 30])]
    # tenant 0: 9.9 and 10.1 straddle breakpoint 10; tenant 1: both in
    # [5, 30), snapped to 5, and the second run's repair moved it to 30
    snap, moved = pgd_size_ties(curves, [9.9, 7.0], [10.1, 8.0],
                                [0, 5], [10, 30])
    assert snap == {0} and moved == {1}
    assert_pgd_sizes_match(curves, [9.9, 7.0], [10.1, 8.0], [0, 5], [10, 30],
                           step=10.0)


def test_assert_pgd_sizes_match_rejects_unexplained_differences():
    curves = [_curve([0, 10, 20]), _curve([0, 5, 30])]
    with pytest.raises(AssertionError):      # equal snaps, sizes differ
        assert_pgd_sizes_match(curves, [12.0, 7.0], [12.5, 7.0], [10, 5],
                               [20, 5], step=10.0)
    with pytest.raises(AssertionError):      # optima farther than the tol
        assert_pgd_sizes_match(curves, [12.0, 7.0], [19.0, 7.0], [10, 5],
                               [10, 5], step=10.0)
