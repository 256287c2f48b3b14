"""The port's plain stack-distance counts against the JAX reference.

``repro_torch.kernels.cache_sim`` has two plain versions of the CUDA
``cache_sim_scan``: the dense ``cache_sim_ref`` and the merge-tree route
(``count_prev_ge`` + ``coverage_counts``).  Both are held here, exactly,
against the reference's ``cache_sim_ref`` and its Pallas
``cache_sim_scan`` in interpret mode, on multi-tenant tapes made from a
numpy seed: hot rows equal, cold rows -1 (the port's contract; the TPU
kernel returns prefix counts there, which callers mask).  The CUDA
kernel's own decomposition, ``cache_sim_tiled_ref`` (direct compares over
each interval's head and tail, a search in each sorted whole tile), is
held to the reference exactly too: tapes with n not a multiple of the
tile and n below it, intervals that start or end on a tile edge, occ
masks.  The CUDA kernel itself is held against these on the card
(``tests/test_torch_gpu.py``).  So is ``cache_sim_segments_scan``'s
decomposition, ``cache_sim_segments_tiled_ref`` (prev raised to the block
start; block-local tiles; heads direct, whole tiles counted, tails by
coverage), against the reference's dense ``cache_sim_segments_ref`` and
its Pallas ``cache_sim_segments_scan`` in interpret mode, on width groups
with pad rows and links that cross a block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batch_sim import _stack_distances_host
from repro.core.batch_sim import count_prev_ge as count_prev_ge_ref
from repro.kernels.cache_sim.kernel import cache_sim_scan as cache_sim_scan_tpu
from repro.kernels.cache_sim.kernel import \
    cache_sim_segments_scan as segments_scan_tpu
from repro.kernels.cache_sim.ref import cache_sim_ref as cache_sim_ref_jax
from repro.kernels.cache_sim.ref import \
    cache_sim_segments_ref as segments_ref_jax
from repro_torch.kernels.cache_sim.kernel import cache_sim_scan
from repro_torch.kernels.cache_sim.ops import stack_distances
from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
                                               cache_sim_segments_tiled_ref,
                                               cache_sim_tiled_ref,
                                               count_prev_ge,
                                               coverage_counts,
                                               stack_distances_tree)


def _tape(n, seed, blocks=4):
    """Severed multi-tenant links (numpy, independent of the port):
    returns prev, nxt (clamped to the block end), bounds, is_read."""
    rng = np.random.default_rng(seed)
    cuts = (np.sort(rng.choice(np.arange(1, n), size=min(blocks - 1, n - 1),
                               replace=False)) if n > 1 else np.zeros(0))
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    prev = np.full(n, -1, np.int64)
    nxt = np.zeros(n, np.int64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        addrs = rng.integers(0, max(3, (e - s) // 4), e - s)
        last = {}
        for k, a in enumerate(addrs.tolist()):
            if a in last:
                prev[s + k] = s + last[a]
            last[a] = k
        nxt[s:e] = e                           # no later touch: block end
        hot = np.flatnonzero(prev[s:e] >= 0) + s
        nxt[prev[hot]] = hot
    return prev, nxt, bounds, rng.random(n) < 0.6


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("n", [1, 2, 17, 255, 256, 257, 600])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_cache_sim_ref_matches_reference(n, occ_kind):
    prev, nxt, _, reads = _tape(n, seed=n)
    occ = np.ones(n, np.int32) if occ_kind == "ones" else reads.astype(np.int32)
    want = np.asarray(cache_sim_ref_jax(jnp.asarray(prev, jnp.int32),
                                        jnp.asarray(nxt, jnp.int32),
                                        jnp.asarray(occ)))
    got = cache_sim_ref(_t(prev).int(), _t(nxt).int(), _t(occ)).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])
    assert (got[~hot] == -1).all()


@pytest.mark.parametrize("n", [255, 256, 257, 600])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_plain_versions_match_tpu_kernel_interpret(n, occ_kind):
    """Several tile edges of the TPU kernel's 256-wide grid."""
    prev, nxt, _, reads = _tape(n, seed=1000 + n)
    occ = np.ones(n, np.int32) if occ_kind == "ones" else reads.astype(np.int32)
    want = np.asarray(cache_sim_scan_tpu(jnp.asarray(prev, jnp.int32),
                                         jnp.asarray(nxt, jnp.int32),
                                         jnp.asarray(occ), interpret=True))
    hot = prev >= 0
    got = cache_sim_ref(_t(prev).int(), _t(nxt).int(), _t(occ)).numpy()
    np.testing.assert_array_equal(got[hot], want[hot])
    if occ_kind == "ones":
        tree = stack_distances_tree(_t(prev), _t(nxt)).numpy()
        np.testing.assert_array_equal(tree[hot], want[hot])
        assert (tree[~hot] == -1).all()


@pytest.mark.parametrize("n,blocks", [(1, 1), (40, 1), (513, 3),
                                      (5000, 8), (20000, 16)])
def test_merge_tree_matches_reference_host(n, blocks):
    prev, nxt, bounds, _ = _tape(n, seed=7 * n + blocks, blocks=blocks)
    want = _stack_distances_host(prev, nxt, bounds=bounds)
    got = stack_distances_tree(_t(prev), _t(nxt)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 1000, 40000])
def test_count_prev_ge_matches_reference(m):
    """Includes a tape past the reference's sort-merge switch (2**15)."""
    y = np.random.default_rng(m).integers(0, max(m // 3, 2), m)
    np.testing.assert_array_equal(count_prev_ge(_t(y)).numpy(),
                                  count_prev_ge_ref(y))


def test_coverage_counts_definition():
    prev, nxt, _, _ = _tape(300, seed=5)
    F = coverage_counts(_t(nxt)).numpy()
    want = [int((nxt[:i] >= i).sum())
            for i in range(301)]
    np.testing.assert_array_equal(F, want)


def test_cpu_wrapper_takes_plain_version_and_checks_inputs():
    prev, nxt, _, reads = _tape(300, seed=9)
    p, q = _t(prev).int(), _t(nxt).int()
    occ = _t(reads.astype(np.int32))
    before = cache_sim_scan.launches
    assert torch.equal(cache_sim_scan(p, q, occ), cache_sim_ref(p, q, occ))
    assert cache_sim_scan.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError):
        cache_sim_scan(p, q[:-1], occ)


def test_ops_stack_distances_cpu_route():
    """A CPU tape takes the merge tree: int64, -1 at cold rows, equal to
    the dense definition with every access occupying."""
    prev, nxt, _, _ = _tape(700, seed=11)
    p, q = _t(prev), _t(nxt)
    sd = stack_distances(p, q)
    assert sd.dtype == torch.int64
    want = cache_sim_ref(p.int(), q.int(), torch.ones(700, dtype=torch.int32))
    assert torch.equal(sd, want.long())


def _reference_counts(prev, nxt, occ):
    return np.asarray(cache_sim_ref_jax(jnp.asarray(prev, jnp.int32),
                                        jnp.asarray(nxt, jnp.int32),
                                        jnp.asarray(occ, jnp.int32)))


@pytest.mark.parametrize("tile", [1, 8, 64, 256])
@pytest.mark.parametrize("n", [1, 17, 256, 257, 1000])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_tiled_ref_matches_reference(n, tile, occ_kind):
    """n below the tile, equal to it, one past it and ragged; tiles of 1
    (no head or tail) up to the kernel's 256."""
    prev, nxt, _, reads = _tape(n, seed=3 * n + tile)
    occ = np.ones(n, np.int32) if occ_kind == "ones" else reads.astype(np.int32)
    want = _reference_counts(prev, nxt, occ)
    got = cache_sim_tiled_ref(_t(prev).int(), _t(nxt).int(), _t(occ),
                              tile).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])
    assert (got[~hot] == -1).all()


@pytest.mark.parametrize("period", [-1, 0, 1, 16])
@pytest.mark.parametrize("tile", [4, 16])
def test_tiled_ref_on_tile_edges(tile, period):
    """Addresses cycling with period ``tile + period`` (and ``2 * tile``)
    put interval starts ``prev + 1`` and ends ``i`` on tile edges, and
    intervals of exactly one or two whole tiles; a random occ mask."""
    n = 40 * tile + 3
    rng = np.random.default_rng(tile + period)
    addrs = np.arange(n) % (tile + period if period != 16 else 2 * tile)
    prev = np.full(n, -1, np.int64)
    nxt = np.full(n, n, np.int64)
    last = {}
    for k, a in enumerate(addrs.tolist()):
        if a in last:
            prev[k] = last[a]
            nxt[last[a]] = k
        last[a] = k
    hot = prev >= 0
    starts, ends = (prev[hot] + 1) % tile == 0, np.flatnonzero(hot) % tile == 0
    assert starts.any() and ends.any()
    occ = (rng.random(n) < 0.7).astype(np.int32)
    want = _reference_counts(prev, nxt, occ)
    got = cache_sim_tiled_ref(_t(prev).int(), _t(nxt).int(), _t(occ),
                              tile).numpy()
    np.testing.assert_array_equal(got[hot], want[hot])
    assert (got[~hot] == -1).all()


def test_tiled_ref_matches_merge_tree_long_intervals():
    """A 20,000-access tape of four tenants over few addresses: intervals
    spanning many 256-position tiles, every access occupying."""
    prev, nxt, _, _ = _tape(20000, seed=21)
    got = cache_sim_tiled_ref(_t(prev).int(), _t(nxt).int(),
                              torch.ones(20000, dtype=torch.int32), 256)
    hot = prev >= 0
    span = np.flatnonzero(hot) - prev[hot]
    assert span.max() > 8 * 256
    assert torch.equal(got.long(), stack_distances_tree(_t(prev), _t(nxt)))


def _width_group(w, lens, seed, cross=0):
    """One width group of a padded tape (numpy, independent of the port):
    a segment of each length in ``lens`` (each <= w) at the start of its
    own w-block, links severed per segment with ``nxt`` clamped to the
    segment end, pad rows cold, non-occupying and linked to themselves;
    then ``cross`` hot rows past the first block get a ``prev`` in an
    earlier block.  Returns prev, nxt, occ (1 on real rows) and a read
    mask."""
    rng = np.random.default_rng(seed)
    m = w * len(lens)
    prev = np.full(m, -1, np.int64)
    nxt = np.arange(m, dtype=np.int64)
    occ = np.zeros(m, np.int32)
    for b, ln in enumerate(lens):
        s, e = b * w, b * w + ln
        last = {}
        for k, a in enumerate(rng.integers(0, max(3, ln // 4), ln).tolist()):
            if a in last:
                prev[s + k] = s + last[a]
            last[a] = k
        nxt[s:e] = e
        hot = np.flatnonzero(prev[s:e] >= 0) + s
        nxt[prev[hot]] = hot
        occ[s:e] = 1
    reads = occ * (rng.random(m) < 0.6)
    hot = np.flatnonzero((prev >= 0) & (np.arange(m) >= w))
    pick = rng.choice(hot, size=min(cross, hot.size), replace=False)
    prev[pick] = np.maximum(pick - w - rng.integers(0, w, pick.size), 0)
    return prev, nxt, occ, reads.astype(np.int32)


def _segments_reference(prev, nxt, occ, w):
    return np.asarray(segments_ref_jax(jnp.asarray(prev, jnp.int32),
                                       jnp.asarray(nxt, jnp.int32),
                                       jnp.asarray(occ, jnp.int32), w))


SEG_GROUPS = [(64, [64, 1, 37, 0, 64]), (128, [128, 100, 65]),
              (256, [256, 129, 200]), (512, [512, 300, 257, 0]),
              (4096, [4096, 2049]), (16384, [9000])]


@pytest.mark.parametrize("w,lens", SEG_GROUPS)
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_segments_tiled_ref_matches_reference(w, lens, occ_kind):
    """Hot rows equal the reference's dense oracle, pad and cold rows are
    -1, at every width the sampled tapes use up to the widest block held
    in shared memory; where there are two blocks or more, some hot rows
    link to an earlier one (one block at w = 16384 keeps the dense
    oracle's plane at 2^28 pairs)."""
    prev, nxt, occ, reads = _width_group(w, lens, seed=w, cross=w // 8 + 1)
    if occ_kind == "reads":
        occ = reads
    crossing = (prev >= 0) & (prev < np.arange(prev.size) // w * w)
    assert crossing.any() or len(lens) == 1
    want = _segments_reference(prev, nxt, occ, w)
    got = cache_sim_segments_tiled_ref(_t(prev).int(), _t(nxt).int(),
                                       _t(occ), w)
    assert got.dtype == torch.int32
    hot = prev >= 0
    np.testing.assert_array_equal(got.numpy()[hot], want[hot])
    assert (got.numpy()[~hot] == -1).all()


@pytest.mark.parametrize("w", [16, 64, 100])
@pytest.mark.parametrize("tile", [4, 16])
def test_segments_tiled_ref_small_tiles(w, tile):
    """Tiles of 4 and 16 put many whole tiles, heads and tails in each
    block (a ragged last tile where the tile does not divide w = 100),
    and prev at or past the row (an empty interval) on some rows."""
    m = 6 * w
    rng = np.random.default_rng(w + tile)
    pos = np.arange(m)
    prev = pos - rng.integers(1, w + w // 2 + 2, m)
    prev[(rng.random(m) < 0.2) | (prev < 0)] = -1
    late = rng.random(m) < 0.05
    prev[late] = pos[late] + rng.integers(0, 3, late.sum())
    nxt = pos + rng.integers(1, w + 1, m)
    end = rng.random(m) < 0.3
    nxt[end] = (pos[end] // w + 1) * w
    occ = (rng.random(m) < 0.7).astype(np.int32)
    want = _segments_reference(prev, nxt, occ, w)
    got = cache_sim_segments_tiled_ref(_t(prev).int(), _t(nxt).int(),
                                       _t(occ), w, tile).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])
    assert (got[~hot] == -1).all()


@pytest.mark.parametrize("w,lens", [(64, [64, 30]), (256, [256, 129])])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_segments_tiled_ref_matches_tpu_kernel_interpret(w, lens, occ_kind):
    prev, nxt, occ, reads = _width_group(w, lens, seed=3 * w, cross=4)
    if occ_kind == "reads":
        occ = reads
    want = np.asarray(segments_scan_tpu(
        *[jnp.asarray(a, jnp.int32) for a in (prev, nxt, occ)],
        seg_width=w, interpret=True))
    got = cache_sim_segments_tiled_ref(_t(prev).int(), _t(nxt).int(),
                                       _t(occ), w).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])
