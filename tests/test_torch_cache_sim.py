"""The port's plain stack-distance counts against the JAX reference.

``repro_torch.kernels.cache_sim`` has two plain versions of the CUDA
``cache_sim_scan``: the dense ``cache_sim_ref`` and the merge-tree route
(``count_prev_ge`` + ``coverage_counts``).  Both are held here, exactly,
against the reference's ``cache_sim_ref`` and its Pallas
``cache_sim_scan`` in interpret mode, on multi-tenant tapes made from a
numpy seed: hot rows equal, cold rows -1 (the port's contract; the TPU
kernel returns prefix counts there, which callers mask).  The CUDA kernel
itself is held against these on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batch_sim import _stack_distances_host
from repro.core.batch_sim import count_prev_ge as count_prev_ge_ref
from repro.kernels.cache_sim.kernel import cache_sim_scan as cache_sim_scan_tpu
from repro.kernels.cache_sim.ref import cache_sim_ref as cache_sim_ref_jax
from repro_torch.kernels.cache_sim.kernel import cache_sim_scan
from repro_torch.kernels.cache_sim.ops import stack_distances
from repro_torch.kernels.cache_sim.ref import (cache_sim_ref, count_prev_ge,
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
