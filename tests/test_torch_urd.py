"""The port's per-tenant Analyzer (``urd_scan`` and the RD engines)
against the JAX reference.

* ``kernels.urd_scan.ref.urd_scan_ref`` (the dense plain version of the
  CUDA ``urd_scan``) against the reference's ``urd_scan_ref`` on severed
  multi-tenant links made from a numpy seed: hot rows equal, cold rows
  -1 (the port's contract; the TPU kernel returns prefix counts there,
  which its callers mask).  The reference's Pallas ``urd_scan`` in
  interpret mode is the ``slow`` case.
* The four exact engines (``reuse_distances`` Fenwick oracle,
  ``reuse_distances_vectorized``, ``batch_sim.reuse_distances_fast`` and
  ``reuse_distances_accel``) against the reference's, for both kinds, on
  the Table-3 profiles, exactly; the empty trace; SHARDS-sampled
  distances against both of the reference's engines and the Fenwick
  oracle on the kept sub-trace; ``RDResult.histogram``.

The CUDA kernel itself is held against ``urd_scan_ref`` on the card
(``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.reuse_distance as rd_ref
from repro.core.batch_sim import reuse_distances_fast as fast_ref
from repro.core.trace import Trace as TraceRef
from repro.data.traces import msr_trace as msr_trace_ref
from repro.kernels.urd_scan.kernel import urd_scan as urd_scan_tpu
from repro.kernels.urd_scan.ops import \
    reuse_distances_accel as reuse_distances_accel_ref
from repro.kernels.urd_scan.ref import urd_scan_ref as urd_scan_ref_jax
from repro_torch.core import (Trace, reuse_distances, reuse_distances_fast,
                              reuse_distances_vectorized,
                              sampled_reuse_distances, shards_keep_mask,
                              shards_salt)
from repro_torch.data.traces import msr_trace
from repro_torch.kernels.urd_scan.kernel import urd_scan
from repro_torch.kernels.urd_scan.ops import reuse_distances_accel, urd_counts
from repro_torch.kernels.urd_scan.ref import urd_scan_ref

TABLE3 = ("prxy_0", "prn_1", "hm_1", "web_1")


def _links(n, seed, blocks=4):
    """Severed multi-tenant links (numpy, independent of the port)."""
    rng = np.random.default_rng(seed)
    cuts = (np.sort(rng.choice(np.arange(1, n), size=min(blocks - 1, n - 1),
                               replace=False)) if n > 1 else np.zeros(0))
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    prev = np.full(n, -1, np.int64)
    nxt = np.zeros(n, np.int64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        addrs = rng.integers(0, max(3, (e - s) // 4), e - s)
        last = {}
        nxt[s:e] = e
        for k, a in enumerate(addrs.tolist()):
            if a in last:
                prev[s + k] = last[a]
                nxt[last[a]] = s + k
            last[a] = s + k
    return prev, nxt


def _t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


@pytest.mark.parametrize("n", [1, 2, 255, 1000])
def test_urd_scan_ref_matches_reference(n):
    prev, nxt = _links(n, seed=n)
    want = np.asarray(urd_scan_ref_jax(jnp.asarray(prev, jnp.int32),
                                       jnp.asarray(nxt, jnp.int32)))
    got = urd_scan_ref(_t32(prev), _t32(nxt)).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])
    assert (got[~hot] == -1).all()
    # the wrapper on a CPU tensor (the merge tree), and the dispatch
    # through it, give the same integers
    np.testing.assert_array_equal(urd_scan(_t32(prev), _t32(nxt)).numpy(),
                                  got)
    np.testing.assert_array_equal(
        urd_counts(torch.as_tensor(prev), torch.as_tensor(nxt)).numpy(),
        got.astype(np.int64))


def test_urd_scan_checks_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        urd_scan(z, z[:3])
    with pytest.raises(ValueError):
        urd_scan(z.reshape(2, 2), z.reshape(2, 2))
    assert urd_scan(z[:0], z[:0]).numel() == 0


@pytest.mark.slow
def test_urd_scan_ref_matches_pallas_interpret():
    prev, nxt = _links(600, seed=11)
    want = np.asarray(urd_scan_tpu(jnp.asarray(prev, jnp.int32),
                                   jnp.asarray(nxt, jnp.int32),
                                   interpret=True))
    got = urd_scan_ref(_t32(prev), _t32(nxt)).numpy()
    hot = prev >= 0
    np.testing.assert_array_equal(got[hot], want[hot])


def _pair(name, n, seed):
    ref = msr_trace_ref(name, n, seed=seed)
    return ref, Trace(torch.as_tensor(ref.addrs), torch.as_tensor(ref.is_read),
                      name)


@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("name", TABLE3)
def test_rd_engines_match_reference(name, kind):
    ref, tr = _pair(name, 2000, seed=3)
    assert torch.equal(tr.addrs, msr_trace(name, 2000, seed=3).addrs)
    want = rd_ref.reuse_distances(ref, kind).distances
    np.testing.assert_array_equal(
        rd_ref.reuse_distances_vectorized(ref, kind).distances, want)
    np.testing.assert_array_equal(fast_ref(ref, kind).distances, want)
    np.testing.assert_array_equal(
        reuse_distances_accel_ref(ref, kind, use_kernel=False).distances,
        want)
    for engine in (reuse_distances, reuse_distances_vectorized,
                   reuse_distances_fast):
        res = engine(tr, kind)
        assert res.kind == kind
        np.testing.assert_array_equal(res.distances.numpy(), want)
    acc = reuse_distances_accel(tr, kind, device="cpu")
    np.testing.assert_array_equal(acc.distances.numpy(), want)
    np.testing.assert_array_equal(acc.histogram().numpy(),
                                  rd_ref.RDResult(want, kind).histogram())
    np.testing.assert_array_equal(acc.histogram(16).numpy(),
                                  rd_ref.RDResult(want, kind).histogram(16))


@pytest.mark.parametrize("engine", [reuse_distances, reuse_distances_vectorized,
                                    reuse_distances_fast])
def test_rd_engines_on_the_empty_trace(engine):
    empty = Trace(torch.zeros(0, dtype=torch.int64),
                  torch.zeros(0, dtype=torch.bool))
    res = engine(empty, "urd")
    assert res.distances.numel() == 0
    assert res.histogram().tolist() == [0]
    assert reuse_distances_accel(empty, "trd",
                                 device="cpu").distances.numel() == 0
    with pytest.raises(ValueError):
        engine(empty, "xrd")


@pytest.mark.parametrize("kind", ["urd", "trd"])
def test_sampled_engines_match_reference(kind):
    ref, tr = _pair("web_1", 3000, seed=5)
    got = sampled_reuse_distances(tr, kind, rate=0.25, seed=4)
    for engine in ("fast", "fenwick"):
        want = rd_ref.sampled_reuse_distances(ref, kind, rate=0.25, seed=4,
                                              engine=engine)
        np.testing.assert_array_equal(got.distances.numpy(), want.distances)
        assert got.rate == want.rate
        assert got.expected_error == want.expected_error
    # the SHARDS filter composed with the Fenwick oracle on the kept
    # sub-trace gives the same scaled samples
    keep = shards_keep_mask(tr.addrs, 0.25, shards_salt(4))
    sd = reuse_distances(Trace(tr.addrs[keep], tr.is_read[keep]),
                         kind).distances
    scaled = torch.full((len(tr),), -1, dtype=torch.int64)
    scaled[keep] = torch.where(
        sd >= 0, torch.round(sd.to(torch.float64) / 0.25).to(torch.int64),
        -1)
    assert torch.equal(got.distances, scaled)
    with pytest.raises(ValueError):
        sampled_reuse_distances(tr, kind, rate=0.0)


def test_accel_needs_a_device_it_can_use():
    _, tr = _pair("hm_1", 100, seed=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            reuse_distances_accel(tr)
    with pytest.raises(ValueError):
        reuse_distances_accel(tr, "xrd", device="cpu")
