"""The port's SHARDS-sampled monitoring against the JAX reference.

Each piece of the sampled path is fed the same numpy-seeded inputs as its
reference counterpart, and held to it exactly unless stated: the salt,
the spatial filter and the rate tuner, sampled reuse distances, the
padded self-aligned layout and its links, the segment-restricted counts
(the port's dense ``cache_sim_segments_ref`` and merge-sort tree against
the reference's ``cache_sim_segments_ref``, ``cache_sim_segments_tree``
and its Pallas ``cache_sim_segments_scan`` in interpret mode), the
per-width dispatch, the sampled ``analyze_windows``, and a 256-tenant
manager, which samples by itself, over two windows.  The CUDA
``cache_sim_segments_scan`` is held against the plain versions on the
card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_manager as make_manager_ref
from repro.core import monitor as ref_monitor
from repro.core import reuse_distance as ref_rd
from repro.core.batch_sim import padded_segment_layout as layout_ref
from repro.core.batch_sim import padded_tape_links as links_ref
from repro.data.traces import msr_trace as msr_trace_ref
from repro.kernels.cache_sim import ops as ref_ops
from repro.kernels.cache_sim.kernel import \
    cache_sim_segments_scan as segments_scan_tpu
from repro.kernels.cache_sim.ref import \
    cache_sim_segments_ref as segments_ref_jax
from repro.kernels.cache_sim.ref import \
    cache_sim_segments_tree as segments_tree_jax
from repro_torch.core import make_manager, monitor
from repro_torch.core import reuse_distance as pt_rd
from repro_torch.core.batch_sim import (padded_segment_layout,
                                        padded_tape_links)
from repro_torch.data.traces import MSR_PROFILES, msr_trace
from repro_torch.kernels.cache_sim import ops
from repro_torch.kernels.cache_sim.kernel import cache_sim_segments_scan
from repro_torch.kernels.cache_sim.ref import (cache_sim_segments_ref,
                                               cache_sim_segments_tree)
from test_torch_oracle import assert_pgd_sizes_match, reference_relaxed

NAMES = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------- salt, filter, rate
def test_shards_salt_matches_reference():
    rng = np.random.default_rng(0)
    pairs = [(s, t) for s in range(40) for t in range(12)]
    pairs += [(int(s), int(t)) for s, t in rng.integers(0, 2**40, (200, 2))]
    for s, t in pairs:
        assert pt_rd.shards_salt(s, t) == ref_rd.shards_salt(s, t)


@pytest.mark.parametrize("rate", [1e-3, 0.1, 0.5, 1 - 2**-33, 1.0])
def test_shards_keep_mask_matches_reference(rate):
    rng = np.random.default_rng(1)
    addrs = np.concatenate([rng.integers(0, 2**40, 20000),
                            [0, 2**32 - 1, 2**32, 2**40 - 1]])
    for salt in (1, 7919, pt_rd.shards_salt(3, 5), 2**31 - 3):
        want = ref_rd.shards_keep_mask(addrs, rate, salt)
        got = pt_rd.shards_keep_mask(_t(addrs), rate, salt)
        np.testing.assert_array_equal(got.numpy(), want)


def test_auto_sample_rate_matches_reference():
    for n in (0, 1, 100, 255, 256, 4095, 4096, 4097, 65536, 10**7):
        for target, floor in ((4096, 256), (64, 16), (10, 300), (0, 0)):
            assert pt_rd.auto_sample_rate(n, target, floor) == \
                ref_rd.auto_sample_rate(n, target, floor)


@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("rate", [0.3, "auto", 1.0, 2e-4])
def test_sampled_reuse_distances_matches_reference(kind, rate):
    """Includes a window that keeps nothing (rate 2e-4 of 1,500
    accesses) and an empty trace."""
    for n, seed in ((1500, 2), (0, 3)):
        ta, tb = msr_trace_ref("hm_1", n, seed=seed), msr_trace("hm_1", n,
                                                               seed=seed)
        kw = dict(kind=kind, rate=rate, seed=4, target_samples=500,
                  min_samples=100)
        want = ref_rd.sampled_reuse_distances(ta, **kw)
        got = pt_rd.sampled_reuse_distances(tb, **kw)
        np.testing.assert_array_equal(got.distances.numpy(), want.distances)
        assert (got.rate, got.expected_error) == \
            (want.rate, want.expected_error)
    if rate == 2e-4:
        assert not (want.distances >= 0).any()


# --------------------------------------------------- padded tape layout
LAYOUT_BOUNDS = [
    [0, 5, 5, 200, 264, 264, 300],     # empty segments, ragged widths
    [0, 300, 364, 400],                # descending widths: tape order kept
    [0, 64, 128, 1000],                # ascending: the layout reorders
    [0, 0, 0],                         # nothing to lay out
    [7, 20],                           # a tape that starts at 7
]


@pytest.mark.parametrize("bounds", LAYOUT_BOUNDS)
def test_padded_layout_and_links_match_reference(bounds):
    b = np.asarray(bounds, np.int64)
    want = layout_ref(b)
    got = padded_segment_layout(_t(b))
    assert (got[0] is None) == (want[0] is None)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), w)
    if want[5] == 0:
        return
    prev, nxt = _severed_links(b, seed=len(bounds))
    for g, w in zip(padded_tape_links(_t(prev), _t(nxt), got),
                    links_ref(prev, nxt, want)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert ops.width_groups_of(got[4]) == ref_ops.width_groups_of(want[4])


def _severed_links(bounds, seed, reads=False):
    """Links on a multi-segment tape (numpy, independent of the port):
    severed at segment boundaries, ``nxt`` clamped to the segment end."""
    rng = np.random.default_rng(seed)
    m = int(bounds[-1])
    prev = np.full(m, -1, np.int64)
    nxt = np.zeros(m, np.int64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        addrs = rng.integers(0, max(3, (e - s) // 4), e - s)
        last = {}
        for k, a in enumerate(addrs.tolist()):
            if a in last:
                prev[s + k] = s + last[a]
            last[a] = k
        nxt[s:e] = e
        hot = np.flatnonzero(prev[s:e] >= 0) + s
        nxt[prev[hot]] = hot
    return (prev, nxt, rng.random(m) < 0.6) if reads else (prev, nxt)


def _padded_group(w, lens, seed):
    """Chunk-local int32 links of one width group: one segment of each
    length in ``lens`` (each <= w) padded to ``w``, with an occupancy
    mask of reads."""
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    prev, nxt, reads = _severed_links(bounds, seed, reads=True)
    lay = layout_ref(bounds)
    gprev, gnxt, gocc = links_ref(prev, nxt, lay)
    assert int(lay[4][0]) == w and len(set(lay[4].tolist())) == 1
    src, tpos = lay[0], lay[1]
    src = np.arange(prev.size) if src is None else src
    rocc = np.zeros_like(gocc)
    rocc[tpos] = reads[src]
    return (gprev.astype(np.int32), gnxt.astype(np.int32),
            gocc.astype(np.int32), rocc.astype(np.int32))


SEG_CASES = [(64, [64, 1, 37, 64]),            # a segment of exactly 64
             (128, [128, 100, 65, 127]),
             (256, [256, 129, 200, 256])]


@pytest.mark.parametrize("w,lens", SEG_CASES)
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_segments_ref_and_tree_match_reference(w, lens, occ_kind):
    """Hot rows equal the reference's dense oracle, its merge-sort tree
    and its Pallas kernel in interpret mode; cold and pad rows are -1
    (the TPU kernel returns prefix counts there, which callers mask)."""
    prev, nxt, occ1, rocc = _padded_group(w, lens, seed=w)
    occ = occ1 if occ_kind == "ones" else rocc
    j = [jnp.asarray(a) for a in (prev, nxt, occ)]
    hot = prev >= 0
    want = np.asarray(segments_ref_jax(*j, w))
    for other in (np.asarray(segments_tree_jax(*j, w)),
                  np.asarray(segments_scan_tpu(*j, seg_width=w,
                                               interpret=True))):
        np.testing.assert_array_equal(other[hot], want[hot])
    for got in (cache_sim_segments_ref(_t(prev), _t(nxt), _t(occ), w),
                cache_sim_segments_tree(_t(prev), _t(nxt), _t(occ), w),
                cache_sim_segments_scan(_t(prev), _t(nxt), _t(occ), w)):
        got = got.numpy()
        np.testing.assert_array_equal(got[hot], want[hot])
        assert (got[~hot] == -1).all()


@pytest.mark.parametrize("w", [1024, 4096])
def test_segments_tree_matches_reference_tree_wide(w):
    prev, nxt, occ, rocc = _padded_group(w, [w, w - 1, w // 2 + 1], seed=w)
    for o in (occ, rocc):
        want = np.asarray(segments_tree_jax(jnp.asarray(prev),
                                            jnp.asarray(nxt),
                                            jnp.asarray(o), w))
        got = cache_sim_segments_tree(_t(prev), _t(nxt), _t(o), w).numpy()
        np.testing.assert_array_equal(got[prev >= 0], want[prev >= 0])


def test_segments_scan_checks_inputs():
    z = torch.zeros(96, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        cache_sim_segments_scan(z, z, z, 64)
    with pytest.raises(ValueError, match="one length"):
        cache_sim_segments_scan(z, z[:64], z, 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_stack_distances_segments_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 700, 7)
    lens[2] = 0                                  # an empty tenant
    lens[4] = 64                                 # exactly _PAD_MIN
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    prev, nxt = _severed_links(bounds, seed)
    want = ref_ops.stack_distances_segments_accel(prev, nxt, bounds=bounds,
                                                  use_kernel=False)
    got = ops.stack_distances_segments(_t(prev), _t(nxt), _t(bounds))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ sampled monitor
def _assert_monitor_equal(got, want):
    for f in ("urd_sizes", "write_ratios", "sample_rates",
              "expected_errors"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    for f in ("edges", "heights", "offsets", "n_accesses"):
        np.testing.assert_array_equal(getattr(got.curves, f).numpy(),
                                      getattr(want.curves, f), err_msg=f)


@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("rate", [0.25, "auto", 0.01])
def test_sampled_analyze_windows_matches_reference(kind, rate):
    """Curve edges and heights bit for bit, URD sizes, write ratios,
    rates and error bars; an empty window, short windows measured
    exactly under ``"auto"``, and tenants that keep nothing at 0.01."""
    lens = [900, 700, 0, 120, 900, 1300]
    ta = [msr_trace_ref(nm, ln, seed=i)
          for i, (nm, ln) in enumerate(zip(NAMES, lens))]
    tb = [msr_trace(nm, ln, seed=i)
          for i, (nm, ln) in enumerate(zip(NAMES, lens))]
    kw = dict(kind=kind, sample_rate=rate, window_seed=3, sample_target=200,
              sample_floor=150, tenant_ids=[4, 9, 1, 0, 7, 2])
    want = ref_monitor.analyze_windows(ta, backend="host", **kw)
    got = monitor.analyze_windows(tb, device="cpu", **kw)
    _assert_monitor_equal(got, want)
    assert (want.sample_rates < 1).any()
    if rate == "auto":
        assert (want.sample_rates == 1).any()


# ------------------------------------------------- 256-tenant manager
def test_manager_256_tenants_samples_like_reference():
    """256 tenants (the 16 MSR profiles x 16) switch both managers to
    SHARDS by themselves.  Over two windows: monitor outputs (curves,
    URD sizes), policies, feasibility and sample rates exactly; sizes
    under the PGD tie rule of ``test_torch_oracle``; replay counts and final
    LRU states exactly while every earlier window's sizes were equal."""
    profiles = list(MSR_PROFILES)
    names = [f"{p}#{k}" for k in range(16) for p in profiles]
    kw = dict(c_min=5, initial_blocks=20, sample_target=64, sample_floor=16,
              t_fast=1.0, t_slow=20.0, flush_cost=10.0)
    a = make_manager_ref("eci", 3000, names, **kw)
    b = make_manager("eci", 3000, names, device="cpu", **kw)
    assert a.effective_sample_rate() == b.effective_sample_rate() == "auto"
    replay_comparable = True
    for w in range(2):
        seeds = [1000 * w + i for i in range(len(names))]
        a.run_window([msr_trace_ref(nm.split("#")[0], 200, seed=s)
                      for nm, s in zip(names, seeds)])
        b.run_window([msr_trace(nm.split("#")[0], 200, seed=s)
                      for nm, s in zip(names, seeds)])
        da, db = a.history[-1], b.history[-1]
        assert [p.value for p in db.policies] == \
            [p.value for p in da.policies]
        assert db.feasible == da.feasible is False       # PGD ran
        for ta, tb in zip(a.tenants, b.tenants):
            assert tb.urd_size == ta.urd_size
            np.testing.assert_array_equal(tb.h_fn.edges.numpy(),
                                          ta.h_fn.edges)
            np.testing.assert_array_equal(tb.h_fn.heights.numpy(),
                                          ta.h_fn.heights)
        curves = [t.h_fn for t in a.tenants]
        step = 0.05 * 3000 / len(names) * np.sqrt(len(names))
        assert_pgd_sizes_match(curves, db.partition.relaxed.numpy(),
                               reference_relaxed(curves, 3000, 5),
                               db.sizes.numpy(), da.sizes, step)
        if replay_comparable:
            for ta, tb in zip(a.tenants, b.tenants):
                for f in ("reads", "read_hits", "writes", "write_hits",
                          "cache_writes", "capacity", "policy"):
                    assert getattr(tb.result, f) == getattr(ta.result, f), f
                assert tb.result.total_latency == pytest.approx(
                    ta.result.total_latency, rel=1e-12)
        if da.sizes.tolist() == db.sizes.tolist():
            assert db.guard == da.guard
        else:
            replay_comparable = False
    if replay_comparable:
        for ta, tb in zip(a.tenants, b.tenants):
            np.testing.assert_array_equal(
                tb.cache.state_arrays()[0].numpy(),
                np.asarray(ta.cache.state_arrays()[0]))
    assert b.summary()["windows_analyzed"] == 2
