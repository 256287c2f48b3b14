"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Every test here needs a Hopper card and skips elsewhere with the reason;
run them on the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  They hold each kernel against its plain
PyTorch version on the same inputs, exactly (the counts are integers),
and run ``pgd_solve``, the 256-tenant SHARDS-sampled manager, two-level
``simulate_many`` (through both residency routes), the ``etica``
manager, ``reuse_distances_accel`` (``urd_scan``), the fast greedy walk,
the ``static`` and ``reuse_intensity`` managers and an event-driven
churn scenario on the card against the CPU; the prefill attention and
SSD kernels against their plain versions, and the smoke zamba2 model
through ``prefill`` and ``decode_step``, card against CPU; the paged
decode attention against its plain version, and the serving engine on
the smoke qwen3 config, card against CPU.
This module imports nothing of JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (LRUCache, Trace, WritePolicy, analyze_windows,
                              build_hit_ratio_function, greedy_allocate,
                              make_manager, reuse_distances,
                              sampled_reuse_distances, simulate_many)
from repro_torch.core.batch_sim import (padded_segment_layout,
                                        padded_tape_links, segment_links)
from repro_torch.core.mrc import build_hit_ratio_functions
from repro_torch.core.reuse_distance import RDResult
from repro_torch.core.partitioner import pgd_solve
from repro_torch.data.scenarios import churn, replay_scenario
from repro_torch.data.traces import MSR_PROFILES, msr_trace, synthetic_mix
from repro_torch.kernels import hopper_available
from repro_torch.kernels.cache_sim.kernel import (cache_sim_levels_scan,
                                                  cache_sim_scan,
                                                  cache_sim_segments_scan,
                                                  live_count_scan)
from repro_torch.kernels.cache_sim.ops import (stack_distances,
                                               stack_distances_segments,
                                               width_groups_of)
from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                               cache_sim_ref,
                                               cache_sim_segments_ref,
                                               cache_sim_segments_tree,
                                               live_counts_delta,
                                               live_counts_ref,
                                               stack_distances_tree)
from repro_torch.kernels.urd_scan.kernel import urd_scan
from repro_torch.kernels.urd_scan.ops import reuse_distances_accel
from repro_torch.kernels.urd_scan.ref import urd_scan_ref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import SWEEP as ATTN_SWEEP
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     blockwise_attention)
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import SWEEP as SSD_SWEEP
from repro_torch.kernels.mamba2_ssd.ref import (SEQUENTIAL_CASES,
                                                mamba2_ssd_chunked,
                                                mamba2_ssd_ref, seg_from_dA)
from repro_torch.models.model import (decode_step, hybrid_groups,
                                      init_decode_cache, init_params,
                                      params_from_jax, prefill)
from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.core import ECICacheManager
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import SWEEP as PAGED_SWEEP
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     sweep_arrays)
from repro_torch.serve.engine import MultiTenantEngine, Request

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not hopper_available():
        pytest.skip("needs a CUDA card of compute capability >= 9.0 "
                    "(the kernels target sm_90a)")
    return torch.device("cuda")


def _tape(n, seed, device, blocks=4):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(blocks - 1, n - 1),
                              replace=False)) if n > 1 else np.zeros(0)
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    lens = np.diff(bounds)
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    tid = torch.as_tensor(np.repeat(np.arange(lens.size), lens),
                          device=device)
    ends = torch.as_tensor(bounds[1:], device=device)[tid]
    prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=device),
                                    tid, ends)
    reads = torch.as_tensor(rng.random(n) < 0.6, device=device)
    return prev, nxt, reads


@pytest.mark.parametrize("n", [1, 31, 255, 256, 257, 4097])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_cache_sim_scan_matches_ref_on_card(card, n, occ_kind):
    prev, nxt, reads = _tape(n, n, card)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    occ = (torch.ones_like(p32) if occ_kind == "ones"
           else reads.to(torch.int32))
    got = cache_sim_scan(p32, n32, occ)
    want = cache_sim_ref(p32, n32, occ)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[prev < 0] == -1).all())


def test_kernel_matches_merge_tree_on_card(card):
    prev, nxt, _ = _tape(200_000, 7, card, blocks=16)
    got = stack_distances(prev, nxt)
    torch.cuda.synchronize()
    assert torch.equal(got, stack_distances_tree(prev, nxt))


def test_launch_counter_and_input_checks(card):
    prev, nxt, _ = _tape(1000, 3, card)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    before = cache_sim_scan.launches
    cache_sim_scan(p32, n32, torch.ones_like(p32))
    assert cache_sim_scan.launches == before + 1
    with pytest.raises(ValueError):
        cache_sim_scan(prev, nxt, torch.ones_like(prev))   # int64
    assert cache_sim_scan.launches == before + 1


def test_manager_on_card_matches_cpu(card):
    names = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]
    kw = dict(c_min=10, initial_blocks=40, engine="batch", t_fast=1.0,
              t_slow=20.0, flush_cost=10.0)
    g = make_manager("eci", 400, names, device="cuda", **kw)
    c = make_manager("eci", 400, names, device="cpu", **kw)
    for w in range(3):
        traces = [msr_trace(nm, 3000, seed=10 * w + i)
                  for i, nm in enumerate(names)]
        g.run_window(traces)
        c.run_window(traces)
        assert g.history[-1].sizes.tolist() == c.history[-1].sizes.tolist()
        assert g.history[-1].policies == c.history[-1].policies
    for tg, tc in zip(g.tenants, c.tenants):
        assert tg.result == tc.result
        assert torch.equal(tg.cache.state_arrays()[0].cpu(),
                           tc.cache.state_arrays()[0])


def _padded_tape(lens, seed, device):
    """A padded, self-aligned multi-tenant tape: links (padded-tape
    global), occupancy, a read mask and the width groups."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    bounds = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]))
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    tid = torch.as_tensor(np.repeat(np.arange(lens.size), lens),
                          device=device)
    prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=device),
                                    tid, bounds.to(device)[1:][tid])
    lay = padded_segment_layout(bounds, device=device)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt, lay)
    reads = torch.zeros_like(gocc)
    reads[lay[1]] = torch.as_tensor(rng.random(int(lens.sum())) < 0.6,
                                    device=device).to(torch.int32)
    return gprev, gnxt, gocc, reads, width_groups_of(lay[4])


SEGMENT_LENS = {64: [64, 1, 33, 0, 64], 512: [512, 300, 257],
                4096: [4096, 2049, 3000], 8192: [8192, 5000, 4097],
                16384: [16384, 9000]}     # 16384: wider than one stage


@pytest.mark.parametrize("w", sorted(SEGMENT_LENS))
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_cache_sim_segments_scan_matches_ref_on_card(card, w, occ_kind):
    gprev, gnxt, gocc, reads, groups = _padded_tape(SEGMENT_LENS[w], w, card)
    for gw, lo, hi in groups:
        gp = gprev[lo:hi]
        p32 = torch.where(gp >= 0, gp - lo, -1).to(torch.int32)
        n32 = (gnxt[lo:hi] - lo).to(torch.int32)
        occ = (gocc if occ_kind == "ones" else reads)[lo:hi].contiguous()
        got = cache_sim_segments_scan(p32, n32, occ, gw)
        want = cache_sim_segments_ref(p32, n32, occ, gw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (gw, lo, hi)
        assert torch.equal(got, cache_sim_segments_tree(p32, n32, occ, gw))
        assert bool((got[p32 < 0] == -1).all())


def test_segments_launch_counter_and_input_checks(card):
    gprev, gnxt, gocc, _, groups = _padded_tape([200, 150], 5, card)
    (w, lo, hi), = groups
    p32 = gprev[lo:hi].to(torch.int32)
    n32 = gnxt[lo:hi].to(torch.int32)
    before = cache_sim_segments_scan.launches
    cache_sim_segments_scan(p32, n32, gocc, w)
    assert cache_sim_segments_scan.launches == before + 1
    with pytest.raises(ValueError):
        cache_sim_segments_scan(gprev, gnxt, gocc.long(), w)  # int64
    with pytest.raises(ValueError):
        cache_sim_segments_scan(p32, n32, gocc, w * 3)        # not a divisor
    assert cache_sim_segments_scan.launches == before + 1


def test_stack_distances_segments_card_matches_cpu(card):
    rng = np.random.default_rng(11)
    lens = rng.integers(0, 5000, 40)
    lens[:3] = [0, 64, 20000]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    tid = np.repeat(np.arange(lens.size), lens)
    out = []
    for dev in (card, torch.device("cpu")):
        t = torch.as_tensor(tid, device=dev)
        prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=dev),
                                        t, torch.as_tensor(bounds,
                                                           device=dev)[1:][t])
        out.append(stack_distances_segments(prev, nxt,
                                            torch.as_tensor(bounds)).cpu())
    assert torch.equal(out[0], out[1])


def test_pgd_256_tenants_bitwise_card_vs_cpu(card):
    rng = np.random.default_rng(4)
    n = 256
    lens = rng.integers(50, 400, n)
    dist = np.concatenate([
        np.where(rng.random(ln) < 0.3, -1,
                 rng.integers(0, rng.integers(5, 300), ln)) for ln in lens])
    tid = np.repeat(np.arange(n), lens)
    res = []
    for dev in (card, torch.device("cpu")):
        h = build_hit_ratio_functions(torch.as_tensor(dist, device=dev),
                                      torch.as_tensor(tid, device=dev), n,
                                      torch.as_tensor(lens, device=dev))
        cap = int(h.max_useful_sizes.sum() * 0.6)
        res.append(pgd_solve(h, cap, 1.0, 20.0, c_min=5))
    assert torch.equal(res[0].relaxed, res[1].relaxed)
    assert res[0].sizes.tolist() == res[1].sizes.tolist()


def test_manager_256_tenants_on_card_matches_cpu(card):
    names = [f"{p}#{k}" for k in range(16) for p in MSR_PROFILES]
    kw = dict(c_min=5, initial_blocks=20, sample_target=128,
              sample_floor=32, t_fast=1.0, t_slow=20.0, flush_cost=10.0)
    g = make_manager("eci", 6000, names, device="cuda", **kw)
    c = make_manager("eci", 6000, names, device="cpu", **kw)
    before = cache_sim_segments_scan.launches
    for w in range(2):
        traces = [msr_trace(nm.split("#")[0], 1000, seed=1000 * w + i)
                  for i, nm in enumerate(names)]
        g.run_window(traces)
        c.run_window(traces)
        assert g.history[-1].sizes.tolist() == c.history[-1].sizes.tolist()
        assert g.history[-1].policies == c.history[-1].policies
        assert g.history[-1].guard == c.history[-1].guard
    assert cache_sim_segments_scan.launches > before
    for tg, tc in zip(g.tenants, c.tenants):
        assert tg.result == tc.result
        assert torch.equal(tg.cache.state_arrays()[0].cpu(),
                           tc.cache.state_arrays()[0])


def _caps(n, seed, device):
    """Per-row L1 and union capacities: a quarter cap1 = 0, a quarter
    cap1 = captot, the rest varying."""
    rng = np.random.default_rng(seed)
    cap1 = rng.integers(0, 40, n)
    captot = cap1 + rng.integers(0, 40, n)
    cap1[: n // 4] = 0
    captot[n // 4: n // 2] = cap1[n // 4: n // 2]
    return (torch.as_tensor(cap1, dtype=torch.int32, device=device),
            torch.as_tensor(captot, dtype=torch.int32, device=device))


@pytest.mark.parametrize("n", [1, 31, 255, 4097, 65536])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_cache_sim_levels_scan_matches_ref_on_card(card, n, occ_kind):
    prev, nxt, reads = _tape(n, n + 1, card)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    occ = (torch.ones_like(p32) if occ_kind == "ones"
           else reads.to(torch.int32))
    cap1, captot = _caps(n, n, card)
    got = cache_sim_levels_scan(p32, n32, occ, cap1, captot)
    want = cache_sim_levels_ref(p32, n32, occ, cap1, captot)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1][prev < 0].any())


def _live_inputs(n, seed, device):
    """Links of a tape plus rows with nxt = -1, nxt = j and nxt = n."""
    _, nxt, reads = _tape(n, seed, device)
    rng = np.random.default_rng(seed)
    nxt = nxt.clone()
    pos = torch.arange(n, device=device)
    pick = torch.as_tensor(rng.integers(0, 4, n), device=device)
    nxt = torch.where(pick == 0, -1, nxt)
    nxt = torch.where(pick == 1, pos, nxt)
    nxt = torch.where((pick == 2) & (pos % 3 == 0), n, nxt)
    return nxt.to(torch.int32), reads.to(torch.int32)


@pytest.mark.parametrize("n", [1, 255, 4097, 8192, 8193, 65536, 300_000])
def test_live_count_scan_matches_ref_on_card(card, n):
    nxt, occ = _live_inputs(n, n, card)
    got = live_count_scan(nxt, occ)
    want = live_counts_delta(nxt, occ)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if n <= 8193:
        assert torch.equal(got, live_counts_ref(nxt, occ))


def test_level_kernels_launch_counters_and_input_checks(card):
    prev, nxt, reads = _tape(1000, 5, card)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    cap1, captot = _caps(1000, 5, card)
    b_lv, b_live = cache_sim_levels_scan.launches, live_count_scan.launches
    cache_sim_levels_scan(p32, n32, torch.ones_like(p32), cap1, captot)
    live_count_scan(n32, reads.to(torch.int32))
    assert cache_sim_levels_scan.launches == b_lv + 1
    assert live_count_scan.launches == b_live + 1
    with pytest.raises(ValueError):
        cache_sim_levels_scan(prev, nxt, torch.ones_like(prev), cap1.long(),
                              captot.long())                     # int64
    with pytest.raises(ValueError):
        cache_sim_levels_scan(p32, n32, torch.ones_like(p32), captot,
                              cap1)                      # cap1 > captot
    with pytest.raises(ValueError):
        live_count_scan(nxt, reads.long())                        # int64
    assert cache_sim_levels_scan.launches == b_lv + 1
    assert live_count_scan.launches == b_live + 1


@pytest.mark.parametrize("window_rd", [False, True])
def test_two_level_simulate_many_card_matches_cpu(card, window_rd):
    """Mixed WB/WT/RO x clean/dirty L2 tenants over warm windows, one
    with L1 = 0 and RO ones under pressure: the card's residency route
    (``cache_sim_levels_scan``, or ``cache_sim_scan`` when the window's
    reuse distances are asked for) gives the CPU's results and states."""
    rng = np.random.default_rng(3)
    pols = ["wb", "wt", "ro", "ro", "wb", "ro"]
    pols2 = ["wb", "ro", "wb", "ro", "ro", "wb"]
    caps1 = [40, 30, 20, 8, 0, 4]
    caps2 = [80, 60, 40, 16, 50, 8]
    devs = (card, torch.device("cpu"))
    side = [([LRUCache(c, dev) for c in caps1],
             [LRUCache(c, dev) for c in caps2]) for dev in devs]
    counters = (cache_sim_levels_scan, cache_sim_scan, live_count_scan)
    before = [k.launches for k in counters]
    for w in range(3):
        traces = [Trace(torch.as_tensor(rng.integers(0, 30 + 20 * i, 2000)),
                        torch.as_tensor(rng.random(2000) < 0.6))
                  for i in range(len(pols))]
        out = [simulate_many(
            traces, policies=[WritePolicy(p) for p in pols], caches=c1,
            policies2=[WritePolicy(p) for p in pols2], caches2=c2,
            flush_cost=10.0, t_fast2=4.0, return_window_rd=window_rd,
            device=dev) for dev, (c1, c2) in zip(devs, side)]
        if window_rd:
            (res_g, rd_g), (res_c, rd_c) = out
            for a, b in zip(rd_g, rd_c):
                assert torch.equal(a.cpu(), b)
        else:
            res_g, res_c = out
        assert res_g == res_c
    (g1, g2), (c1, c2) = side
    for a, b in zip(g1 + g2, c1 + c2):
        assert torch.equal(a.state_arrays()[0].cpu(), b.state_arrays()[0])
        assert torch.equal(a.state_arrays()[1].cpu(), b.state_arrays()[1])
    after = [k.launches - b for k, b in zip(counters, before)]
    assert after[1 if window_rd else 0] == 3      # one residency launch
    assert after[2] >= 3                          # the RO guard's L


def test_etica_manager_on_card_matches_cpu(card):
    names = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]
    kw = dict(capacity2=1200, c_min=10, initial_blocks=40, t_fast=1.0,
              t_fast2=4.0, t_slow=20.0, flush_cost=10.0)
    g = make_manager("etica", 400, names, device="cuda", **kw)
    c = make_manager("etica", 400, names, device="cpu", **kw)
    before = live_count_scan.launches
    for w in range(3):
        traces = [msr_trace(nm, 3000, seed=10 * w + i)
                  for i, nm in enumerate(names)]
        g.run_window(traces)
        c.run_window(traces)
        assert g.history[-1].sizes.tolist() == c.history[-1].sizes.tolist()
        assert g.history[-1].sizes2.tolist() == \
            c.history[-1].sizes2.tolist()
        assert g.history[-1].policies2 == c.history[-1].policies2
    assert live_count_scan.launches > before
    for tg, tc in zip(g.tenants, c.tenants):
        assert tg.result == tc.result
        for a, b in ((tg.cache, tc.cache), (tg.cache2, tc.cache2)):
            assert torch.equal(a.state_arrays()[0].cpu(), b.state_arrays()[0])
    assert g.summary() == c.summary()


# --------------------------------------------------- urd_scan (slice 4)
@pytest.mark.parametrize("n", [1, 31, 255, 256, 4097, 65536])
def test_urd_scan_matches_ref_on_card(card, n):
    prev, nxt, _ = _tape(n, n + 3, card, blocks=5)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    got = urd_scan(p32, n32)
    want = urd_scan_ref(p32, n32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[prev < 0] == -1).all())


def test_urd_scan_launch_counter_and_input_checks(card):
    prev, nxt, _ = _tape(1000, 5, card)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    before = urd_scan.launches
    got = urd_scan(p32, n32)
    assert urd_scan.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int64), stack_distances_tree(prev, nxt))
    with pytest.raises(ValueError):
        urd_scan(prev, nxt)                               # int64
    with pytest.raises(ValueError):
        urd_scan(p32, n32.cpu())                          # two devices
    assert urd_scan.launches == before + 1


@pytest.mark.parametrize("kind", ["urd", "trd"])
@pytest.mark.parametrize("name", ["prxy_0", "prn_1", "hm_1", "web_1"])
def test_reuse_distances_accel_card_matches_cpu(card, name, kind):
    tr = msr_trace(name, 20000, seed=3)
    before = urd_scan.launches
    got = reuse_distances_accel(tr, kind, device="cuda")
    assert urd_scan.launches == before + 1
    assert got.distances.device.type == "cuda"
    want = reuse_distances(tr, kind).distances
    assert torch.equal(got.distances.cpu(), want)
    assert torch.equal(reuse_distances_accel(tr, kind, device="cpu")
                       .distances, want)


def test_curves_and_sampled_distances_card_match_cpu(card):
    """Divisions by a Python number: CUDA multiplies by its reciprocal,
    so the port divides by device tensors (3 / 5 != 3 * (1 / 5))."""
    for i, n in enumerate((5, 777, 4999)):
        tr = msr_trace("web_1", n, seed=i)
        rd = reuse_distances(tr, "urd")
        g = build_hit_ratio_function(RDResult(rd.distances.cuda(), "urd"))
        c = build_hit_ratio_function(rd)
        assert torch.equal(g.heights.cpu(), c.heights)
        gs = sampled_reuse_distances(Trace(tr.addrs.cuda(), tr.is_read.cuda()),
                                     "trd", rate=0.3, seed=i)
        cs = sampled_reuse_distances(tr, "trd", rate=0.3, seed=i)
        assert torch.equal(gs.distances.cpu(), cs.distances)


def test_greedy_fast_on_card_matches_heap_on_cpu(card):
    traces = synthetic_mix(256, 2000, seed=7)
    curves = analyze_windows(traces, "urd", device="cuda").curves
    host = curves.to("cpu")
    cap = int(0.35 * int(host.max_useful_sizes.sum()))
    for c_min in (0, 50, 400):                 # 400: the minimums rescale
        g = greedy_allocate(curves, cap, 1.0, 20.0, c_min=c_min)
        h = greedy_allocate(host, cap, 1.0, 20.0, c_min=c_min,
                            method="heap")
        assert g.sizes.tolist() == h.sizes.tolist()
        assert g.hit_ratios.tolist() == h.hit_ratios.tolist()
        assert g.feasible == h.feasible
        assert g.latency == pytest.approx(h.latency, rel=1e-12)


def _same_managers(g, c):
    assert len(g.history) == len(c.history)
    for dg, dc in zip(g.history, c.history):
        assert dg.sizes.tolist() == dc.sizes.tolist()
        assert dg.policies == dc.policies
        assert [(e.window, e.tenant, e.reason) for e in dg.trigger] == \
            [(e.window, e.tenant, e.reason) for e in dc.trigger]
    for tg, tc in zip(g.tenants, c.tenants):
        rg, rc = dict(vars(tg.result)), dict(vars(tc.result))
        lg, lc = rg.pop("total_latency"), rc.pop("total_latency")
        assert rg == rc
        assert lg == pytest.approx(lc, rel=1e-12)
        assert torch.equal(tg.cache.state_arrays()[0].cpu(),
                           tc.cache.state_arrays()[0])


@pytest.mark.parametrize("scheme", ["static", "reuse_intensity"])
def test_scheme_window_on_card_matches_cpu(card, scheme):
    names = list(MSR_PROFILES)
    kw = dict(c_min=50, initial_blocks=100, t_fast=1.0, t_slow=20.0,
              flush_cost=10.0)
    g = make_manager(scheme, 3000, names, device="cuda", **kw)
    c = make_manager(scheme, 3000, names, device="cpu", **kw)
    before = live_count_scan.launches
    traces = [msr_trace(nm, 4000, seed=i) for i, nm in enumerate(names)]
    g.run_window(traces)
    c.run_window(traces)
    if scheme == "reuse_intensity":
        assert live_count_scan.launches > before      # every tenant RO
    _same_managers(g, c)


def test_churn_scenario_on_card_matches_cpu(card):
    run = churn(seed=0)
    kw = dict(c_min=50, initial_blocks=50, phase_detect=True,
              reconfig_interval=4, t_fast=1.0, t_slow=20.0, flush_cost=10.0)
    g, _ = replay_scenario(run, lambda n: make_manager("eci", 2000, n,
                                                       device="cuda", **kw))
    c, _ = replay_scenario(run, lambda n: make_manager("eci", 2000, n,
                                                       device="cpu", **kw))
    assert [(e.window, e.tenant, e.reason, e.score) for e in g.events] == \
        [(e.window, e.tenant, e.reason, e.score) for e in c.events]
    assert g.windows_analyzed == c.windows_analyzed < g.windows_run
    _same_managers(g, c)


# ------------------------------------------- slice 5: the model layer
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_flash_attention_matches_plain_on_card(card, case, dtype):
    """The kernel against the dense ``attention_ref`` and the blockwise
    CPU route on the same card inputs, at tests/test_kernels.py's
    tolerances (f32 2e-5, bf16 2e-2)."""
    b, hq, hkv, sq, skv, d, dv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(sq + d)
    q = torch.randn((b, hq, sq, d), generator=gen, device=card).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=card).to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=gen, device=card).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, hq, sq, dv) and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window).transpose(1, 2)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_mamba2_ssd_matches_plain_on_card(card, case):
    """The kernel against the chunked form and, at tests/test_kernels.py's
    sweep (chunks up to 64), the sequential ``mamba2_ssd_ref`` on the same
    card inputs, 3e-6 after scaling by the largest output
    (tests/test_kernels.py:88).  At chunk 256 the chunked form is the
    yardstick: the sequential recurrence carries its own fp32 rounding
    over hundreds of steps there."""
    bh, s, p, n, chunk, groups = case
    gen = torch.Generator(device=card).manual_seed(bh + s)
    x = torch.randn((bh, s, p), generator=gen, device=card) * 0.5
    B = torch.randn((groups, s, n), generator=gen, device=card) * 0.5
    C = torch.randn((groups, s, n), generator=gen, device=card) * 0.5
    dA = -torch.rand((bh, s), generator=gen, device=card) * 0.5
    seg = seg_from_dA(dA, chunk)
    before = mamba2_ssd.launches
    got = mamba2_ssd(x, B, C, seg, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba2_ssd.launches == before + 1
    wants = [mamba2_ssd_chunked(x, B, C, seg, chunk=chunk)]
    if SSD_SWEEP.index(case) < SEQUENTIAL_CASES:
        wants.append(mamba2_ssd_ref(x, B, C, dA))
    for want in wants:
        scale = float(want.abs().max())
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=3e-6)


def test_zamba2_smoke_on_card_matches_cpu(card):
    """The smoke zamba2 config (float32) through ``prefill`` and four
    ``decode_step``s on the card against the port's CPU run on the same
    parameters: every Mamba-2 layer's prefill launches ``mamba2_ssd`` and
    every shared-block application ``flash_attention``; decode launches
    neither."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("zamba2_7b"), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    counts = (mamba2_ssd.launches, flash_attention.launches)
    got = prefill(gpu, cfg, toks.to(card))
    torch.cuda.synchronize()
    assert (mamba2_ssd.launches - counts[0],
            flash_attention.launches - counts[1]) == (
        cfg.n_layers, hybrid_groups(cfg)[0])
    want = prefill(cpu, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    gc = init_decode_cache(cfg, 2, 8, device=card)
    cc = init_decode_cache(cfg, 2, 8, device="cpu")
    counts = (mamba2_ssd.launches, flash_attention.launches)
    for t in range(4):
        lg, gc = decode_step(gpu, cfg, toks[:, t].to(card), gc)
        lc, cc = decode_step(cpu, cfg, toks[:, t], cc)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(gc["ssm"][name].cpu(), cc["ssm"][name],
                                   rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc["kv"]["k"].cpu(), cc["kv"]["k"],
                               rtol=1e-4, atol=1e-4)
    assert (mamba2_ssd.launches, flash_attention.launches) == counts


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return tree.numpy()


# ------------------------------------------- slice 6: the serving side
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_SWEEP)
def test_paged_attention_matches_plain_on_card(card, case, dtype):
    """The kernel against ``paged_attention_ref`` on the same card inputs
    at tests/test_kernels.py's tolerances (f32 2e-5, bf16 2e-2)."""
    a = sweep_arrays(case, seed=3)
    args = [torch.from_numpy(a[n]).to(card) for n in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    args[:3] = [t.to(dtype) for t in args[:3]]
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert got.shape == args[0].shape and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(),
                               paged_attention_ref(*args).float(),
                               rtol=tol, atol=tol)


def test_paged_attention_launch_counter_and_input_checks(card):
    """A length of 0 gives 0 (as the Pallas kernel); inputs the kernel
    does not take raise before any launch."""
    a = sweep_arrays(PAGED_SWEEP[0], seed=4)
    q, kp, vp, tables, lens = (torch.from_numpy(a[n]).to(card) for n in
                               ("q", "k_pages", "v_pages", "block_tables",
                                "seq_lens"))
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tables, torch.zeros_like(lens))
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert not bool(out.any())
    bad = [
        (q, kp, vp, tables.long(), lens),                 # int64 tables
        (q, kp, vp, tables, lens.long()),                 # int64 lengths
        (q.double(), kp.double(), vp.double(), tables, lens),
        (q, kp.transpose(1, 2), vp.transpose(1, 2), tables, lens),
        (q, kp, vp, tables.cpu(), lens),                  # two devices
        (q[..., :30], kp[..., :30].contiguous(), vp[..., :30].contiguous(),
         tables, lens),                                   # D % 4 != 0
    ]
    for args in bad:
        with pytest.raises(ValueError):
            paged_attention(*args)
    assert paged_attention.launches == before + 1


def _qwen3_engine(device, params, capacity2):
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    pool = BlockPool(96, 8, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.float32, device=device)
    mgr = ECICacheManager(24, ["chat", "batch"], c_min=4,
                          initial_blocks=16, capacity2=capacity2,
                          device=device)
    tiered = TieredKVCache(pool, mgr, window_events=10)
    eng = MultiTenantEngine(cfg, params, tiered, page_size=8,
                            max_pages_per_seq=8)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    for i, n in enumerate((24, 29, 16, 29, 16, 24)):
        tail = rng.integers(0, cfg.vocab_size, n - 16).astype(np.int32)
        eng.submit(Request(tenant=i % 2, prompt=np.concatenate([shared,
                                                                tail]),
                           max_new_tokens=5))
    eng.run(64)
    return eng, pool, tiered, mgr


@pytest.mark.parametrize("capacity2", [0, 48])
def test_qwen3_smoke_engine_on_card_matches_cpu(card, capacity2):
    """The serving engine on the smoke qwen3 config (float32) on the card
    against the port's CPU run on the same parameters: tokens, tiered
    summaries, pool stats and decisions equal, pages within 1e-5; every
    decode layer launches ``paged_attention`` and every prefill layer
    ``flash_attention``."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    counts = (paged_attention.launches, flash_attention.launches)
    g = _qwen3_engine(card, gpu, capacity2)
    torch.cuda.synchronize()
    c = _qwen3_engine("cpu", cpu, capacity2)
    steps = 4            # 5 new tokens: one from prefill, 4 decode steps
    assert (paged_attention.launches - counts[0],
            flash_attention.launches - counts[1]) == (
        steps * cfg.n_layers, 6 * cfg.n_layers)
    assert sorted((r.rid, r.generated) for r in g[0].completed) == \
        sorted((r.rid, r.generated) for r in c[0].completed)
    sg, sc = g[2].summary(), c[2].summary()
    sg.pop("rebalance_seconds"), sc.pop("rebalance_seconds")
    assert sg == sc and g[1].stats == c[1].stats
    assert [(d.sizes.tolist(), d.policies) for d in g[3].history] == \
        [(d.sizes.tolist(), d.policies) for d in c[3].history]
    torch.testing.assert_close(g[1].k_pages.cpu(), c[1].k_pages,
                               rtol=1e-5, atol=1e-5)
