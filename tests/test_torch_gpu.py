"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Every test here needs a Hopper card and skips elsewhere with the reason;
run them on the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  They hold each kernel against its plain
PyTorch version on the same inputs, exactly (the counts are integers),
and run ``pgd_solve`` and the 256-tenant SHARDS-sampled manager on the
card against the CPU.
This module imports nothing of JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_manager
from repro_torch.core.batch_sim import (padded_segment_layout,
                                        padded_tape_links, segment_links)
from repro_torch.core.mrc import build_hit_ratio_functions
from repro_torch.core.partitioner import pgd_solve
from repro_torch.data.traces import MSR_PROFILES, msr_trace
from repro_torch.kernels import hopper_available
from repro_torch.kernels.cache_sim.kernel import (cache_sim_scan,
                                                  cache_sim_segments_scan)
from repro_torch.kernels.cache_sim.ops import (stack_distances,
                                               stack_distances_segments,
                                               width_groups_of)
from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
                                               cache_sim_segments_ref,
                                               cache_sim_segments_tree,
                                               stack_distances_tree)

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
