"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Every test here needs a Hopper card and skips elsewhere with the reason;
run them on the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  They hold each kernel against its plain
PyTorch version on the same inputs, exactly (the counts are integers).
This module imports nothing of JAX, so it runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_manager
from repro_torch.core.batch_sim import segment_links
from repro_torch.data.traces import msr_trace
from repro_torch.kernels import hopper_available
from repro_torch.kernels.cache_sim.kernel import cache_sim_scan
from repro_torch.kernels.cache_sim.ops import stack_distances
from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
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
