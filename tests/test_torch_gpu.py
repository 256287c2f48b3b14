"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Every test here needs a Hopper card and skips elsewhere with the reason;
run them on the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  They hold each kernel against its plain
PyTorch version on the same inputs, exactly (the counts are integers;
``cache_sim_scan`` on intervals spanning many tiles and on one 16-tenant
MSR window; ``urd_scan`` and ``cache_sim_levels_scan``, which share its
tiled count, on intervals that start or end on a tile edge and cross
more than 16 whole tiles, ``urd_scan`` on the control plane's seed-row
windows and the levels kernel at any capacities), and run
``pgd_solve``, the 256-tenant SHARDS-sampled manager, two-level
``simulate_many`` (through both residency routes), the ``etica``
manager, ``reuse_distances_accel`` (``urd_scan``), the fast greedy walk,
the ``static`` and ``reuse_intensity`` managers and an event-driven
churn scenario on the card against the CPU; the prefill attention and
SSD kernels against their plain versions, and the smoke zamba2 model
through ``prefill`` and ``decode_step``, card against CPU; the paged
decode attention against its plain version and its split decomposition
(long rows at B 1 and 4, a row of length 0, the same bits from call to
call) and with the serving decode's in-flight token folded into its merge
(qwen3-0.6b's and qwen2-moe-a2.7b's decode shapes, one split and more),
and the serving engine on the smoke qwen3 config, card against
CPU.  The one-pass ``live_count_scan`` and the shared-memory
``cache_sim_segments_scan`` are also held to their decompositions
(``live_counts_onepass_ref``, ``cache_sim_segments_tiled_ref``) at their
edges: a tile +- 1, thousands of deaths on one word and deaths anywhere
on the tape; widths on both sides of the shared-memory / global boundary,
links that cross a block, every width group of a sampled MSR tape; and
from call to call and tape to tape (no state kept between calls).
The RO token replay kernels (``ro_token_replay_scan``,
``ro_token_replay_levels_scan``) are held to their plain versions on
pressured multi-block tapes (one-row blocks, capacity 0, warm L2, a clean
L2), on the edge tapes of their ring design (``ref.EDGE_CASES``: blocks
of 65,536 and 66,175 rows, pointers thousands of rows behind, warm-L2
prefixes across ring tiles, 170 blocks, a hit chain across the whole
block) and through ``simulate_many``; the device window pipeline runs under
``transfer_sanitizer`` (a planted sync raises; one sync a window, also in
``run_stream``) and equals the CPU bit for bit, as do
``analyze_windows(pipeline="device")``, ``greedy_allocate(method=
"device")`` and the manager under ``pipeline="device"``.  The
degradation ladder steps a dead device rung down to the host rung on the
card with the CPU's host run's decisions.  The sharded window pipeline
runs at 1, 2 and 8 logical shards on the card (``cache_sim_segments_scan``
launched on every shard, one sync a window per mesh under the sanitizer)
and equals the CPU's and ``pipeline="device"``'s bit for bit, through
``DeviceWindowPipeline(mesh=)``, ``run_stream``, ``analyze_windows`` and
the manager, whose dead sharded rung steps down to the device rung.
The MoE, MLA and encoder-decoder families: ``flash_attention``'s bf16
instance for MLA's (96, 64) heads at minicpm3-4b's 40 heads on the
model's own views, non-causal cross attention with Sq != Skv at
seamless-m4t's heads and ``paged_attention`` at a KV group of 1
(qwen2-moe-a2.7b's 16 over 16 heads), each against its plain version;
the smoke configs of those families through ``prefill`` and
``decode_step``, and the MoE smoke engine, card against CPU.
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
from repro_torch.core.trace import prev_next_occurrence
from repro_torch.core.mrc import build_hit_ratio_functions
from repro_torch.core.reuse_distance import RDResult
from repro_torch.core.partitioner import pgd_solve
from repro_torch.data.scenarios import churn, replay_scenario
from repro_torch.data.traces import MSR_PROFILES, msr_trace, synthetic_mix
from repro_torch.kernels import hopper_available
from repro_torch.core.monitor import shards_subtape
from repro_torch.core.reuse_distance import auto_sample_rate
from repro_torch.kernels.cache_sim.kernel import (LIVE_TILE,
                                                  SEGMENTS_SMEM_WIDTH, TILE,
                                                  cache_sim_levels_scan,
                                                  cache_sim_scan,
                                                  cache_sim_segments_scan,
                                                  live_count_scan)
from repro_torch.kernels.cache_sim.ops import (stack_distances,
                                               stack_distances_segments,
                                               width_groups_of)
from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                               cache_sim_levels_tiled_ref,
                                               cache_sim_ref,
                                               cache_sim_segments_ref,
                                               cache_sim_segments_tiled_ref,
                                               cache_sim_segments_tree,
                                               cache_sim_tiled_ref,
                                               live_counts_delta,
                                               live_counts_onepass_ref,
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
from repro_torch.kernels.mamba2_ssd.kernel import (chunk_scan, chunk_state,
                                                   mamba2_ssd, state_pass)
from repro_torch.kernels.mamba2_ssd.ref import SWEEP as SSD_SWEEP
from repro_torch.kernels.mamba2_ssd.ref import (SEQUENTIAL_CASES,
                                                chunk_scan_ref,
                                                chunk_state_ref,
                                                mamba2_ssd_chunked,
                                                mamba2_ssd_ref, seg_from_dA,
                                                state_pass_ref)
from repro_torch.models.model import (decode_step, hybrid_groups,
                                      init_decode_cache, init_params,
                                      params_from_jax, prefill)
from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.core import ECICacheManager
import repro_torch.kernels.paged_attention.kernel as paged_kernel
from repro_torch.kernels.paged_attention.kernel import (TILE as PAGED_TILE,
                                                        paged_attention,
                                                        split_count)
from repro_torch.kernels.paged_attention.ref import SWEEP as PAGED_SWEEP
from repro_torch.kernels.paged_attention.ref import (LONG_ROWS,
                                                     paged_attention_ref,
                                                     paged_attention_split_ref,
                                                     sweep_arrays)
from repro_torch.serve.engine import MultiTenantEngine, Request
from repro_torch.core import StageProfile
from repro_torch.core.device_pipeline import (DeviceWindowPipeline,
                                              transfer_sanitizer)
from repro_torch.kernels.ro_replay.kernel import (ro_token_replay_levels_scan,
                                                  ro_token_replay_scan)
from repro_torch.kernels.ro_replay.ref import (
    EDGE_CASES, ro_edge_tape, ro_token_replay_blocks_ref,
    ro_token_replay_levels_blocks_ref, ro_token_replay_levels_pointer_ref,
    ro_token_replay_pointer_ref)

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


def _edge_tape(n, seed, device):
    """``_tape`` plus, at every tile edge e, a fresh address touched at
    e - 1 and at a random later row of its block (an interval that starts
    on the edge, often crossing many whole tiles) and one touched at a
    random earlier row of e's block and at e (one that ends on it)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(3, n - 1),
                              replace=False)) if n > 1 else np.zeros(0)
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    lens = np.diff(bounds)
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    block = np.repeat(np.arange(lens.size), lens)
    fresh = int(addrs.max()) + 1
    for e in range(TILE, n, TILE):
        end = bounds[block[e - 1] + 1]
        if e + 1 < end:
            addrs[e - 1] = addrs[rng.integers(e + 1, end)] = fresh
        start = bounds[block[e]]
        if start < e - 1:
            addrs[rng.integers(start, e - 1)] = addrs[e] = fresh + 1
        fresh += 2
    tid = torch.as_tensor(block, device=device)
    ends = torch.as_tensor(bounds[1:], device=device)[tid]
    prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=device),
                                    tid, ends)
    reads = torch.as_tensor(rng.random(n) < 0.6, device=device)
    return prev, nxt, reads


def _edge_caps(n, seed, device):
    """Capacities of every kind, row by row at random: cap1 = 0,
    captot = 0, cap1 > captot, cap1 = captot and cap1 < captot."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, max(8, n // 64), n)
    b = rng.integers(0, max(8, n // 64), n)
    kind = rng.integers(0, 5, n)
    cap1 = np.select([kind == 0, kind == 2, kind == 4],
                     [0, np.maximum(a, b), np.minimum(a, b)], a)
    captot = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                       [0, np.minimum(a, b), a, np.maximum(a, b)], b)
    return (torch.as_tensor(cap1, dtype=torch.int32, device=device),
            torch.as_tensor(captot, dtype=torch.int32, device=device))


def _edge_rows(prev):
    """(rows whose interval starts on a tile edge, rows whose interval
    ends on one, most whole tiles an interval crosses)."""
    pos = torch.arange(prev.shape[0], device=prev.device)
    hot = prev >= 0
    lo, hi = prev[hot] + 1, pos[hot]
    whole = (hi // TILE - (lo + TILE - 1) // TILE).clamp(min=0)
    return (int(((lo % TILE == 0) & (lo < hi)).sum()),
            int(((hi % TILE == 0) & (lo < hi)).sum()),
            int(whole.max()) if whole.numel() else 0)


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


@pytest.mark.parametrize("n,addrs", [(100, 4), (511, 600), (20000, 300),
                                     (20000, 6000)])
def test_cache_sim_scan_long_intervals_on_card(card, n, addrs):
    """The two-pass tiled count, exactly against the dense definition:
    n below a tile, ragged, and intervals spanning many tiles (one tenant
    over ``addrs`` addresses); occ = 1 and a read mask.  Each call is one
    launch."""
    rng = np.random.default_rng(n + addrs)
    a = torch.as_tensor(rng.integers(0, addrs, n), device=card)
    prev, nxt, _, _ = segment_links(a, torch.zeros_like(a),
                                    torch.full_like(a, n))
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    reads = torch.as_tensor(rng.random(n) < 0.6, device=card)
    for occ in (torch.ones_like(p32), reads.to(torch.int32)):
        before = cache_sim_scan.launches
        got = cache_sim_scan(p32, n32, occ)
        assert cache_sim_scan.launches == before + 1
        want = cache_sim_ref(p32, n32, occ)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_cache_sim_scan_msr_window_on_card(card):
    """One 16-tenant MSR window (16 x 65,536 accesses, links severed per
    tenant): equal to the merge tree exactly."""
    traces = [msr_trace(p, 65536, seed=i)
              for i, p in enumerate(list(MSR_PROFILES)[:16])]
    addrs = torch.cat([t.addrs for t in traces]).to(card)
    lens = torch.tensor([len(t) for t in traces], device=card)
    tid = torch.repeat_interleave(torch.arange(16, device=card), lens)
    prev, nxt, _, _ = segment_links(addrs, tid, torch.cumsum(lens, 0)[tid])
    want = stack_distances_tree(prev, nxt)
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    got = cache_sim_scan(p32, n32, torch.ones_like(p32))
    torch.cuda.synchronize()
    assert torch.equal(got.long(), want)


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
                16384: [16384, 9000]}     # 16384: the widest block on chip


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


def _segment_group(w, lens, seed, device, cross=0):
    """One width group (numpy): a segment of each length in ``lens`` at
    the start of its own w-block, links severed per segment with ``nxt``
    clamped to its end, pad rows cold, non-occupying and linked to
    themselves; ``cross`` hot rows past the first block get a ``prev`` in
    an earlier block and as many a ``prev`` at or past the row.  Any w
    (the kernel takes any width that divides the length)."""
    rng = np.random.default_rng(seed)
    m = w * len(lens)
    prev = np.full(m, -1, np.int64)
    nxt = np.arange(m, dtype=np.int64)
    occ = np.zeros(m, np.int64)
    for b, ln in enumerate(lens):
        s, e = b * w, b * w + ln
        addrs = rng.integers(0, max(3, ln // 4), ln)
        order = np.argsort(addrs, kind="stable")
        same = addrs[order][1:] == addrs[order][:-1]
        prev[s + order[1:][same]] = s + order[:-1][same]
        nxt[s:e] = e
        nxt[s + order[:-1][same]] = s + order[1:][same]
        occ[s:e] = 1
    reads = occ * (rng.random(m) < 0.6)
    hot = np.flatnonzero((prev >= 0) & (np.arange(m) >= w))
    pick = rng.choice(hot, size=min(2 * cross, hot.size), replace=False)
    back, late = pick[:cross], pick[cross:]
    prev[back] = np.maximum(back - w - rng.integers(0, w, back.size), 0)
    prev[late] = late + rng.integers(0, 3, late.size)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    return t(prev), t(nxt), t(occ), t(reads)


@pytest.mark.parametrize("w", [64, 128, 256, 512, 640, 4096, 8192,
                               SEGMENTS_SMEM_WIDTH - 1, SEGMENTS_SMEM_WIDTH,
                               SEGMENTS_SMEM_WIDTH + 1,
                               2 * SEGMENTS_SMEM_WIDTH])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_segments_scan_edges_on_card(card, w, occ_kind):
    """Widths that take shared memory (up to ``SEGMENTS_SMEM_WIDTH``, a
    width of 640 and one of the boundary less 1 with a ragged last tile)
    and the global tiled count past it; full, half, one-row and empty
    segments; links that cross a block and prev at or past the row."""
    prev, nxt, occ, reads = _segment_group(w, [w, w // 2 + 1, 1, 0, w - 1],
                                           w, card, cross=w // 8 + 1)
    if occ_kind == "reads":
        occ = reads
    got = cache_sim_segments_scan(prev, nxt, occ, w)
    want = cache_sim_segments_tiled_ref(prev, nxt, occ, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[prev < 0] == -1).all())
    if prev.shape[0] <= 4096:
        assert torch.equal(got, cache_sim_segments_ref(prev, nxt, occ, w))


def test_segments_scan_sampled_tape_on_card(card):
    """Every width group of a sampled MSR tape: 32 tenants (the 16
    profiles twice) of 65,536 accesses, each kept at the manager's own
    rate, laid out and linked as the sampled monitor does."""
    names = list(MSR_PROFILES) * 2
    traces = [msr_trace(p, 65536, seed=i) for i, p in enumerate(names)]
    rates = [auto_sample_rate(len(t)) for t in traces]
    addrs, _, kept = shards_subtape(traces, rates, 0,
                                    list(range(len(traces))), card)
    tid = torch.repeat_interleave(torch.arange(len(traces), device=card),
                                  kept)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=card),
                        torch.cumsum(kept, 0)])
    prev, nxt, _, _ = segment_links(addrs, tid, bounds[1:][tid])
    lay = padded_segment_layout(bounds.cpu(), device=card)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt, lay)
    groups = width_groups_of(lay[4])
    assert len(groups) >= 2
    for w, lo, hi in groups:
        gp = gprev[lo:hi]
        args = (torch.where(gp >= 0, gp - lo, -1).to(torch.int32),
                (gnxt[lo:hi] - lo).to(torch.int32), gocc[lo:hi].contiguous())
        got = cache_sim_segments_scan(*args, w)
        torch.cuda.synchronize()
        assert torch.equal(got, cache_sim_segments_tree(*args, w)), w
        assert torch.equal(got, cache_sim_segments_tiled_ref(*args, w)), w


def test_segments_scan_repeats_and_keeps_no_state_on_card(card):
    """A second call gives the same bits; two tapes in turn, one in
    shared memory and one through the global count, give what their first
    calls gave; one launch a call."""
    a = (*_segment_group(4096, [4096, 3000, 2049], 1, card, cross=50)[:3],
         4096)
    b = (*_segment_group(2 * SEGMENTS_SMEM_WIDTH, [40000, 20000], 2, card,
                         cross=50)[:3], 2 * SEGMENTS_SMEM_WIDTH)
    before = cache_sim_segments_scan.launches
    ra, rb = cache_sim_segments_scan(*a), cache_sim_segments_scan(*b)
    torch.cuda.synchronize()
    assert torch.equal(ra, cache_sim_segments_tiled_ref(*a))
    assert torch.equal(rb, cache_sim_segments_tiled_ref(*b))
    for _ in range(3):
        assert torch.equal(cache_sim_segments_scan(*a), ra)
        assert torch.equal(cache_sim_segments_scan(*b), rb)
    assert cache_sim_segments_scan.launches == before + 8


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


@pytest.mark.parametrize("n", [255, 256, 257, 4097, 65536])
@pytest.mark.parametrize("occ_kind", ["ones", "reads"])
def test_cache_sim_levels_scan_any_capacities_on_card(card, n, occ_kind):
    """The exact tiled count compared with both capacities: rows with
    cap1 > captot, cap1 = 0 and captot = 0, on intervals that start and
    end on tile edges and, at 65,536, cross more than 16 whole tiles."""
    prev, nxt, reads = _edge_tape(n, n + 2, card)
    starts, ends, whole = _edge_rows(prev)
    assert (starts > 0 or n <= 2 * TILE) and (ends > 0 or n <= TILE)
    assert n < 65536 or whole > 16
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    occ = (torch.ones_like(p32) if occ_kind == "ones"
           else reads.to(torch.int32))
    cap1, captot = _edge_caps(n, n, card)
    assert bool((cap1 > captot).any()) and bool((captot == 0).any())
    before = cache_sim_levels_scan.launches
    got = cache_sim_levels_scan(p32, n32, occ, cap1, captot)
    assert cache_sim_levels_scan.launches == before + 1
    want = cache_sim_levels_ref(p32, n32, occ, cap1, captot)
    tiled = cache_sim_levels_tiled_ref(p32, n32, occ, cap1, captot, TILE)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, tiled):
        assert torch.equal(g, w) and torch.equal(t, w)


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


def _live_edge_inputs(n, seed, device):
    """``_live_inputs`` plus, past 2,000 rows, 1,500 rows before the middle
    dying at the middle word, and a twentieth of the rows dying anywhere
    on the tape (or past it)."""
    nxt, occ = _live_inputs(n, seed, device)
    rng = np.random.default_rng(seed + 1)
    if n > 2000:
        nxt[n // 2 - 1500:n // 2] = n // 2
    far = torch.as_tensor(rng.random(n) < 0.05, device=device)
    anywhere = torch.as_tensor(rng.integers(0, n + 2, n), device=device)
    return torch.where(far, anywhere, nxt).to(torch.int32), occ


@pytest.mark.parametrize("n", [1, LIVE_TILE - 1, LIVE_TILE, LIVE_TILE + 1,
                               3 * LIVE_TILE + 1, 1 << 20])
def test_live_count_scan_edges_on_card(card, n):
    nxt, occ = _live_edge_inputs(n, n + 3, card)
    for o in (occ, torch.ones_like(occ)):
        got = live_count_scan(nxt, o)
        want = live_counts_delta(nxt, o)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, live_counts_onepass_ref(nxt, o, LIVE_TILE))
        if n <= LIVE_TILE + 1:
            assert torch.equal(got, live_counts_ref(nxt, o))


def test_live_count_scan_repeats_and_keeps_no_state_on_card(card):
    """A second call gives the same bits; two tapes of other lengths in
    turn give what their first calls gave; one launch a call."""
    a = _live_edge_inputs(300_000, 1, card)
    b = _live_edge_inputs(77_777, 2, card)
    before = live_count_scan.launches
    ra, rb = live_count_scan(*a), live_count_scan(*b)
    torch.cuda.synchronize()
    assert torch.equal(ra, live_counts_delta(*a))
    assert torch.equal(rb, live_counts_delta(*b))
    for _ in range(3):
        assert torch.equal(live_count_scan(*a), ra)
        assert torch.equal(live_count_scan(*b), rb)
    assert live_count_scan.launches == before + 8


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
    # cap1 > captot: the exact count makes the masks the function's there
    got = cache_sim_levels_scan(p32, n32, torch.ones_like(p32), captot,
                                cap1)
    want = cache_sim_levels_ref(p32, n32, torch.ones_like(p32), captot,
                                cap1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cache_sim_levels_scan.launches == b_lv + 2
    with pytest.raises(ValueError):
        live_count_scan(nxt, reads.long())                        # int64
    assert cache_sim_levels_scan.launches == b_lv + 2
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


@pytest.mark.parametrize("n", [255, 256, 257, 4097, 65536])
def test_urd_scan_tile_edges_and_long_intervals_on_card(card, n):
    """The tiled count keyed on nxt: intervals that start and end on tile
    edges and, at 65,536, cross more than 16 whole tiles (a row's lanes
    loop over its tiles), links severed per tenant; equal to the dense
    definition and to the decomposition with every position occupying."""
    prev, nxt, _ = _edge_tape(n, n + 4, card)
    starts, ends, whole = _edge_rows(prev)
    assert (starts > 0 or n <= 2 * TILE) and (ends > 0 or n <= TILE)
    assert n < 65536 or whole > 16
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    got = urd_scan(p32, n32)
    want = urd_scan_ref(p32, n32)
    tiled = cache_sim_tiled_ref(p32, n32, torch.ones_like(p32), TILE)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(tiled, want)


def test_urd_scan_seed_row_windows_on_card(card):
    """The control plane's seed row: 8,000-access windows of
    ``synthetic_mix(1024, 8000, seed=7)`` (32 tiles, each split over
    several CTAs), one launch a window, equal to the dense definition."""
    for tr in synthetic_mix(1024, 8000, seed=7)[:8]:
        prev, nxt = prev_next_occurrence(tr.addrs.to(card))
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        before = urd_scan.launches
        got = urd_scan(p32, n32)
        assert urd_scan.launches == before + 1
        want = urd_scan_ref(p32, n32)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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
    # a view 4 bytes into its storage: nxt is copied to 16-byte alignment
    got = urd_scan(p32[1:], n32[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, urd_scan_ref(p32[1:], n32[1:]))
    assert urd_scan.launches == before + 2


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
# the sweep, then zamba2's and qwen3's prefill heads at full width and a
# reduced length
ATTN_CARD_CASES = ATTN_SWEEP + [(1, 32, 32, 1024, 1024, 112, 112, True, 0),
                                (1, 16, 8, 1024, 1024, 128, 128, True, 0)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CARD_CASES)
def test_flash_attention_matches_plain_on_card(card, case, dtype, layout):
    """The kernel against the dense ``attention_ref`` and the blockwise
    CPU route on the same card inputs, at tests/test_kernels.py's
    tolerances (f32 2e-5, bf16 2e-2), on contiguous ``[B, H, S, D]``
    tensors and on ``[B, H, S, D]`` views of the model's ``[B, S, H, D]``
    (read in place through their strides; the output is then a view of a
    contiguous ``[B, S, Hq, Dv]`` tensor)."""
    b, hq, hkv, sq, skv, d, dv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(sq + d)

    def make(h, s, dim):
        if layout == "bhsd":
            return torch.randn((b, h, s, dim), generator=gen, device=card)
        return torch.randn((b, s, h, dim), generator=gen,
                           device=card).transpose(1, 2)
    q, k, v = (make(hq, sq, d).to(dtype), make(hkv, skv, d).to(dtype),
               make(hkv, skv, dv).to(dtype))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, hq, sq, dv) and got.dtype == dtype
    if layout == "bshd":
        assert got.transpose(1, 2).is_contiguous()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window).transpose(1, 2)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _ssd_card_inputs(case, card):
    bh, s, p, n, chunk, groups = case
    gen = torch.Generator(device=card).manual_seed(bh + s)
    x = torch.randn((bh, s, p), generator=gen, device=card) * 0.5
    B = torch.randn((groups, s, n), generator=gen, device=card) * 0.5
    C = torch.randn((groups, s, n), generator=gen, device=card) * 0.5
    dA = -torch.rand((bh, s), generator=gen, device=card) * 0.5
    return x, B, C, dA, seg_from_dA(dA, chunk)


def _scaled_close_card(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=3e-6)


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_mamba2_ssd_matches_plain_on_card(card, case):
    """The kernel against the chunked form and, at tests/test_kernels.py's
    sweep (chunks up to 64), the sequential ``mamba2_ssd_ref`` on the same
    card inputs, 3e-6 after scaling by the largest output
    (tests/test_kernels.py:88).  At chunk 256 the chunked form is the
    yardstick: the sequential recurrence carries its own fp32 rounding
    over hundreds of steps there.  Then each of its three passes against
    its plain version on the same inputs: the chunk states, the states
    entering each chunk (from the plain chunk states) and the output
    (from the plain entering states)."""
    x, B, C, dA, seg = _ssd_card_inputs(case, card)
    chunk = case[4]
    before = mamba2_ssd.launches
    got = mamba2_ssd(x, B, C, seg, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba2_ssd.launches == before + 1
    wants = [mamba2_ssd_chunked(x, B, C, seg, chunk=chunk)]
    if SSD_SWEEP.index(case) < SEQUENTIAL_CASES:
        wants.append(mamba2_ssd_ref(x, B, C, dA))
    for want in wants:
        _scaled_close_card(got, want)
    s_want = chunk_state_ref(x, B, seg, chunk=chunk)
    h_want = state_pass_ref(s_want, seg, chunk=chunk)
    if s_want.numel():
        _scaled_close_card(chunk_state(x, B, seg, chunk=chunk), s_want)
        _scaled_close_card(state_pass(s_want.clone(), seg, chunk=chunk),
                           h_want)
    _scaled_close_card(chunk_scan(x, B, C, seg, h_want, chunk=chunk),
                       chunk_scan_ref(x, B, C, seg, h_want, chunk=chunk))
    assert mamba2_ssd.launches == before + 1   # the passes alone count none


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LONG_ROWS + PAGED_SWEEP)
def test_paged_attention_split_merges_on_card(card, case, dtype):
    """Long rows at B 1 and 4 and the sweep: against
    ``paged_attention_ref`` (f32 2e-5, bf16 2e-2) and the split
    decomposition with the kernel's own split count; a row of length 0
    writes 0; a second call gives the same bits (the splits merge in a
    fixed order); one launch counted a call."""
    a = sweep_arrays(case, seed=8)
    args = [torch.from_numpy(a[n]).to(card) for n in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    args[:3] = [t.to(dtype) for t in args[:3]]
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    n_split, _ = split_count(case[0], case[2], case[5], case[4],
                             PAGED_TILE[dtype],
                             torch.cuda.get_device_properties(card)
                             .multi_processor_count)
    live = args[4] > 0
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for want in (paged_attention_ref(*args),
                 paged_attention_split_ref(*args, n_split)):
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   rtol=tol, atol=tol)
    assert not bool(got[~live].any())
    assert torch.equal(got, paged_attention(*args))


# the serving decode's fold of its in-flight token, at qwen3-0.6b's decode
# (q [32, 16, 128] over [8192, 16, 8, 128] bf16 pages) and qwen2-moe-a2.7b's
# (a KV group of 1: [8192, 16, 16, 128]); 136-page tables of 16
FOLD_HEADS = {"qwen3-0.6b": (16, 8), "qwen2-moe-a2.7b": (16, 16)}


def _fold_inputs(card, hq, hkv, seed, scores=None):
    """q, pages, tables, lengths, k_self and v_self at a serving decode
    shape: 32 rows of 1,100-2,100 positions but for a row of 0, one of 1,
    one on a page edge and one of the table's full width.  ``scores``
    "high": every pooled score at least 180 and the in-flight one 0 with
    v_self 0, so the in-flight partial weighs exactly 0."""
    b, d, page, pps, n_pool = 32, 128, 16, 136, 8192
    g = torch.Generator(device=card).manual_seed(seed)
    bf = dict(generator=g, device=card, dtype=torch.bfloat16)
    q = torch.randn(b, hq, d, **bf)
    kp = torch.randn(n_pool, page, hkv, d, **bf)
    vp = torch.randn(n_pool, page, hkv, d, **bf)
    ks = torch.randn(b, hkv, d, **bf)
    vs = torch.randn(b, hkv, d, **bf)
    if scores == "high":
        q.fill_(16.0)
        kp = 1.0 + torch.rand(n_pool, page, hkv, d, **bf)
        ks.zero_()
        vs.zero_()
    tables = torch.randint(0, n_pool, (b, pps), generator=g, device=card,
                           dtype=torch.int32)
    lens = torch.randint(1100, 2100, (b,), generator=g, device=card,
                         dtype=torch.int32)
    lens[:4] = torch.tensor([0, 1, 64 * page, pps * page])
    return q, kp, vp, tables, lens, ks, vs


def _forced_splits(monkeypatch, n_split):
    """Make the wrapper launch ``n_split`` splits (None: its own count)."""
    if n_split is not None:
        monkeypatch.setattr(paged_kernel, "split_count",
                            lambda b, hkv, pps, *a: (n_split,
                                                     -(-pps // n_split)))


@pytest.mark.parametrize("n_split", [None, 1, 17])
@pytest.mark.parametrize("model", sorted(FOLD_HEADS))
def test_paged_attention_self_fold_on_card(card, monkeypatch, model,
                                           n_split):
    """The kernel with the in-flight token against ``paged_attention_ref``
    with it, every element within 2^-6 |out| + 1e-4 max |out|, and against
    the split decomposition at the launch's split count; a row of length
    0 gives v_self exactly; the same bits from call to call; one launch
    and one fold counted a call."""
    hq, hkv = FOLD_HEADS[model]
    q, kp, vp, tables, lens, ks, vs = _fold_inputs(card, hq, hkv, seed=21)
    _forced_splits(monkeypatch, n_split)
    n = n_split or paged_kernel.split_count(
        32, hkv, 136, 16, PAGED_TILE[torch.bfloat16],
        torch.cuda.get_device_properties(card).multi_processor_count)[0]
    before = (paged_attention.launches, paged_attention.self_folds)
    got = paged_attention(q, kp, vp, tables, lens, k_self=ks, v_self=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.self_folds) == (
        before[0] + 1, before[1] + 1)
    for want in (paged_attention_ref(q, kp, vp, tables, lens, ks, vs),
                 paged_attention_split_ref(q, kp, vp, tables, lens, n, ks,
                                           vs)):
        want = want.float()
        lim = 2.0 ** -6 * want.abs() + 1e-4 * float(want.abs().max())
        assert bool(((got.float() - want).abs() <= lim).all())
    assert torch.equal(got[0], vs[0].repeat_interleave(hq // hkv, dim=0))
    assert torch.equal(got, paged_attention(q, kp, vp, tables, lens,
                                            k_self=ks, v_self=vs))


@pytest.mark.parametrize("n_split", [None, 1, 17])
@pytest.mark.parametrize("model", sorted(FOLD_HEADS))
def test_paged_attention_without_self_keeps_its_bits_on_card(
        card, monkeypatch, model, n_split):
    """Without the in-flight arguments the call is the merge of the pooled
    partials alone: its bits equal those of a fold whose in-flight partial
    weighs exactly 0 (score 0 against pooled scores of 180 and more,
    v_self 0), at one split and more, and no fold is counted."""
    hq, hkv = FOLD_HEADS[model]
    q, kp, vp, tables, lens, ks, vs = _fold_inputs(card, hq, hkv, seed=22,
                                                   scores="high")
    _forced_splits(monkeypatch, n_split)
    before = paged_attention.self_folds
    plain = paged_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert paged_attention.self_folds == before
    assert torch.equal(plain, paged_attention(q, kp, vp, tables, lens,
                                              k_self=ks, v_self=vs))
    assert not bool(plain[0].any())
    want = paged_attention_ref(q, kp, vp, tables, lens)[1:].float()
    lim = 2.0 ** -6 * want.abs() + 1e-4 * float(want.abs().max())
    assert bool(((plain[1:].float() - want).abs() <= lim).all())


def test_paged_attention_self_input_checks_on_card(card):
    """In-flight K/V the kernel does not take raise before any launch."""
    q, kp, vp, tables, lens, ks, vs = _fold_inputs(card, 16, 8, seed=23)
    before = paged_attention.launches
    bad = [
        dict(k_self=ks),                                   # v_self missing
        dict(k_self=ks[:, :4], v_self=vs[:, :4]),          # not [B, Hkv, D]
        dict(k_self=ks.float(), v_self=vs.float()),        # dtype differs
        dict(k_self=ks.cpu(), v_self=vs.cpu()),            # two devices
        dict(k_self=ks.transpose(0, 1).contiguous().transpose(0, 1),
             v_self=vs),                                   # not contiguous
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            paged_attention(q, kp, vp, tables, lens, **kw)
    assert paged_attention.launches == before


def _smoke_engine(device, params, capacity2, arch="qwen3_0_6b"):
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
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
    decode layer launches ``paged_attention`` with the in-flight token
    folded in and every prefill layer ``flash_attention``."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    counts = (paged_attention.launches, flash_attention.launches,
              paged_attention.self_folds)
    g = _smoke_engine(card, gpu, capacity2)
    torch.cuda.synchronize()
    c = _smoke_engine("cpu", cpu, capacity2)
    steps = 4            # 5 new tokens: one from prefill, 4 decode steps
    assert (paged_attention.launches - counts[0],
            flash_attention.launches - counts[1],
            paged_attention.self_folds - counts[2]) == (
        steps * cfg.n_layers, 6 * cfg.n_layers, steps * cfg.n_layers)
    assert sorted((r.rid, r.generated) for r in g[0].completed) == \
        sorted((r.rid, r.generated) for r in c[0].completed)
    sg, sc = g[2].summary(), c[2].summary()
    sg.pop("rebalance_seconds"), sc.pop("rebalance_seconds")
    assert sg == sc and g[1].stats == c[1].stats
    assert [(d.sizes.tolist(), d.policies) for d in g[3].history] == \
        [(d.sizes.tolist(), d.policies) for d in c[3].history]
    torch.testing.assert_close(g[1].k_pages.cpu(), c[1].k_pages,
                               rtol=1e-5, atol=1e-5)


# ---------------------- the RO token replays and the device window pipeline
def _ro_tape(seed, device, blocks=6, n_max=5000, levels=False):
    """A tape of tenant blocks under RO pressure (few addresses, mostly
    reads), links severed at the blocks, warm-L2 rows at the head of the
    two-level blocks, a one-row block, and each block's capacities
    (capacity 0 on some single-level blocks)."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(1, n_max, blocks)]
    lens[1] = 1
    addrs = [rng.integers(0, 40 + 20 * k, ln) for k, ln in enumerate(lens)]
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    tid = torch.as_tensor(np.repeat(np.arange(blocks), lens), device=device)
    prev, nxt, _, _ = segment_links(
        torch.as_tensor(np.concatenate(addrs), device=device), tid,
        torch.as_tensor(bounds[1:], device=device)[tid])
    m = int(bounds[-1])
    rd = torch.as_tensor(rng.random(m) < 0.8, device=device)
    force = torch.as_tensor(rng.random(m) < 0.3, device=device)
    c1 = [int(x) for x in rng.integers(1 if levels else 0, 24, blocks)]
    c2 = [int(x) for x in rng.integers(1, 24, blocks)]
    l2e = [min(int(x), ln) if levels else 0
           for x, ln in zip(rng.integers(0, 12, blocks), lens)]
    clean2 = [bool(k % 2) for k in range(blocks)]
    return (rd, prev, nxt, force), bounds, (c1, c2, l2e, clean2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ro_token_replay_kernels_match_plain_on_card(card, seed):
    """Both RO replay kernels against their plain versions, exactly: one
    launch each for all blocks, one-row blocks, capacity 0, warm L2 and a
    clean L2; a second call gives the same bits."""
    for levels in (False, True):
        tape, bounds, (c1, c2, l2e, cl) = _ro_tape(seed, card,
                                                   levels=levels)
        rd, prev, nxt, force = tape
        args = (rd, prev.to(torch.int32), nxt.to(torch.int32), force,
                bounds[:-1].tolist(), bounds[1:].tolist())
        cpu = tuple(x.cpu() for x in args[:4]) + args[4:]
        if levels:
            kern, caps = ro_token_replay_levels_scan, (c1, c2, l2e, cl)
            plain = ro_token_replay_levels_blocks_ref(
                *(x.cpu() for x in tape), *args[4:], *caps)
        else:
            kern, caps = ro_token_replay_scan, (c1,)
            plain = ro_token_replay_blocks_ref(
                *(x.cpu() for x in tape), *args[4:], *caps)
        before = kern.launches
        got = kern(*args, *caps)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g, w in zip(got, plain):
            assert torch.equal(g.cpu(), w)
        for g, w in zip(kern(*args, *caps), got):
            assert torch.equal(g, w)
        assert all(torch.equal(a.cpu(), b) for a, b in
                   zip(kern(*cpu[:4], *cpu[4:], *caps), plain))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_ro_token_replay_kernels_match_plain_on_edge_tapes(card, case):
    """Both RO replay kernels on the edge tapes of their design, every
    output equal to the plain host loops (and, block by block, to the
    pointer-walk plain versions) bit for bit, one launch a call, and the
    same bits from a second call."""
    for levels in (False, True):
        tape, starts, ends, caps = ro_edge_tape(case, levels, device=card)
        args = (tape[0], tape[1].to(torch.int32), tape[2].to(torch.int32),
                tape[3], starts, ends)
        host = tuple(x.cpu() for x in tape)
        if levels:
            kern = ro_token_replay_levels_scan
            plain = ro_token_replay_levels_blocks_ref(*host, starts, ends,
                                                      *caps)
        else:
            kern = ro_token_replay_scan
            plain = ro_token_replay_blocks_ref(*host, starts, ends, *caps)
        before = kern.launches
        got = kern(*args, *caps)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g, w in zip(got, plain):
            assert torch.equal(g.cpu(), w)
        for g, w in zip(kern(*args, *caps), got):
            assert torch.equal(g, w)
        o = 0
        for k, (s, e) in enumerate(zip(starts, ends)):
            blk = (host[0][s:e], host[1][s:e] - s, host[2][s:e] - s,
                   host[3][s:e])
            if levels:
                want = ro_token_replay_levels_pointer_ref(
                    *blk, *(c[k] for c in caps))
            else:
                want = ro_token_replay_pointer_ref(*blk, caps[0][k])
            assert torch.equal(got[0][o:o + e - s].cpu().long(), want[0])
            assert torch.equal(got[1][o:o + e - s].cpu(), want[1])
            o += e - s


def test_simulate_many_ro_pressure_on_card_matches_cpu(card):
    """RO tenants under pressure, one level and two, over warm windows:
    the card replays them with one kernel launch per kind a window and
    gives the CPU's results and states."""
    rng = np.random.default_rng(7)
    pols = ["ro", "ro", "wb", "ro", "ro"]
    caps1 = [12, 0, 30, 8, 20]
    caps2 = [0, 16, 0, 10, 30]
    devs = (card, torch.device("cpu"))
    side = [([LRUCache(c, dev) for c in caps1],
             [LRUCache(c, dev) for c in caps2]) for dev in devs]
    k1, k2 = ro_token_replay_scan, ro_token_replay_levels_scan
    before = (k1.launches, k2.launches)
    for _ in range(3):
        traces = [Trace(torch.as_tensor(rng.integers(0, 60, 3000)),
                        torch.as_tensor(rng.random(3000) < 0.8))
                  for _ in pols]
        res = [simulate_many(traces, policies=[WritePolicy(p) for p in pols],
                             caches=c1, caches2=c2, flush_cost=10.0,
                             t_fast2=4.0, device=dev)
               for dev, (c1, c2) in zip(devs, side)]
        assert res[0] == res[1]
    assert (k1.launches - before[0], k2.launches - before[1]) == (3, 3)
    (g1, g2), (c1, c2) = side
    for a, b in zip(g1 + g2, c1 + c2):
        assert all(torch.equal(x.cpu(), y)
                   for x, y in zip(a.state_arrays(), b.state_arrays()))


def _window_traces(seed, tenants, n_max, device="cpu"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(tenants):
        n = int(rng.integers(0, n_max)) if i % 7 else 0
        out.append(Trace(torch.as_tensor(rng.integers(0, 200, n),
                                         device=device),
                         torch.as_tensor(rng.random(n) < 0.7,
                                         device=device)))
    return out


def test_device_pipeline_card_matches_cpu_sanitized(card):
    """``DeviceWindowPipeline`` on the card under ``transfer_sanitizer``
    equals the same code on the CPU bit for bit (latency to rel 1e-12),
    with one sync a window; ``run_stream`` pays one sync a window with
    work and equals ``run``."""
    wins = [_window_traces(s, 40, 3000) for s in (1, 2)]
    wins.insert(1, [Trace(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.bool))] * 40)
    cap = 2500
    gpu = DeviceWindowPipeline(cap, c_min=20, transfer_sanitize=True,
                               device=card)
    cpu = DeviceWindowPipeline(cap, c_min=20, device="cpu")
    launches = cache_sim_segments_scan.launches
    prof = StageProfile()
    got = [gpu.run(w, profile=prof) for w in wins]
    assert cache_sim_segments_scan.launches > launches
    assert prof.syncs == 2 and prof.windows == 3
    want = [cpu.run(w) for w in wins]
    for g, w in zip(got, want):
        for f in ("sizes", "urd_sizes", "hit_ratios", "write_ratios"):
            assert torch.equal(getattr(g, f), getattr(w, f)), f
        for f in ("edges", "heights", "offsets"):
            assert torch.equal(getattr(g.curves, f), getattr(w.curves, f))
        assert g.feasible == w.feasible
        assert g.latency == pytest.approx(w.latency, rel=1e-12)
    sprof = StageProfile()
    stream = gpu.run_stream(wins, profile=sprof)
    assert sprof.syncs == 2 and sprof.windows == 3
    for a, b in zip(stream, got):
        assert torch.equal(a.sizes, b.sizes) and a.latency == b.latency


def test_transfer_sanitizer_raises_on_a_hidden_sync(card):
    x = torch.arange(10, device=card)
    with pytest.raises(RuntimeError):
        with transfer_sanitizer(True, card):
            x.sum().item()
    with pytest.raises(RuntimeError):
        with transfer_sanitizer(True, card):
            torch.repeat_interleave(x, x)
    assert torch.cuda.get_sync_debug_mode() == 0
    with transfer_sanitizer(False, card):
        assert x.sum().item() == 45


def test_device_monitor_and_walk_on_card_match_cpu(card):
    """``analyze_windows(pipeline="device")``, exact and sampled, and
    ``greedy_allocate(method="device")`` on the card equal the CPU's host
    pipeline and heap walk."""
    traces = _window_traces(5, 30, 4000)
    dtr = [Trace(t.addrs.to(card), t.is_read.to(card)) for t in traces]
    for kw in (dict(), dict(sample_rate=0.25, window_seed=3)):
        got = analyze_windows(dtr, "urd", pipeline="device", device=card,
                              **kw)
        want = analyze_windows(traces, "urd", device="cpu", **kw)
        for f in ("edges", "heights", "offsets", "n_accesses"):
            assert torch.equal(getattr(got.curves, f).cpu(),
                               getattr(want.curves, f))
        for f in ("urd_sizes", "write_ratios", "expected_errors"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    cap = int(int(want.urd_sizes.sum()) * 0.3)
    dev = greedy_allocate(got.curves, cap, 1.0, 20.0, c_min=10,
                          method="device")
    heap = greedy_allocate(want.curves, cap, 1.0, 20.0, c_min=10,
                           method="heap")
    assert dev.sizes.tolist() == heap.sizes.tolist()
    assert torch.equal(dev.hit_ratios, heap.hit_ratios)


def test_manager_device_pipeline_on_card_matches_host(card):
    names = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]
    kw = dict(c_min=10, initial_blocks=40, t_fast=1.0, t_slow=20.0,
              flush_cost=10.0)
    d = make_manager("eci", 400, names, device=card, pipeline="device", **kw)
    h = make_manager("eci", 400, names, device=card, **kw)
    for w in range(3):
        traces = [msr_trace(nm, 3000, seed=10 * w + i)
                  for i, nm in enumerate(names)]
        d.run_window(traces)
        h.run_window(traces)
        assert d.history[-1].sizes.tolist() == h.history[-1].sizes.tolist()
        assert d.history[-1].policies == h.history[-1].policies
    for a, b in zip(d.tenants, h.tenants):
        assert a.result == b.result
    assert d.summary() == h.summary()


def test_device_rung_stepdown_on_card_matches_cpu_host(card):
    """The degradation ladder on the card: a dead device rung at window 2
    steps down to the host rung (one ``device_stepdowns``), beside a tier
    loss, a straggler and a NaN curve; every decision, per-tenant count,
    LRU state (dirty bits included) and event equals the same plan's run
    on the CPU under ``pipeline="host"``, apart from that one step-down."""
    from repro_torch.core import DegradeEvent, FaultPlan, FaultSpec
    names = ["wdev_0", "hm_1", "prn_1", "web_0"]
    plan = FaultPlan((FaultSpec("tier_loss", window=1, level=1),
                      FaultSpec("pipeline", window=2, rung="device",
                                count=99),
                      FaultSpec("straggler", window=2, tenant=1),
                      FaultSpec("curve_nan", window=3, tenant=2)), seed=0)
    kw = dict(c_min=10, initial_blocks=40, t_fast=1.0, t_slow=20.0,
              flush_cost=10.0, faults=plan, demote_cooldown=1)
    g = make_manager("eci", 400, names, device=card, pipeline="device", **kw)
    c = make_manager("eci", 400, names, device="cpu", **kw)
    for w in range(4):
        traces = [msr_trace(nm, 3000, seed=10 * w + i)
                  for i, nm in enumerate(names)]
        g.run_window(traces)
        c.run_window(traces)
    for dg, dc in zip(g.history, c.history):
        assert dg.sizes.tolist() == dc.sizes.tolist()
        assert dg.policies == dc.policies and dg.feasible == dc.feasible
        assert (dg.quarantined, dg.degraded, dg.held, dg.deferred,
                dg.guard) == (dc.quarantined, dc.degraded, dc.held,
                              dc.deferred, dc.guard)
    for a, b in zip(g.tenants, c.tenants):
        assert a.result == b.result
        assert all(torch.equal(x.cpu(), y)
                   for x, y in zip(a.cache.state_arrays(),
                                   b.cache.state_arrays()))
    extra = [e for e in g.events
             if isinstance(e, DegradeEvent) and e.rung == "device"]
    assert [(e.window, e.reason) for e in extra] == [(2, "stepdown")]
    assert [e for e in g.events if e not in extra] == list(c.events)
    sg, sc = g.summary(), c.summary()
    assert (sg.pop("device_stepdowns"), sc.pop("device_stepdowns")) == (1, 0)
    assert sg.pop("degrade_events") == sc.pop("degrade_events") + 1
    assert sg == sc
    assert sc["dirty_loss"] > 0 and sc["guard_quarantines"] == 1


# ------------------------------------------------ the sharded pipeline
def _logical_mesh(device, k):
    from repro_torch.distributed import ShardMesh
    return ShardMesh((device,) * k)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_pipeline_card_matches_cpu_and_device(card, n_shards):
    """``DeviceWindowPipeline(mesh=)`` on ``n_shards`` logical shards of the
    card, under the sanitizer, equals the same mesh on the CPU and the
    card's single-device pipeline bit for bit (latency to rel 1e-12), one
    sync a window, every shard launching ``cache_sim_segments_scan`` once
    a width group; ``run_stream`` over the mesh equals ``run``."""
    from repro_torch.core.shard_pipeline import ingest_window_sharded
    wins = [_window_traces(s, 40, 3000) for s in (1, 2)]
    wins.insert(1, [Trace(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.bool))] * 40)
    cap = 2500
    mesh = _logical_mesh(card, n_shards)
    gpu = DeviceWindowPipeline(cap, c_min=20, transfer_sanitize=True,
                               mesh=mesh)
    cpu = DeviceWindowPipeline(cap, c_min=20,
                               mesh=_logical_mesh(torch.device("cpu"),
                                                  n_shards))
    one = DeviceWindowPipeline(cap, c_min=20, device=card)
    prof = StageProfile()
    got = []
    for w in wins:
        before = cache_sim_segments_scan.launches
        got.append(gpu.run(w, profile=prof))
        if sum(len(t) for t in w):
            lens = [len(t) for t in w]
            bounds = np.concatenate([[0], np.cumsum(lens)]).tolist()
            ing = ingest_window_sharded(
                torch.cat([t.addrs for t in w]),
                torch.cat([t.is_read for t in w]), bounds, lens, mesh=mesh)
            assert cache_sim_segments_scan.launches - before == \
                n_shards * len(ing.key[0])
    assert prof.syncs == 2 and prof.windows == 3
    for g, c, d in zip(got, [cpu.run(w) for w in wins],
                       [one.run(w) for w in wins]):
        for want in (c, d):
            for f in ("sizes", "urd_sizes", "hit_ratios", "write_ratios"):
                assert torch.equal(getattr(g, f), getattr(want, f)), f
            for f in ("edges", "heights", "offsets"):
                assert torch.equal(getattr(g.curves, f),
                                   getattr(want.curves, f))
            assert g.feasible == want.feasible
            assert g.latency == pytest.approx(want.latency, rel=1e-12)
    sprof = StageProfile()
    stream = gpu.run_stream(wins, profile=sprof)
    assert sprof.syncs == 2 and sprof.windows == 3
    for a, b in zip(stream, got):
        assert torch.equal(a.sizes, b.sizes) and a.latency == b.latency


def test_sharded_monitor_and_manager_on_card(card, monkeypatch):
    """``control_plane_mesh()`` is every visible card;
    ``analyze_windows(pipeline="sharded")`` over it, exact and sampled,
    equals the CPU's host pipeline; on a 2-shard logical mesh the manager
    under ``pipeline="sharded"`` decides as under ``pipeline="device"``,
    and a dead sharded rung steps down to the device rung once."""
    import repro_torch.core.shard_pipeline as sp
    from repro_torch.core import FaultPlan, FaultSpec
    from repro_torch.distributed import control_plane_mesh
    mesh = control_plane_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.devices)
    traces = _window_traces(5, 30, 4000)
    dtr = [Trace(t.addrs.to(card), t.is_read.to(card)) for t in traces]
    for kw in (dict(), dict(sample_rate=0.25, window_seed=3)):
        got = analyze_windows(dtr, "urd", pipeline="sharded", device=card,
                              **kw)
        want = analyze_windows(traces, "urd", device="cpu", **kw)
        for f in ("edges", "heights", "offsets", "n_accesses"):
            assert torch.equal(getattr(got.curves, f).cpu(),
                               getattr(want.curves, f))
        for f in ("urd_sizes", "write_ratios", "expected_errors"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    two = _logical_mesh(card, 2)
    monkeypatch.setattr(sp, "control_plane_mesh",
                        lambda n_shards=None, device=None: two)
    names = ["wdev_0", "hm_1", "prn_1", "web_0"]
    plan = FaultPlan((FaultSpec("pipeline", window=1, rung="sharded",
                                count=99),), seed=0)
    kw = dict(c_min=10, initial_blocks=40, t_fast=1.0, t_slow=20.0,
              flush_cost=10.0)
    s = make_manager("eci", 400, names, device=card, pipeline="sharded", **kw)
    f = make_manager("eci", 400, names, device=card, pipeline="sharded",
                     faults=plan, **kw)
    d = make_manager("eci", 400, names, device=card, pipeline="device", **kw)
    for w in range(3):
        traces = [msr_trace(nm, 3000, seed=10 * w + i)
                  for i, nm in enumerate(names)]
        for mgr in (s, f, d):
            mgr.run_window(traces)
        for mgr in (s, f):
            assert mgr.history[-1].sizes.tolist() == \
                d.history[-1].sizes.tolist()
            assert mgr.history[-1].policies == d.history[-1].policies
    for a, b in zip(s.tenants, d.tenants):
        assert a.result == b.result
    assert s.summary() == d.summary()
    sf = f.summary()
    assert sf["sharded_stepdowns"] == 1 and sf["device_stepdowns"] == 0


# -------------- the MoE, MLA and encoder-decoder families (ROADMAP §1 item 2)
def _within_element_limit(got, want):
    """Every element within 2^-6 |out| + 1e-4 max |out| of the plain
    version (ROADMAP's bound for bf16 attention at model inputs)."""
    w = want.float()
    limit = 2.0 ** -6 * w.abs() + 1e-4 * float(w.abs().max())
    assert got.shape == want.shape
    assert bool(((got.float() - w).abs() <= limit).all()), \
        float(((got.float() - w).abs() / limit).max())


def test_flash_attention_mla_instance_on_card(card):
    """MLA's heads (minicpm3-4b: 40 heads, q and k of nope 64 + rope 32, v
    64) in bfloat16 as the model hands them over: q and k concatenated,
    the k_rope head broadcast, v a view into the expanded latent; causal,
    a ragged length; the <6, 1> instance against ``attention_ref``."""
    gen = torch.Generator(device=card).manual_seed(96)
    b, s, h = 2, 700, 40
    q = torch.randn((b, s, h, 96), generator=gen, device=card).bfloat16()
    kv = torch.randn((b, s, h, 128), generator=gen,
                     device=card).bfloat16()
    rope = torch.randn((b, s, 1, 32), generator=gen, device=card).bfloat16()
    k = torch.cat([kv[..., :64], rope.expand(b, s, h, 32)], dim=-1)
    v = kv[..., 64:]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    before = flash_attention.launches
    got = flash_attention(qt, kt, vt, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (b, h, s, 64)
    _within_element_limit(got, attention_ref(qt, kt, vt, causal=True))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_cross_shapes_on_card(card, causal):
    """seamless-m4t's heads (16 of 64) in bfloat16: cross attention (Sq
    256 over Skv 1024, not causal) and, beside it, the same shapes causal
    (positions absolute from 0 on both axes), against ``attention_ref``."""
    gen = torch.Generator(device=card).manual_seed(64)
    q = torch.randn((2, 256, 16, 64), generator=gen, device=card).bfloat16()
    k = torch.randn((2, 1024, 16, 64), generator=gen,
                    device=card).bfloat16()
    v = torch.randn((2, 1024, 16, 64), generator=gen,
                    device=card).bfloat16()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention(qt, kt, vt, causal=causal)
    _within_element_limit(got, attention_ref(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_group_one_on_card(card, dtype):
    """qwen2-moe-a2.7b's decode heads (16 query heads over 16 KV heads of
    128, a group of 1) at its serving page of 16, rows of 1 to 2,000
    positions, against ``paged_attention_ref`` (2e-5 / 2e-2)."""
    case = (8, 16, 16, 128, 16, 128, 1024,
            (1, 15, 16, 17, 700, 1024, 2000, 2048))
    a = sweep_arrays(case, seed=5)
    args = [torch.from_numpy(a[n]).to(card) for n in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    args[:3] = [t.to(dtype) for t in args[:3]]
    got = paged_attention(*args)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(),
                               paged_attention_ref(*args).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "minicpm3_4b",
                                  "seamless_m4t_large_v2"])
def test_new_families_smoke_on_card_match_cpu(card, arch):
    """The smoke MoE, MLA and encoder-decoder configs (float32) through
    ``prefill`` and four ``decode_step``s on the card against the port's
    CPU run on the same parameters: prefill launches ``flash_attention``
    once a layer (three times a decoder layer of the encoder-decoder:
    encoder, self and cross), decode launches none; logits and caches
    within 1e-4."""
    import dataclasses
    from repro_torch.models.attention import cross_attention_kv
    from repro_torch.models.model import _encode, _layer
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    enc = None
    if cfg.n_enc_layers:
        enc = torch.from_numpy(rng.standard_normal(
            (2, 48, cfg.d_model)).astype(np.float32))
    before = flash_attention.launches
    got = prefill(gpu, cfg, toks.to(card),
                  enc_embeds=None if enc is None else enc.to(card))
    torch.cuda.synchronize()
    per_layer = 3 if cfg.n_enc_layers else 1
    assert flash_attention.launches - before == per_layer * cfg.n_layers
    want = prefill(cpu, cfg, toks, enc_embeds=enc)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    def cache(params, device):
        if enc is None:
            return init_decode_cache(cfg, 2, 8, device=device)
        c = init_decode_cache(cfg, 2, 8, device=device, enc_len=48)
        out = _encode(params, cfg, enc.to(device))
        for i in range(cfg.n_layers):
            c["cross_k"][i], c["cross_v"][i] = cross_attention_kv(
                _layer(params, i)["cross"], out, cfg)
        return c
    gc, cc = cache(gpu, card), cache(cpu, "cpu")
    before = flash_attention.launches
    for t in range(4):
        lg, gc = decode_step(gpu, cfg, toks[:, t].to(card), gc)
        lc, cc = decode_step(cpu, cfg, toks[:, t], cc)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name, t in gc["kv"].items():
        torch.testing.assert_close(t.cpu(), cc["kv"][name], rtol=1e-4,
                                   atol=1e-4)
    assert flash_attention.launches == before


def test_moe_smoke_engine_on_card_matches_cpu(card):
    """The serving engine on the smoke qwen2-moe config (float32) on the
    card against the port's CPU run on the same parameters: tokens,
    summaries, pool stats and decisions equal, pages within 1e-5; every
    decode layer launches ``paged_attention`` at a KV group of 1 and every
    prefill layer ``flash_attention``."""
    import dataclasses
    arch = "qwen2_moe_a2_7b"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    counts = (paged_attention.launches, flash_attention.launches)
    g = _smoke_engine(card, gpu, 0, arch)
    torch.cuda.synchronize()
    c = _smoke_engine("cpu", cpu, 0, arch)
    assert (paged_attention.launches - counts[0],
            flash_attention.launches - counts[1]) == (
        4 * cfg.n_layers, 6 * cfg.n_layers)
    assert sorted((r.rid, r.generated) for r in g[0].completed) == \
        sorted((r.rid, r.generated) for r in c[0].completed)
    sg, sc = g[2].summary(), c[2].summary()
    sg.pop("rebalance_seconds"), sc.pop("rebalance_seconds")
    assert sg == sc and g[1].stats == c[1].stats
    assert [(d.sizes.tolist(), d.policies) for d in g[3].history] == \
        [(d.sizes.tolist(), d.policies) for d in c[3].history]
    torch.testing.assert_close(g[1].k_pages.cpu(), c[1].k_pages,
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------ slice 16: training
def _train_imports():
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd_op
    return prefill_attention, mamba2_ssd_op


def _grads(fn, inputs, upstream):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, upstream)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_prefill_attention_gradients_on_card(card, case, dtype):
    """The differentiable wrapper on inputs that require grad: one
    ``flash_attention`` launch, the forward within the kernel tolerances
    of ``blockwise_attention`` (f32 2e-5, bf16 2e-2), its node
    ``FlashAttention``, and the gradients equal bit for bit to plain
    autograd of ``blockwise_attention`` given the same upstream gradient
    (the backward is that recompute)."""
    prefill_attention, _ = _train_imports()
    b, hq, hkv, sq, skv, d, dv, causal, window = case
    gen = torch.Generator(device=card).manual_seed(sq + d + 1)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, dv)))
    up = torch.randn((b, sq, hq, dv), generator=gen, device=card).to(dtype)
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    out, got = _grads(lambda *t: prefill_attention(*t, **kw), (q, k, v), up)
    assert flash_attention.launches == before + 1
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want_out, want = _grads(lambda *t: blockwise_attention(*t, **kw),
                            (q, k, v), up)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_mamba2_ssd_op_gradients_on_card(card, case):
    """``mamba2_ssd_op`` on inputs that require grad: one ``mamba2_ssd``
    launch, the forward within 3e-6 of the largest output of the chunked
    form, and the gradients of x, B, C and dA equal bit for bit to plain
    autograd of the chunked form (the backward is that recompute)."""
    _, mamba2_ssd_op = _train_imports()
    x, B, C, dA, _ = _ssd_card_inputs(case, card)
    chunk = case[4]
    up = torch.randn_like(x)
    before = mamba2_ssd.launches
    out, got = _grads(lambda *t: mamba2_ssd_op(*t, chunk=chunk),
                      (x, B, C, dA), up)
    assert mamba2_ssd.launches == before + 1
    want_out, want = _grads(lambda x_, b_, c_, a_: mamba2_ssd_chunked(
        x_, b_, c_, seg_from_dA(a_, chunk), chunk=chunk), (x, B, C, dA), up)
    _scaled_close_card(out.detach(), want_out.detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_raw_launchers_raise_on_inputs_that_require_grad(card):
    """Each float kernel's raw launcher refuses an input that requires
    grad while grad mode is on (it would return a detached output) and
    launches as before under ``torch.no_grad()``."""
    q = torch.randn(1, 2, 64, 32, device=card, requires_grad=True)
    x, B, C, dA, seg = _ssd_card_inputs((2, 64, 16, 8, 16, 1), card)
    x.requires_grad_(True)
    states = chunk_state_ref(x.detach(), B, seg, chunk=16).contiguous()
    pq = torch.randn(2, 4, 32, device=card, requires_grad=True)
    kp = torch.randn(8, 16, 2, 32, device=card)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=card)
    lens = torch.full((2,), 20, dtype=torch.int32, device=card)
    calls = [
        ("flash_attention", lambda: flash_attention(q, q, q)),
        ("mamba2_ssd", lambda: mamba2_ssd(x, B, C, seg, chunk=16)),
        ("chunk_state", lambda: chunk_state(x, B, seg, chunk=16)),
        ("state_pass", lambda: state_pass(states.clone().requires_grad_(),
                                          seg, chunk=16)),
        ("chunk_scan", lambda: chunk_scan(x, B, C, seg,
                                          states, chunk=16)),
        ("paged_attention", lambda: paged_attention(pq, kp, kp, tables,
                                                    lens))]
    for name, call in calls:
        with pytest.raises(RuntimeError, match="records no autograd node"):
            call()
        with torch.no_grad():
            out = call()
        assert out.grad_fn is None, name
    torch.cuda.synchronize()


def _step_grads(params, cfg, batch):
    """(loss, {path: gradient}) of ``loss_fn`` at ``params``."""
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_items, tree_unflatten
    paths, leaves = zip(*tree_items(params))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_fn(tree_unflatten(params, leaves), cfg, batch)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


class _Routes:
    """Wraps ``layers.moe_route`` and keeps each call's chosen experts and
    its tokens' routing margins (the k-th minus the (k+1)-th router logit
    over the largest |logit|)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.calls = layers, []

    def __enter__(self):
        self.saved = self.layers.moe_route

        def route(x, p, cfg):
            r = self.saved(x, p, cfg)
            logits = x.float() @ p["router"].float()
            top = logits.topk(cfg.top_k + 1, dim=-1).values
            gap = (top[..., -2] - top[..., -1]) / logits.abs().amax(-1)
            self.calls.append((r.idx.sort(-1).values.cpu(), gap.cpu()))
            return r
        self.layers.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.saved


@pytest.mark.parametrize("arch", ["chameleon_34b", "command_r_plus_104b",
                                  "deepseek_moe_16b", "h2o_danube_3_4b",
                                  "mamba2_780m", "minicpm3_4b",
                                  "qwen2_moe_a2_7b", "qwen3_0_6b",
                                  "seamless_m4t_large_v2", "zamba2_7b"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One train step of each arch's smoke config in float32 on the card
    against the port's CPU run from the same parameters and batch: the
    loss and every gradient leaf within 1e-4 (of its largest |g|), then
    ``make_train_step``'s loss, norm and new parameters within 1e-4.  The
    kernels launch: ``flash_attention`` once an attention block (the
    encoder-decoder's decoder blocks twice: self and cross), ``mamba2_ssd``
    once a Mamba-2 layer.  MoE routing follows ``chip_smoke.hold_routed``'s rule:
    the chosen experts must equal the CPU's at every call, unless the
    first difference lies at a near tie (margin <= 1e-4 of the token's
    largest |logit|), past which nothing is held."""
    import dataclasses
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_jax(_tree_numpy(cpu), "cuda")
    enc = cfg.d_model if cfg.n_enc_layers else None
    chunk = cfg.ssm_chunk if cfg.family.value in ("ssm", "hybrid") else 16
    host = SyntheticLM(cfg.vocab_size, max(chunk, 32), 2, seed=3,
                       enc_dim=enc, enc_len=24).batch_at(0)

    def on(dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    counts = (flash_attention.launches, mamba2_ssd.launches)
    with _Routes() as rg:
        lg, gg = _step_grads(gpu, cfg, on(card))
    torch.cuda.synchronize()
    launched = (flash_attention.launches - counts[0],
                mamba2_ssd.launches - counts[1])
    with _Routes() as rc:
        lc, gc = _step_grads(cpu, cfg, on("cpu"))
    fam = cfg.family.value
    want_fa = (0 if fam == "ssm" else hybrid_groups(cfg)[0]
               if fam == "hybrid" else cfg.n_enc_layers + 2 * cfg.n_layers
               if fam == "encdec" else cfg.n_layers)
    want_ssd = cfg.n_layers if fam in ("ssm", "hybrid") else 0
    assert launched == (want_fa, want_ssd)
    for (gi, _), (ci, cgap) in zip(rg.calls, rc.calls):
        diff = (gi != ci).any(-1)
        if bool(diff.any()):
            assert float(cgap[diff].max()) <= 1e-4, "routed apart off a tie"
            return                     # the rest is downstream of the flip
    assert float(lg) == pytest.approx(float(lc), rel=1e-4)
    for name, g in gg.items():
        w = gc[name]
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(
            w.abs().max()) + 1e-12, msg=name)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=50)
    sg, mg = make_train_step(cfg, opt)(init_train_state(gpu), host)
    sc, mc = make_train_step(cfg, opt)(init_train_state(cpu), host)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-4)
    for (name, a), (_, b) in zip(tree_items(sg["params"]),
                                 tree_items(sc["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                   msg=name)


def test_train_launcher_local_on_card(card, tmp_path):
    """``launch.train --local`` without ``--device``: on the card."""
    from repro_torch.launch import train as train_launcher
    before = flash_attention.launches
    out = train_launcher.main(["--arch", "qwen3_0_6b", "--local", "--steps",
                               "3", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and np.isfinite(out["final_loss"])
    cfg = get_smoke_config("qwen3_0_6b")
    assert flash_attention.launches - before == 3 * cfg.n_layers


# ------------------------------------------------- slice 17: distributed
def test_analyzer_counts_the_kernel_op_on_card_as_on_meta(card):
    """``analyze_step`` of a smoke prefill on the card (the kernels run,
    invisible to the dispatch mode) equals its count on meta, exactly."""
    from repro_torch.launch.cost_analysis import analyze_step
    from repro_torch.models import model as M
    for arch in ("qwen3_0_6b", "zamba2_7b"):
        cfg = get_smoke_config(arch)
        out = {}
        for dev in (card, torch.device("meta")):
            params = M.init_params(cfg, device=dev)
            toks = torch.zeros((2, 64), dtype=torch.int64, device=dev)
            out[dev.type] = analyze_step(M.prefill, params, cfg, toks)
        assert out["cuda"].flops == out["meta"].flops > 0, arch
        assert out["cuda"].while_trip_counts == \
            out["meta"].while_trip_counts, arch


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "zamba2_7b"])
def test_analyzer_counts_a_train_step_on_card_as_on_meta(card, arch):
    """``analyze_step`` of a smoke train step on the card (the forward
    kernels run inside their autograd Functions, the backwards recompute
    the plain versions) equals its count on meta, exactly: each backward
    is counted by its formula."""
    import dataclasses
    from repro_torch.launch.cost_analysis import analyze_step
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    out = {}
    for dev in (card, torch.device("meta")):
        state = init_train_state(M.init_params(cfg, device=dev))
        toks = torch.zeros((2, 64), dtype=torch.int32, device=dev)
        out[dev.type] = analyze_step(make_train_step(cfg, AdamWConfig()),
                                     state, {"tokens": toks, "labels": toks})
    assert out["cuda"].flops == out["meta"].flops > 0, arch
    assert out["cuda"].while_trip_counts == out["meta"].while_trip_counts
    assert any(k.endswith(".backward") for k in out["cuda"].while_trip_counts)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "minicpm3_4b",
                                  "zamba2_7b", "seamless_m4t_large_v2"])
def test_split_kv_decode_on_card(card, arch):
    """``decode_step(commit=False)`` on the card against the card's
    ``commit=True`` and the CPU's ``commit=False``, in fp32; the frozen
    cache untouched."""
    import dataclasses
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = M.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cache = M.init_decode_cache(cfg, 3, 40, "cpu", enc_len=8)
    for name in ("kv", "cross_k", "cross_v"):
        for t in (cache[name].values() if name == "kv" else
                  [cache[name]] if name in cache else []):
            t.copy_(torch.randn(t.shape, generator=gen))
    cache["len"].copy_(torch.tensor([30, 7, 1], dtype=torch.int32))
    toks = torch.tensor([5, 9, 11])
    on = (lambda tree: {k: on(v) for k, v in tree.items()}
          if isinstance(tree, dict) else tree.to(card, copy=True))
    gc = on(cache)
    kv_before = {k: t.clone() for k, t in gc.get("kv", {}).items()}
    lf, split = M.decode_step(on(params), cfg, toks.to(card), gc,
                              commit=False)
    for k, t in kv_before.items():
        assert torch.equal(gc["kv"][k], t), k
    lt, _ = M.decode_step(on(params), cfg, toks.to(card), on(cache))
    lc, split_c = M.decode_step(params, cfg, toks, cache, commit=False)
    v = cfg.vocab_size
    scale = float(lc[:, :v].abs().max())
    assert float((lf.cpu() - lc)[:, :v].abs().max()) <= 1e-4 * scale
    assert float((lf - lt)[:, :v].abs().max()) <= 1e-5 * scale
    for k, d in split_c.get("kv", {}).items():
        torch.testing.assert_close(split["kv"][k].cpu(), d, rtol=0,
                                   atol=1e-4 * float(d.abs().max()))


def test_pipeline_and_sharded_step_on_card(card):
    """``pipeline_forward`` over 2 logical shards of the card against the
    sequential forward, and the sharded train step on a logical 2 x 2 mesh
    against the single-device step (the reference's tolerances)."""
    import dataclasses
    from repro_torch.tree import tree_items
    from repro_torch.distributed.pipeline import pipeline_forward, stack_stages
    from repro_torch.distributed.sharding import (Mesh, gather, param_specs,
                                                  place, state_specs)
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    params = M.init_params(cfg, device=card)

    def stage(p_stage, h):
        for i in range(p_stage["ln1"].shape[0]):
            h = M._attn_mlp_block(M._layer({"layers": p_stage}, i), h, cfg)
        return h
    x = params["embed"][torch.randint(0, cfg.vocab_size, (4, 64),
                                      device=card)]
    with torch.no_grad():
        got = pipeline_forward(stage, stack_stages(params["layers"], 2), x,
                               mesh=Mesh.of(card, (2,), ("pod",)),
                               n_microbatches=2)
        want = stage(params["layers"], x)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    state = init_train_state(params)
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch_at(0)
    opt = AdamWConfig(lr_peak=1e-3)
    s1, m1 = make_train_step(cfg, opt)(state, batch)
    mesh = Mesh.of(card, (2, 2), ("data", "model"))
    s2, m2 = make_train_step(cfg, opt, grad_shardings=param_specs(
        params, mesh))(place(state, state_specs(state, mesh)), batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=2e-4)
    for (name, a), (_, b) in zip(tree_items(s1["params"]),
                                 tree_items(gather(s2["params"]))):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-4, msg=name)
