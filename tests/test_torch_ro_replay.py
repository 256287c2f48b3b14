"""The RO eviction-token replays (``repro_torch.kernels.ro_replay``).

The plain versions ``ro_token_replay_ref`` and
``ro_token_replay_levels_ref`` are held exactly to the reference's host
loops ``_ro_token_replay`` and ``_ro_token_replay_levels`` on randomized
RO-pressure blocks (the pattern of ``tests/test_two_level.py``'s device
replay test) and at the edges: blocks of one row, capacity 0 (every
install evicts), warm-L2 rows below ``l2_end``, a clean L2 and all
writes.  The multi-block functions the CUDA kernels compute
(``ro_token_replay_scan``, ``ro_token_replay_levels_scan``, which on
CPU tensors return ``ro_token_replay_blocks_ref`` and
``ro_token_replay_levels_blocks_ref``) are held to the per-block loops
on tapes of several blocks with global, severed links.  The kernels
themselves are held to these on the card in ``tests/test_torch_gpu.py``.

The pointer-walk plain versions (``ro_token_replay_pointer_ref``,
``ro_token_replay_levels_pointer_ref``: the kernels' formulation, a walk
that never reads ``death``, ``lvl`` or ``dirty`` and the dirty bits by
pointer jumping after it) are held exactly to the reference's loops on a
seeded sweep, at the same edges, on a hot key whose read-hit chain spans
the whole block, and on small copies of the kernels' edge tapes
(``ref.EDGE_CASES``).
"""
import numpy as np
import pytest
import torch

from repro.core.batch_sim import _ro_token_replay as replay_host
from repro.core.batch_sim import _ro_token_replay_levels as levels_host
from repro.core.trace import prev_next_occurrence as links_ref
from repro_torch.kernels.ro_replay.kernel import (ro_token_replay_levels_scan,
                                                  ro_token_replay_scan)
from repro_torch.kernels.ro_replay.ops import (ro_token_replays,
                                               ro_token_replays_levels)
from repro_torch.kernels.ro_replay.ref import (
    EDGE_CASES, ro_edge_tape, ro_token_replay_blocks_ref,
    ro_token_replay_levels_blocks_ref, ro_token_replay_levels_pointer_ref,
    ro_token_replay_levels_ref, ro_token_replay_pointer_ref,
    ro_token_replay_ref)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _block(rng, n, max_addr, read_p=0.7, n_l2=0, n_l1=0):
    """One tenant block: warm L2 then warm L1 pseudo-reads (distinct
    addresses, every other one dirty), then n window accesses."""
    body = rng.integers(0, max_addr, n)
    addrs = np.concatenate([np.arange(100, 100 + n_l2 + n_l1), body])
    rd = np.concatenate([np.ones(n_l2 + n_l1, bool), rng.random(n) < read_p])
    prev, nxt = links_ref(addrs)
    nxt = np.minimum(nxt, addrs.size)
    force = np.zeros(addrs.size, bool)
    force[:n_l2 + n_l1] = np.arange(n_l2 + n_l1) % 2 == 0
    force[n_l2 + n_l1::3] = True
    return rd, prev, nxt, force


def _same_single(rd, prev, nxt, force, cap, plain=ro_token_replay_ref):
    want = replay_host(rd, prev, nxt, force, cap)
    got = plain(_t(rd), _t(prev), _t(nxt), _t(force), cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[2] == want[2]
    return got


def _same_levels(rd, prev, nxt, force, c1, c2, l2_end, clean2,
                 plain=ro_token_replay_levels_ref):
    want = levels_host(rd, prev, nxt, force, c1, c2, l2_end, clean2)
    got = plain(_t(rd), _t(prev), _t(nxt), _t(force), c1, c2, l2_end,
                clean2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[2].dtype == torch.int8
    assert got[3:] == tuple(want[3:])
    return got


# ------------------------------------------ plain versions == reference
@pytest.mark.parametrize("cap", [0, 1, 2, 3, 4])
def test_ro_token_replay_ref_matches_reference(cap):
    rng = np.random.default_rng(cap)
    evicted = 0
    for _ in range(40):
        blk = _block(rng, int(rng.integers(1, 81)), 5)
        death = _same_single(*blk, cap)[0]
        evicted += int((death != _t(blk[2])).sum())
    assert evicted > 0                       # pressure: tokens were evicted


@pytest.mark.parametrize("clean2", [False, True])
@pytest.mark.parametrize("cap1", [0, 1, 2, 4])
def test_ro_token_replay_levels_ref_matches_reference(cap1, clean2):
    rng = np.random.default_rng(10 * cap1 + clean2)
    demoted = 0
    for _ in range(40):
        c2 = int(rng.integers(1, 5))
        n_l2 = min(int(rng.integers(0, 4)), c2)
        n_l1 = min(int(rng.integers(0, 4)), cap1)
        blk = _block(rng, int(rng.integers(1, 81)), 5, n_l2=n_l2, n_l1=n_l1)
        demoted += _same_levels(*blk, cap1, c2, n_l2, clean2)[4]
    assert demoted > 0


def test_ro_token_replays_at_the_edges():
    """One-row blocks (a read, a write), all writes, all reads of one
    address, and a block that is warm L2 only."""
    one_r = (np.array([True]), np.array([-1]), np.array([1]),
             np.array([True]))
    one_w = (np.array([False]), np.array([-1]), np.array([1]),
             np.array([False]))
    writes = (np.zeros(6, bool), *links_ref(np.arange(6) % 2),
              np.zeros(6, bool))
    writes = (writes[0], writes[1], np.minimum(writes[2], 6), writes[3])
    same = (np.ones(5, bool), *links_ref(np.zeros(5, np.int64)),
            np.ones(5, bool))
    same = (same[0], same[1], np.minimum(same[2], 5), same[3])
    for blk in (one_r, one_w, writes, same):
        for cap in (0, 1, 2):
            _same_single(*blk, cap)
        for c1, c2, clean2 in ((0, 1, False), (1, 1, True), (2, 1, False)):
            _same_levels(*blk, c1, c2, 0, clean2)
    warm = _block(np.random.default_rng(3), 0, 5, n_l2=3)
    _same_levels(*warm, 1, 3, 3, True)
    _same_levels(*warm, 2, 3, 2, False)       # l2_end inside the prefix


# ------------------------- the pointer-walk plain versions == reference
def _sweep_block(rng):
    """A random block: 1-300 rows over 1-40 addresses, a hot key on some,
    a read share anywhere in 0.3-1."""
    n = int(rng.integers(1, 301))
    addrs = rng.integers(0, int(rng.integers(1, 41)), n)
    if rng.random() < 0.3:
        addrs[rng.random(n) < 0.5] = -1       # a hot key
    rd = rng.random(n) < rng.uniform(0.3, 1.0)
    prev, nxt = links_ref(addrs)
    return rd, prev, np.minimum(nxt, n), rng.random(n) < 0.4


@pytest.mark.parametrize("seed", range(8))
def test_ro_token_replay_pointer_ref_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    evicted = 0
    for _ in range(60):
        blk = _sweep_block(rng)
        death = _same_single(*blk, int(rng.integers(0, 12)),
                             plain=ro_token_replay_pointer_ref)[0]
        evicted += int((death != _t(blk[2])).sum())
    assert evicted > 0


@pytest.mark.parametrize("seed", range(8))
def test_ro_token_replay_levels_pointer_ref_matches_reference(seed):
    """Any capacities (0 too), warm-L2 prefixes of any length (some of
    them not reads), a clean L2 on every other block."""
    rng = np.random.default_rng(200 + seed)
    demoted = evicted = 0
    for k in range(60):
        blk = _sweep_block(rng)
        c1, c2 = (int(x) for x in rng.integers(0, 10, 2))
        l2_end = int(rng.integers(0, min(blk[0].size, 12) + 1))
        got = _same_levels(*blk, c1, c2, l2_end, bool(k % 2),
                           plain=ro_token_replay_levels_pointer_ref)
        demoted += got[4]
        evicted += int((got[0] != _t(blk[2])).sum())
    assert demoted > 0 and evicted > 0


def test_ro_pointer_refs_at_the_edges():
    """One-row blocks, all writes, all reads of one address, capacity 0
    (cap1 0 too), a warm-L2-only block, and a hot key read every other
    row, whose read-hit chain spans the block (pointer jumping's longest
    case)."""
    one_r = (np.array([True]), np.array([-1]), np.array([1]),
             np.array([True]))
    one_w = (np.array([False]), np.array([-1]), np.array([1]),
             np.array([False]))
    writes = (np.zeros(6, bool), *links_ref(np.arange(6) % 2),
              np.zeros(6, bool))
    writes = (writes[0], writes[1], np.minimum(writes[2], 6), writes[3])
    same = (np.ones(5, bool), *links_ref(np.zeros(5, np.int64)),
            np.ones(5, bool))
    same = (same[0], same[1], np.minimum(same[2], 5), same[3])
    rng = np.random.default_rng(5)
    addrs = rng.integers(1, 300, 3000)
    addrs[::2] = 0
    rd = rng.random(3000) < 0.8
    rd[::2] = True
    hot = (rd, *links_ref(addrs), np.arange(3000) % 7 == 0)
    hot = (hot[0], hot[1], np.minimum(hot[2], 3000), hot[3])
    for blk in (one_r, one_w, writes, same, hot):
        for cap in (0, 1, 2, 40):
            _same_single(*blk, cap, plain=ro_token_replay_pointer_ref)
        for c1, c2, clean2 in ((0, 0, True), (0, 1, False), (1, 1, True),
                               (2, 1, False), (20, 30, True)):
            _same_levels(*blk, c1, c2, 0, clean2,
                         plain=ro_token_replay_levels_pointer_ref)
    for clean2 in (False, True):
        _same_levels(*hot, 10, 40, 30, clean2,
                     plain=ro_token_replay_levels_pointer_ref)
    warm = _block(np.random.default_rng(3), 0, 5, n_l2=3)
    _same_levels(*warm, 1, 3, 3, True,
                 plain=ro_token_replay_levels_pointer_ref)
    _same_levels(*warm, 0, 3, 2, False,
                 plain=ro_token_replay_levels_pointer_ref)


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_ro_pointer_refs_on_edge_tapes(case, levels):
    """Small copies (lengths and capacities / 16) of the tapes that hold
    the kernels to their plain versions on the card: every block of the
    pointer walk equals the reference's loop."""
    tape, starts, ends, caps = ro_edge_tape(case, levels, scale=16)
    rd, prev, nxt, force = (x.numpy() for x in tape)
    for k, (s, e) in enumerate(zip(starts, ends)):
        blk = (rd[s:e], np.where(prev[s:e] >= 0, prev[s:e] - s, -1),
               nxt[s:e] - s, force[s:e])
        if levels:
            _same_levels(*blk, *(c[k] for c in caps),
                         plain=ro_token_replay_levels_pointer_ref)
        else:
            _same_single(*blk, caps[0][k], plain=ro_token_replay_pointer_ref)


# ------------------------------ the kernels' function on multi-block tapes
def _tape(seed, blocks, levels=False):
    """A tape of several tenant blocks with global links severed at the
    blocks (nxt clamped to the block end), an unpressured gap block
    between, and each block's capacities."""
    rng = np.random.default_rng(seed)
    parts, spans, caps = [], [], []
    off = 0
    for k in range(blocks):
        c1 = int(rng.integers(1 if levels else 0, 4))
        c2 = int(rng.integers(1, 4))
        n_l2 = min(int(rng.integers(0, 3)), c2) if levels else 0
        n = int(rng.integers(1, 90)) if k != 1 else 1
        rd, prev, nxt, force = _block(rng, n, 6, n_l2=n_l2)
        gap = int(rng.integers(0, 4))
        if gap:                               # a block no replay covers
            parts.append((np.ones(gap, bool), np.full(gap, -1),
                          np.arange(1, gap + 1) + off, np.zeros(gap, bool)))
            off += gap
        m = rd.size
        parts.append((rd, np.where(prev >= 0, prev + off, -1), nxt + off,
                      force))
        spans.append((off, off + m))
        caps.append((c1, c2, n_l2, bool(k % 2)))
        off += m
    rd, prev, nxt, force = (np.concatenate(x) for x in zip(*parts))
    return (_t(rd), _t(prev), _t(nxt), _t(force)), spans, caps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ro_token_replay_scan_matches_per_block_loops(seed):
    """``ro_token_replay_scan`` (its plain version here) over several
    blocks gives each block's loop, blocks laid out one after another;
    ``ro_token_replays`` splits them per block."""
    tape, spans, caps = _tape(seed, 5)
    starts, ends = [s for s, _ in spans], [e for _, e in spans]
    cap = [c[0] for c in caps]
    rd, prev, nxt, force = tape
    death, dirty, flushes = ro_token_replay_scan(
        rd, prev.to(torch.int32), nxt.to(torch.int32), force, starts, ends,
        cap)
    assert death.dtype == torch.int32 and flushes.dtype == torch.int64
    plain = ro_token_replay_blocks_ref(*tape, starts, ends, cap)
    for g, w in zip((death, dirty, flushes), plain):
        assert torch.equal(g, w)
    per = ro_token_replays(*tape, starts, ends, cap)
    o = 0
    for (s, e), c, (d, y, f) in zip(spans, cap, per):
        want = replay_host(rd[s:e].numpy(), (prev[s:e] - s).numpy(),
                           (nxt[s:e] - s).numpy(), force[s:e].numpy(), c)
        np.testing.assert_array_equal(d.numpy(), want[0])
        np.testing.assert_array_equal(death[o:o + e - s].numpy(), want[0])
        np.testing.assert_array_equal(y.numpy(), want[1])
        assert f == want[2]
        o += e - s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ro_token_replay_levels_scan_matches_per_block_loops(seed):
    tape, spans, caps = _tape(10 + seed, 5, levels=True)
    starts, ends = [s for s, _ in spans], [e for _, e in spans]
    c1, c2, l2e, cl = (list(x) for x in zip(*caps))
    rd, prev, nxt, force = tape
    out = ro_token_replay_levels_scan(
        rd, prev.to(torch.int32), nxt.to(torch.int32), force, starts, ends,
        c1, c2, l2e, cl)
    plain = ro_token_replay_levels_blocks_ref(*tape, starts, ends, c1, c2,
                                              l2e, cl)
    for g, w in zip(out, plain):
        assert torch.equal(g, w)
    k = len(spans)
    per = ro_token_replays_levels(*tape, starts, ends, c1, c2, l2e, cl)
    for j, ((s, e), (d, y, lv, f, m)) in enumerate(zip(spans, per)):
        want = levels_host(rd[s:e].numpy(), (prev[s:e] - s).numpy(),
                           (nxt[s:e] - s).numpy(), force[s:e].numpy(),
                           c1[j], c2[j], l2e[j], cl[j])
        for g, w in zip((d, y, lv), want[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert (f, m) == tuple(want[3:])
        assert (int(out[3][j]), int(out[3][k + j])) == (f, m)


def test_ro_token_replay_scan_checks_and_empty():
    tape, spans, caps = _tape(5, 2)
    rd, prev, nxt, force = tape
    p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
    death, dirty, fl = ro_token_replay_scan(rd, p32, n32, force, [], [], [])
    assert death.numel() == 0 and fl.numel() == 0
    with pytest.raises(ValueError, match="outside"):
        ro_token_replay_scan(rd, p32, n32, force, [0], [rd.numel() + 1], [1])
    with pytest.raises(ValueError, match="one length"):
        ro_token_replay_levels_scan(rd[:-1], p32, n32, force, [0], [1], [1],
                                    [1], [0], [False])
