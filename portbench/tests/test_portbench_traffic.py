"""The traffic generator: the same seed draws the same traffic, and every
seed serves the same multiset of sizes."""
import collections

import numpy as np

from portbench import traffic as tf
from portbench.tests.tiny import MIX


def _draw(seed, n, mix=MIX):
    t = tf.Traffic(mix, seed, vocab=500)
    return [t.next() for _ in range(n)]


def test_same_seed_same_traffic():
    a, b = _draw(2**40 + 7, 60), _draw(2**40 + 7, 60)
    for (sa, pa, oa), (sb, pb, ob) in zip(a, b):
        assert sa == sb and oa == ob
        np.testing.assert_array_equal(pa, pb)


def test_seeds_share_the_deck_in_another_order():
    n = MIX["deck"]
    a, b = _draw(1, n), _draw(2**31 + 5, n)
    sizes = [collections.Counter((s.tenant, len(p), o) for s, p, o in x)
             for x in (a, b)]
    assert sizes[0] == sizes[1]
    assert [s for s, _, _ in a] != [s for s, _, _ in b]
    assert not np.array_equal(a[0][1][:8], b[0][1][:8])


def test_deck_holds_the_laws_and_shares():
    blocks = tf.deck(MIX)
    assert sum(map(len, blocks)) == MIX["deck"]
    for t in MIX["tenants"]:
        for blk in blocks:
            mine = [d for d in blk if d.tenant == t["name"]]
            assert len(mine) == round(t["share"] * MIX["block"])
            assert all(t["prompt"]["low"] <= d.unique <= t["prompt"]["high"]
                       and t["output"]["low"] <= d.output
                       <= t["output"]["high"] for d in mine)


def test_whole_blocks_serve_the_same_sizes_whatever_the_seed():
    """Every block holds each tenant's lengths across the whole law, so a
    window's requests hold nearly the same sizes from any seed."""
    n = 3 * MIX["block"]
    sums = {sum(len(p) + o for _, p, o in _draw(seed, n))
            for seed in (1, 2, 3, 2**32 + 1)}
    per_block = [sum(d.unique + d.output for d in blk)
                 for blk in tf.deck(MIX)]
    assert max(sums) - min(sums) <= 3 * (max(per_block) - min(per_block))
    assert max(per_block) - min(per_block) < 0.2 * min(per_block)


def test_quantile_lengths_log_uniform_median():
    x = tf.quantile_lengths({"dist": "log_uniform", "low": 64, "high": 512},
                            1001)
    assert x[0] == 64 and x[-1] == 511 and x[500] == round(64 * 8 ** 0.5)


def test_system_prompts_shared_or_own():
    shared = dict(MIX, tenants=[dict(MIX["tenants"][0], system_prompts=2),
                                MIX["tenants"][1]])
    chat = [p for s, p, _ in _draw(3, 40, shared) if s.tenant == "chat"]
    heads = {p[:32].tobytes() for p in chat}
    assert len(heads) == 2
    own = [p for s, p, _ in _draw(3, 40) if s.tenant == "chat"]
    assert len({p[:32].tobytes() for p in own}) == len(own)
    spec = [s for s, _, _ in _draw(3, 40) if s.tenant == "chat"]
    assert all(len(p) == 32 + s.unique for s, p in zip(spec, own))
