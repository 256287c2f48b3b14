"""The frozen work formulas give the counts PERF.md records for the
kernels (the kernel table's bounds), and the ``gqa`` family's model FLOPs
count the active parameters."""
import json

import numpy as np
import pytest

from portbench import work
from portbench.families import gqa
from portbench.tests.tiny import REPO


def _cfg(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _b32_batch(page=16, pages_per_seq=136, positions=65472):
    """32 rows of distinct pages, lengths summing to ``positions``."""
    lens = np.full(32, positions // 32)
    lens[: positions % 32] += 1
    pages = [np.arange(i * pages_per_seq, (i + 1) * pages_per_seq)
             for i in range(32)]
    return pages, lens


@pytest.mark.parametrize("name, hkv, mb", [("qwen3-0.6b", 8, 268.5),
                                           ("qwen2-moe-a2.7b", 16, 536.6)])
def test_paged_attention_bytes_at_the_serving_decode(name, hkv, mb):
    pages, lens = _b32_batch()
    seen = work.paged_positions(pages, lens, 16)
    assert seen == 65472
    flops, nbytes = work.paged_attention_work(seen, 32, 136, 16, hkv, 128)
    assert round(nbytes / 1e6, 1) == mb
    assert flops == 4 * 128 * 16 * 65472


def test_shared_pages_are_read_once():
    a = np.array([5, 6, 7])
    pages, lens = [a, a], np.array([40, 20])
    assert work.paged_positions(pages, lens, 16) == 40
    assert work.paged_positions([a, np.array([8, 9])], lens, 16) == 60


def test_causal_flash_attention_flops():
    flops, nbytes = work.flash_attention_work(2048, 16, 16, 128)
    assert round(flops / 1e9, 1) == 17.2
    assert nbytes == 4 * 2048 * 16 * 128 * 2
    assert work.causal_pairs(3) == 6


def test_bound_is_the_longer_of_the_two():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_count_active_parameters():
    moe, dense = _cfg("qwen2-moe-a2.7b"), _cfg("qwen3-0.6b")
    # qwen2-moe: 2 x (attention 16.8 M + 4 experts 34.6 M + shared 34.6 M
    # + router 0.12 M) x 24 layers a token, and the head once
    per_tok = 2 * 24 * (4 * 2048 * 2048 + 3 * 2048 * 1408 * 4
                        + 3 * 2048 * 5632 + 2048 * 60)
    head = 2 * 2048 * 151936
    assert gqa.model_flops(moe, [], [0]) == pytest.approx(
        per_tok + head + 24 * 4 * 128 * 16)
    one = gqa.model_flops(dense, [1], [])
    assert one == pytest.approx(
        2 * 28 * (2 * 1024 * 2048 + 2 * 1024 * 1024 + 3 * 1024 * 3072)
        + 28 * 4 * 128 * 16 + 2 * 1024 * 151936)
