"""The ``gqa`` family and its reference give, bit for bit, what the code
they were moved from gave: the weights' bytes, each kernel's least time
in a prefill and a decode step, the model's FLOPs, the pool's layout and
the reference's logits (fp32 and the bf16 and fp8 controls), at the tiny
dense and MoE configurations and at both configuration files' shapes cut
to 2 layers.

How ``gqa_pinned.json`` was produced: before the family modules existed
(commit 5b66a69), the same quantities over the same inputs as below were
computed on an x86-64 CPU with PyTorch 2.13 for the CPU, in one thread,
by the code of that commit: ``weights.make_params``; the bounds by the
expressions of the driver's ``_TimedEngine`` (``ModelConfig.n_layers x
work.bound_s(...)`` with the heads of the driver's ``model_config``);
``work.model_flops``; the pool's (``n_layers``, ``n_kv_heads``,
``head_dim``); ``reference/model.py``'s ``served_logits``.  A product's
bits depend on the number of threads, so the test runs in one."""
import hashlib
import json

import numpy as np
import pytest
import torch

from portbench.families import gqa
from portbench.reference.gqa import served_logits
from portbench.tests import tiny

PINNED = json.loads((tiny.REPO / "portbench" / "tests" / "gqa_pinned.json")
                    .read_text())
SEED = 2**40 + 35
PAGE, PAGES_PER_SEQ = 16, 136
PADDED = (16, 1040, 2048)
PROMPTS, CONTEXTS = [13, 1100, 2048], [0, 17, 1500, 2100]
REQUESTS = ((13, 5), (37, 4))          # (prompt tokens, served tokens)


def _two_layers(name: str) -> dict:
    cfg = json.loads((tiny.REPO / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    return dict(cfg, num_hidden_layers=2)


CONFIGS = {"tiny-dense": lambda: tiny.DENSE, "tiny-moe": lambda: tiny.MOE,
           "qwen3-0.6b": lambda: _two_layers("qwen3-0.6b"),
           "qwen2-moe-a2.7b": lambda: _two_layers("qwen2-moe-a2.7b")}
# the controls' paths are held at the other three; at the MoE's real
# widths they take most of a minute on the CPU
PRECISIONS = {"qwen2-moe-a2.7b": ("fp32",)}

BATCHES = {
    "distinct": ([np.arange(i * 8, i * 8 + 8) for i in range(3)],
                 np.array([17, 100, 128])),
    "shared": ([np.array([5, 6, 7]), np.array([5, 6, 9]), np.array([5, 11])],
               np.array([40, 20, 30])),
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def _requests(cfg: dict) -> list:
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg["vocab_size"], s).astype(np.int32),
             rng.integers(0, cfg["vocab_size"], n).tolist())
            for s, n in REQUESTS]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gqa_family_gives_the_pinned_values(name, one_thread):
    cfg, want = CONFIGS[name](), PINNED[name]
    params = gqa.make_params(cfg, SEED, "cpu")
    assert _digest(_leaves(params)) == want["weights"]
    assert {str(p): gqa.prefill_bound_s(cfg, p) for p in PADDED} == {
        p: {"flash_attention": s} for p, s in want["prefill"].items()}
    assert {k: gqa.decode_bound_s(cfg, pages, lens, PAGE, PAGES_PER_SEQ)
            for k, (pages, lens) in BATCHES.items()} == {
        k: {"paged_attention": s} for k, s in want["decode"].items()}
    assert gqa.model_flops(cfg, PROMPTS, CONTEXTS) == want["model_flops"]
    assert list(gqa.pool_layout(cfg)) == want["pool"]
    assert gqa.engine_kwargs(cfg) == {}
    reqs = _requests(cfg)
    for prec in PRECISIONS.get(name, ("fp32", "bf16", "fp8")):
        logits, drops = served_logits(params, cfg, reqs, PAGE,
                                      precision=prec)
        assert [_digest(enumerate(logits)), drops] == want["logits"][prec], \
            prec
