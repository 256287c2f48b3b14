"""A run whose timed path is broken underneath comes out not correct:
one test for each fault a serving cell can have (a token altered where it
is produced, a decode step that leaves the pool's state unchanged, half of
the batch left out and the mean of the rest given to it, a page taken from
a request while it still reads it).  The cells run on one card, so there
is no exchange between cards to leave out.  The harness's look for a card
is skipped: these runs are on the CPU at a tiny size."""
import time

import torch

import repro_torch.serve.engine as engine_mod
from portbench.run import run_cell
from portbench.tests import tiny
from repro_torch.cache.block_pool import PageMeta


def _run(tmp_path, fault):
    root = tiny.make_tree(tmp_path)
    return run_cell(root, "tiny-dense.tiny", 2**34 + 9, 1.5, False, "cpu",
                    time.perf_counter(), fault=fault)


def _after_decode(eng, act):
    """Calls ``act(eng, rows)`` after every 5th decode step."""
    step = eng._decode_batch
    n = [0]

    def wrapped():
        rows = [r for r in eng.active if not r.done]
        step()
        n[0] += 1
        if n[0] % 5 == 0:
            act(eng, rows)
    eng._decode_batch = wrapped


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path, None)
    assert out["correct"] is True, out["compared"]


def test_altered_token(tmp_path):
    def alter(eng, rows):
        for r in rows:
            r.generated[-1] = (r.generated[-1] + 1) % eng.cfg.vocab_size
    out = _run(tmp_path, lambda eng: _after_decode(eng, alter))
    assert out["correct"] is False
    assert out["compared"]["logit_gap"]["value"] > \
        out["compared"]["logit_gap"]["limit"]


def test_decode_leaves_the_pool_unchanged(tmp_path):
    def fault(eng):
        step = eng._decode_batch

        def wrapped():
            k, v = eng.pool.k_pages.clone(), eng.pool.v_pages.clone()
            step()
            eng.pool.k_pages.copy_(k)
            eng.pool.v_pages.copy_(v)
        eng._decode_batch = wrapped
    out = _run(tmp_path, fault)
    assert out["correct"] is False


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    real = engine_mod._decode_step

    def half(params, kp, vp, toks, tables, lens, cfg):
        h = max(len(toks) // 2, 1)
        logits, k, v = real(params, kp, vp, toks[:h], tables[:h], lens[:h],
                            cfg)
        rest = len(toks) - h
        return (torch.cat([logits, logits.mean(0, keepdim=True)
                           .expand(rest, -1)]),
                torch.cat([k, k.mean(1, keepdim=True)
                           .expand(-1, rest, -1, -1)], 1),
                torch.cat([v, v.mean(1, keepdim=True)
                           .expand(-1, rest, -1, -1)], 1))
    monkeypatch.setattr(engine_mod, "_decode_step", half)
    out = _run(tmp_path, None)
    assert out["correct"] is False


def test_page_taken_while_in_use(tmp_path):
    def take(eng, rows):
        for r in eng.active:
            pid = r.pages[0]
            eng.pool.meta[pid] = PageMeta(-2)
            eng.pool.k_pages[:, pid] = 0.0
            break
    out = _run(tmp_path, lambda eng: _after_decode(eng, take))
    assert out["correct"] is False
    assert out["compared"]["lost_pages"]["value"] > 0
