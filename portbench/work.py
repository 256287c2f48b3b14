"""The yardstick's arithmetic: the H100's published peaks, and the work
of each kernel and of the model, computed from shapes alone.

Frozen here so that a change to the program cannot move the ruler it is
measured by.  The kernel formulas are those of ``chip_smoke.py`` and the
port's ``costs.kernel_op`` work functions; the model's FLOPs count the
active parameters only (a token meets the shared and its top-k experts,
not every expert the dense dispatch computes).
"""
from __future__ import annotations

import numpy as np

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "bound_s",
           "causal_pairs", "flash_attention_work", "model_flops",
           "paged_attention_work", "paged_positions"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask leaves over ``s`` positions."""
    return s * (s + 1) // 2


def flash_attention_work(s: int, hq: int, hkv: int, d: int,
                         esize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal prefill call at [1, s, hq/hkv, d]: two
    products of 2 d FLOPs per seen pair and head; q, k, v read and the
    output written once."""
    flops = 4 * d * hq * causal_pairs(s)
    nbytes = (2 * s * hq * d + 2 * s * hkv * d) * esize
    return flops, nbytes


def paged_positions(pages: list[np.ndarray], lens: np.ndarray,
                    page: int) -> int:
    """Distinct pool positions one decode step's rows attend: each row
    reads positions [0, len) through its block table; a page that rows
    share (a prefix) is counted once, over the most positions any of them
    reads in it."""
    if not len(lens):
        return 0
    pids, cover = [], []
    for pg, n in zip(pages, lens):
        k = -(-int(n) // page)
        pids.append(np.asarray(pg[:k], np.int64))
        c = np.full(k, page, np.int64)
        if k:
            c[-1] = int(n) - (k - 1) * page
        cover.append(c)
    pids, cover = np.concatenate(pids), np.concatenate(cover)
    best = np.zeros(int(pids.max()) + 1 if len(pids) else 0, np.int64)
    np.maximum.at(best, pids, cover)
    return int(best.sum())


def paged_attention_work(positions: int, rows: int, pages_per_seq: int,
                         hq: int, hkv: int, d: int,
                         esize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode call: K and V of every attended pool
    position read once, q read and the output written once, the block
    tables and lengths (int32) read once; 4 d FLOPs per position and q
    head."""
    flops = 4 * d * hq * positions
    nbytes = (positions * hkv * d * 2 * esize + 2 * rows * hq * d * esize
              + 4 * (rows * pages_per_seq + rows))
    return flops, nbytes


def _layer_params(cfg: dict) -> int:
    """Parameters a token meets in one block (projections, the dense FFN
    or the router, top-k and shared experts)."""
    d = cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    attn = 2 * d * hq * hd + 2 * d * hkv * hd
    if cfg.get("num_experts"):
        ffn = (3 * d * cfg["moe_intermediate_size"]
               * cfg["num_experts_per_tok"]
               + 3 * d * cfg["shared_expert_intermediate_size"]
               + d * cfg["num_experts"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def model_flops(cfg: dict, prompt_lens: list[int],
                decode_ctx: list[int]) -> float:
    """Model FLOPs of serving: each prompt of length S through every
    block (2 per parameter and token, causal attention 4 hd per pair and
    head) and one row of the head; each generated token at context c
    (positions before it) through every block, attention over c + 1
    positions, and the head."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // hq
    per_tok = 2 * L * _layer_params(cfg)
    head = 2 * d * cfg["vocab_size"]
    s = np.asarray(prompt_lens, np.float64)
    c = np.asarray(decode_ctx, np.float64)
    pre = (per_tok * s + L * 4 * hd * hq * s * (s + 1) / 2 + head).sum()
    dec = (per_tok + L * 4 * hd * hq * (c + 1) + head).sum()
    return float(pre + dec)
