"""Plain PyTorch versions of the paged decode attention.

* ``gather_pages`` turns a pool of pages and per-sequence block tables
  into a dense cache (the reference's ``paged_attention/ref.py:11``);
* ``paged_attention_ref`` is the definition the kernel is held against
  (the reference's ``ref.py:18``): gather, repeat the KV heads over their
  query-head group, fp32 scores scaled by ``1 / sqrt(D)``, positions at
  or past ``seq_lens`` masked with -1e30, softmax, the output in q's
  dtype.  It is what the wrapper ``kernel.paged_attention`` returns for a
  CPU tensor, so the serving engine runs it on the CPU, as the reference
  runs it everywhere.

A row with ``seq_len == 0`` softmaxes an all-masked row here (the mean
of the gathered V) while the kernel, like the Pallas kernel, writes 0;
the engine never passes 0, and ``SWEEP`` holds lengths of at least 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["SWEEP", "gather_pages", "paged_attention_ref", "sweep_arrays"]

_NEG_INF = -1e30
# the shapes at which the kernel is held to these: the reference's sweep
# (tests/test_kernels.py:60-63), then qwen3-0.6b's heads ([B, 16, 128]
# over [n_pool, page, 8, 128] pages) at page 8, 16 and 32; the lengths
# end mid-page, on a page edge, at 1 and at the table's end
SWEEP = [
    # B, Hq, Hkv, D, page, pages_per_seq, n_pool, seq_lens
    (2, 4, 2, 64, 16, 4, 32, (37, 64)),
    (3, 8, 8, 128, 32, 3, 16, (1, 70, 96)),
    (1, 8, 2, 64, 8, 6, 64, (45,)),
    (4, 16, 8, 128, 8, 20, 96, (1, 75, 80, 160)),
    (4, 16, 8, 128, 16, 10, 64, (16, 33, 150, 160)),
    (4, 16, 8, 128, 32, 5, 48, (1, 31, 128, 160)),
]


def sweep_arrays(case: tuple, seed: int = 0) -> dict[str, np.ndarray]:
    """One ``SWEEP`` case's inputs as numpy arrays (float32 values and
    int32 tables and lengths), made from ``seed``: standard normal q and
    pages, each row's ``ceil(len / page)`` pages drawn at random from the
    pool and the rest of its table 0."""
    b, hq, hkv, d, page, pps, n_pool, lens = case
    rng = np.random.default_rng(seed)
    tables = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lens):
        used = -(-n // page)
        tables[i, :used] = rng.integers(0, n_pool, used)
    return {
        "q": rng.standard_normal((b, hq, d)).astype(np.float32),
        "k_pages": rng.standard_normal((n_pool, page, hkv, d)
                                       ).astype(np.float32),
        "v_pages": rng.standard_normal((n_pool, page, hkv, d)
                                       ).astype(np.float32),
        "block_tables": tables,
        "seq_lens": np.asarray(lens, np.int32),
    }


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """[n_pool, page, H, D] + [B, n_per_seq] -> dense [B, S_max, H, D]."""
    gathered = pages[block_tables.long()]     # [B, n_per_seq, page, H, D]
    b, n, p, h, d = gathered.shape
    return gathered.reshape(b, n * p, h, d)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D]; k/v_pages [n_pool, page, Hkv, D]; block_tables
    [B, pages_per_seq]; seq_lens [B] -> [B, Hq, D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = gather_pages(k_pages, block_tables)             # [B, S, Hkv, D]
    v = gather_pages(v_pages, block_tables)
    rep = q.shape[1] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
    p = torch.softmax(torch.where(mask, s, _NEG_INF), dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)
