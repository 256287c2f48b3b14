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
``SWEEP`` holds lengths of at least 1.

Both take an optional in-flight position, ``k_self`` / ``v_self`` [B,
Hkv, D]: the serving decode's new token, whose K/V is not in the pool
yet.  With it the result is the softmax attention over the row's pooled
positions and that one (score ``(q . k_self) / sqrt(D)``, value
``v_self``); a row of length 0 then gives ``v_self`` exactly.

``paged_attention_split_ref`` is the kernel's split-KV decomposition in
plain torch (tests only): each split of whole pages forms its own fp32
``(m, l, acc)`` and the splits are merged by the log-sum-exp
combination; a split past the length is empty, and a row of length 0
gives 0, as the kernel.  The in-flight position is one more partial,
``(s_self, 1, v_self)``, merged after the splits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["LONG_ROWS", "SWEEP", "gather_pages", "paged_attention_ref",
           "paged_attention_split_ref", "sweep_arrays"]

_NEG_INF = -1e30
# the shapes at which the kernel is held to these: the reference's sweep
# (tests/test_kernels.py:60-63), then qwen3-0.6b's heads ([B, 16, 128]
# over [n_pool, page, 8, 128] pages) at page 8, 16 and 32, and
# qwen2-moe-a2.7b's (16 query heads over 16 KV heads, a group of 1) at
# page 16; the lengths end mid-page, on a page edge, at 1 and at the
# table's end
SWEEP = [
    # B, Hq, Hkv, D, page, pages_per_seq, n_pool, seq_lens
    (2, 4, 2, 64, 16, 4, 32, (37, 64)),
    (3, 8, 8, 128, 32, 3, 16, (1, 70, 96)),
    (1, 8, 2, 64, 8, 6, 64, (45,)),
    (4, 16, 8, 128, 8, 20, 96, (1, 75, 80, 160)),
    (4, 16, 8, 128, 16, 10, 64, (16, 33, 150, 160)),
    (4, 16, 8, 128, 32, 5, 48, (1, 31, 128, 160)),
    (3, 16, 16, 128, 16, 10, 64, (1, 100, 160)),
]

# qwen3's heads at its serving page and table width (136 pages of 16):
# rows of about 2048 positions at B 1 and 4, split many ways, with a row
# of length 0 (the kernel writes 0), one of the table's full width and
# one of length 1
LONG_ROWS = [
    (1, 16, 8, 128, 16, 136, 1024, (2046,)),
    (4, 16, 8, 128, 16, 136, 1024, (2039, 0, 2176, 1)),
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


def _self_partial(q: torch.Tensor, k_self: torch.Tensor,
                  v_self: torch.Tensor, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-flight position's fp32 score [B, Hq] and value [B, Hq, D],
    its KV heads repeated over their query-head group."""
    rep = q.shape[1] // k_self.shape[1]
    kr = k_self.repeat_interleave(rep, dim=1).float()
    s_self = torch.einsum("bhd,bhd->bh", q.float(), kr) * scale
    return s_self, v_self.repeat_interleave(rep, dim=1).float()


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor,
                        k_self: torch.Tensor | None = None,
                        v_self: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Hq, D]; k/v_pages [n_pool, page, Hkv, D]; block_tables
    [B, pages_per_seq]; seq_lens [B]; optionally the in-flight position's
    k_self / v_self [B, Hkv, D] -> [B, Hq, D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = gather_pages(k_pages, block_tables)             # [B, S, Hkv, D]
    v = gather_pages(v_pages, block_tables)
    rep = q.shape[1] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
    s = torch.where(mask, s, _NEG_INF)
    if k_self is None:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)
    s_self, v_s = _self_partial(q, k_self, v_self, scale)
    p = torch.softmax(torch.cat([s, s_self[..., None]], dim=-1), dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p[..., :-1], v.float())
    return (out + p[..., -1:] * v_s).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              seq_lens: torch.Tensor,
                              n_split: int,
                              k_self: torch.Tensor | None = None,
                              v_self: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """``paged_attention_ref`` as the kernel decomposes it: split z takes
    pages ``[z * per, (z + 1) * per)`` of each table, ``per =
    ceil(pages_per_seq / n_split)``; its partial is ``m`` (the max of its
    visible scores, -1e30 if none), ``l = sum p`` and ``acc = sum p v``
    with ``p = exp(s - m)`` on the visible positions; the in-flight
    position, when given, is the partial ``(s_self, 1, v_self)`` after
    the splits; the merge weighs partial z by ``exp(m_z - max m)`` and
    divides by ``max(l, 1e-30)``.  A row of length 0 gives 0, or
    ``v_self``.  [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    page, pps = k_pages.shape[1], block_tables.shape[1]
    scale = 1.0 / math.sqrt(d)
    ms, ls, accs = [], [], []
    if pps > 0:
        per = -(-pps // n_split)
        rep = hq // k_pages.shape[2]
        k = gather_pages(k_pages, block_tables).repeat_interleave(rep, dim=2)
        v = gather_pages(v_pages, block_tables).repeat_interleave(rep, dim=2)
        s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
        pos = torch.arange(k.shape[1], device=q.device)
        visible = pos[None, :] < seq_lens.to(q.device)[:, None]  # [B, S]
        for z in range(n_split):
            mask = (visible & (pos // (per * page) == z))[:, None, :]
            sz = torch.where(mask, s, _NEG_INF)
            m = sz.max(dim=-1).values                            # [B, Hq]
            p = torch.where(mask, torch.exp(sz - m[..., None]), 0.0)
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("bhk,bkhd->bhd", p, v.float()))
    if k_self is not None:
        s_self, v_s = _self_partial(q, k_self, v_self, scale)
        ms.append(s_self)
        ls.append(torch.ones_like(s_self))
        accs.append(v_s)
    if not ms:
        return torch.zeros_like(q)
    m = torch.stack(ms)
    w = torch.exp(m - m.max(dim=0).values)
    lsum = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    return (acc / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)
