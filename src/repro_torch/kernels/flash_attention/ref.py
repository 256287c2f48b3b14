"""Plain PyTorch versions of the prefill attention of ``flash_attention``.

* ``attention_ref`` materialises the full score matrix: the definition the
  kernel is held against (the reference's ``flash_attention/ref.py``),
  at the kernel's ``[B, H, S, D]`` layout;
* ``blockwise_attention`` is the reference's own prefill attention
  (``src/repro/models/layers.py:88``): an fp32 online softmax over KV
  blocks at the model's ``[B, S, H, D]`` layout, which never holds more
  than one ``[B, H, block_q, block_kv]`` score tile.  It is what the
  wrapper ``kernel.flash_attention`` returns for a CPU tensor, so the
  model runs it on the CPU, as the reference does.

Both take grouped KV heads (query head h reads KV head ``h // (Hq /
Hkv)``), causal and sliding-window masks with positions absolute from 0 on
both axes, and the scale ``1 / sqrt(D)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["SWEEP", "attention_ref", "blockwise_attention"]

_NEG_INF = -1e30
# the shapes at which the kernel is held to these on the card: the
# reference's sweep (tests/test_kernels.py:37-43), then head dim 112
# (zamba2), GQA 16/8, ragged Sq != Skv, window 96, Dv != D and a
# non-causal window
SWEEP = [
    # B, Hq, Hkv, Sq, Skv, D, Dv, causal, window
    (1, 2, 2, 128, 128, 64, 64, True, 0),
    (2, 2, 2, 96, 160, 64, 64, True, 0),
    (1, 1, 1, 256, 256, 128, 128, False, 0),
    (1, 2, 2, 256, 256, 64, 64, True, 96),
    (2, 4, 4, 64, 64, 32, 32, True, 0),
    (1, 4, 4, 200, 200, 112, 112, True, 0),
    (1, 16, 8, 96, 160, 112, 112, True, 96),
    (2, 4, 2, 70, 70, 16, 48, True, 0),
    (1, 2, 2, 300, 300, 16, 16, False, 40),
]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k [B, Hkv, Skv, D]; v [B, Hkv, Skv, Dv] ->
    [B, Hq, Sq, Dv] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    sq, skv = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _attn_block(q, k, v, *, mask, scale):
    """One (q-block, kv-block) tile: (scores max, exp-sums, p.v)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)                                        # [b,h,q]
    p = torch.exp(s - m[..., None])
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), pv


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_kv: int = 512
                        ) -> torch.Tensor:
    """Memory-bounded attention: online softmax over KV blocks.

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D/Dv] with Hq % Hkv == 0 ->
    [B, Sq, Hq, Dv] in q's dtype.  Blocks beyond the causal diagonal (and
    outside the window) are visited but fully masked, as in the
    reference; the CUDA kernel skips them.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    nq, nk = -(-sq // block_q), -(-skv // block_kv)
    if nq * block_q > sq:
        q = F.pad(q, (0, 0, 0, 0, 0, nq * block_q - sq))
    if nk * block_kv > skv:
        k = F.pad(k, (0, 0, 0, 0, 0, nk * block_kv - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, nk * block_kv - skv))
    q_pos = torch.arange(nq * block_q, device=q.device)
    k_pos = torch.arange(nk * block_kv, device=q.device)
    outs = []
    for qi in range(nq):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        qp = q_pos[qs][None, None, :, None]
        m = torch.full((b, hq, block_q), _NEG_INF, device=q.device)
        l = torch.zeros((b, hq, block_q), device=q.device)
        acc = torch.zeros((b, block_q, hq, dv), device=q.device)
        for ki in range(nk):
            ks = slice(ki * block_kv, (ki + 1) * block_kv)
            kp = k_pos[ks][None, None, None, :]
            mask = kp < skv
            if causal:
                mask = mask & (kp <= qp)
            if window > 0:
                mask = mask & (kp > qp - window)
            m_blk, l_blk, pv = _attn_block(q[:, qs], k[:, ks], v[:, ks],
                                           mask=mask, scale=scale)
            m_new = torch.maximum(m, m_blk)
            c_prev = torch.exp(m - m_new)
            c_blk = torch.exp(m_blk - m_new)
            l = l * c_prev + l_blk * c_blk
            acc = (acc * c_prev.transpose(1, 2)[..., None]
                   + pv * c_blk.transpose(1, 2)[..., None])
            m = m_new
        out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]
