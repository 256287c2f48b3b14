"""Attention blocks (GQA and sliding-window GQA) for prefill and decode.

The port of the GQA branches of the reference's
``src/repro/models/attention.py``.  ``attention_train`` hands the
attention itself to ``kernels.flash_attention.ops.prefill_attention``:
the hand-written ``flash_attention`` kernel on a CUDA tensor (layout moved
to ``[B, H, S, D]``, KV heads read in place), the reference's
``blockwise_attention`` on a CPU tensor.  ``attention_decode`` is the
reference's ``update_cache=True`` path; it writes the new token's K and V
into the caller's cache tensors in place (the reference returns updated
copies), which spares a copy of the whole cache every step.  MLA and
cross attention raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.models.config import AttnKind, ModelConfig
from repro_torch.models.layers import (Param, apply_rope, decode_attention,
                                       dense_init, rms_norm)

__all__ = ["attention_decode", "attention_train", "build_heads",
           "init_attention", "init_kv_cache", "not_ported"]


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP §1 item 2 (the MoE, MLA and "
        f"encoder-decoder families)")


def build_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(q_heads, kv_heads) of a GQA block on one device: the reference's
    at a tensor-parallel degree of 1, where no q head is padded."""
    return cfg.n_heads, cfg.n_kv_heads


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, layers: int | None = None) -> Param:
    """GQA projections on the generator's device (``layers`` of them
    stacked on a leading axis, or one)."""
    if cfg.attn == AttnKind.MLA:
        raise not_ported("MLA attention")
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = build_heads(cfg)
    lead = () if layers is None else (layers,)
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype, layers=layers),
        "wk": dense_init(gen, (d, hkv * hd), dtype, layers=layers),
        "wv": dense_init(gen, (d, hkv * hd), dtype, layers=layers),
        "wo": dense_init(gen, (hq * hd, d), dtype, layers=layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), device=gen.device)
        p["k_norm"] = torch.zeros((*lead, hd), device=gen.device)
    return p


def _gqa_qkv(p: Param, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, hq: int, hkv: int):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, hq, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, hkv, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, hkv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_train(p: Param, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence self attention (train / prefill) at positions
    0..S-1, causal as ``cfg.causal``.  x [B, S, d] -> [B, S, d]."""
    if cfg.attn == AttnKind.MLA:
        raise not_ported("MLA attention")
    b, s, _ = x.shape
    hq, hkv = build_heads(cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, cfg, positions, hq, hkv)
    out = prefill_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    return out.reshape(b, s, hq * cfg.head_dim) @ p["wo"]


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Zero K and V caches [L, B, max_len, Hkv, D] (the original KV heads,
    as the reference's decode caches)."""
    if cfg.attn == AttnKind.MLA:
        raise not_ported("MLA attention")
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                     layer_cache: dict, cache_len: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x [B, 1, d]; ``layer_cache`` holds one layer's
    ``k``/``v`` [B, Smax, Hkv, D], written at ``cache_len`` [B] in place
    (at ``Smax - 1`` past the end, as the reference's
    ``dynamic_update_slice`` clamps); returns ([B, 1, d], the cache)."""
    if cfg.attn == AttnKind.MLA:
        raise not_ported("MLA attention")
    b = x.shape[0]
    hq, hkv = build_heads(cfg)
    q, k, v = _gqa_qkv(p, x, cfg, cache_len[:, None], hq, hkv)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    rows = torch.arange(b, device=x.device)
    at = cache_len.clamp(max=k_cache.shape[1] - 1)
    k_cache[rows, at] = k[:, 0]
    v_cache[rows, at] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, cache_len + 1,
                           window=cfg.window)
    return out.reshape(b, 1, hq * cfg.head_dim) @ p["wo"], layer_cache
