"""Attention blocks (GQA, sliding-window GQA, MLA and cross attention) for
prefill and decode.

The port of the reference's ``src/repro/models/attention.py`` at one
device.  ``attention_train`` hands the attention itself to
``kernels.flash_attention.ops.prefill_attention``: the hand-written
``flash_attention`` kernel on a CUDA tensor (the ``[B, S, H, D]``
projections and the grouped KV heads read in place, the output written as
a contiguous ``[B, S, Hq, Dv]``, so the reshape before ``wo`` moves
nothing), the reference's ``blockwise_attention`` on a CPU tensor.  MLA
(DeepSeek / MiniCPM3) prefills through the same call with q = [q_nope,
q_rope] and k = [k_nope, k_rope shared by every head], so D is
``qk_head_dim`` (the kernel's scale ``1 / sqrt(D)`` is the reference's
``1 / sqrt(qk_head_dim)``) and Dv ``v_head_dim``.  Cross attention (the
encoder-decoder family) has no RoPE and is bidirectional
(``causal=False``), over K and V projected from the encoder's output.

``attention_decode`` is the reference's ``update_cache=True`` path; it
writes the new token's K and V (or, for MLA, its latent ``c_kv`` and
``k_rope``) into the caller's cache tensors in place (the reference
returns updated copies), which spares a copy of the whole cache every
step.  MLA decodes in the reference's absorbed form: the scores are taken
against the latent cache through ``q_nope @ W_uk``, and the output leaves
the latent space through ``W_uv``, in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.models.config import AttnKind, ModelConfig
from repro_torch.models.layers import (Param, apply_rope, decode_attention,
                                       dense_init, rms_norm)

__all__ = ["attention_cross", "attention_decode", "attention_train",
           "build_heads", "cross_attention_decode", "cross_attention_kv",
           "init_attention", "init_kv_cache"]


def build_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(q_heads, kv_heads) on one device: the reference's at a
    tensor-parallel degree of 1, where no q head is padded; MLA expands its
    latent to one K/V head per q head."""
    if cfg.attn == AttnKind.MLA:
        return cfg.n_heads, cfg.n_heads
    return cfg.n_heads, cfg.n_kv_heads


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, layers: int | None = None) -> Param:
    """The projections on the generator's device (``layers`` of them
    stacked on a leading axis, or one): GQA's ``wq``/``wk``/``wv``/``wo``
    (and the qk-norm weights), or MLA's low-rank tree."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = build_heads(cfg)
    lead = () if layers is None else (layers,)

    def zeros(n):
        return torch.zeros((*lead, n), device=gen.device)

    if cfg.attn == AttnKind.MLA:
        r = cfg.kv_lora_rank
        return {
            "wq_a": dense_init(gen, (d, cfg.q_lora_rank), dtype,
                               layers=layers),
            "q_a_norm": zeros(cfg.q_lora_rank),
            "wq_b": dense_init(gen, (cfg.q_lora_rank, hq * cfg.qk_head_dim),
                               dtype, layers=layers),
            "wkv_a": dense_init(gen, (d, r + cfg.qk_rope_dim), dtype,
                                layers=layers),
            "kv_a_norm": zeros(r),
            "wkv_b": dense_init(gen, (r, hq * (cfg.qk_nope_dim
                                               + cfg.v_head_dim)),
                                dtype, layers=layers),
            "wo": dense_init(gen, (hq * cfg.v_head_dim, d), dtype,
                             layers=layers),
        }
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype, layers=layers),
        "wk": dense_init(gen, (d, hkv * hd), dtype, layers=layers),
        "wv": dense_init(gen, (d, hkv * hd), dtype, layers=layers),
        "wo": dense_init(gen, (hq * hd, d), dtype, layers=layers),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(hd)
        p["k_norm"] = zeros(hd)
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


def _mla_q(p: Param, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, hq: int):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] after RoPE)."""
    b, s, _ = x.shape
    q_lat = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.rms_eps)
    q = (q_lat @ p["wq_b"]).reshape(b, s, hq, cfg.qk_head_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p: Param, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """(c_kv [B, S, r], k_rope [B, S, rope]): MLA's KV cache, the k_rope
    one head shared by all."""
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_a_norm"], cfg.rms_eps)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_expand(p: Param, c_kv: torch.Tensor, cfg: ModelConfig, hq: int):
    """The latent expanded to per-head (k_nope, v) for the prefill: views
    of one [B, S, H, nope + v] product."""
    b, s, _ = c_kv.shape
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, hq, cfg.qk_nope_dim
                                     + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def attention_train(p: Param, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool | None = None) -> torch.Tensor:
    """Full-sequence self attention (train / prefill) at positions
    0..S-1, causal as ``cfg.causal`` unless ``causal`` says otherwise (the
    encoder's is not).  x [B, S, d] -> [B, S, d]."""
    b, s, _ = x.shape
    hq, hkv = build_heads(cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    causal = cfg.causal if causal is None else causal
    if cfg.attn == AttnKind.MLA:
        q_nope, q_rope = _mla_q(p, x, cfg, positions, hq)
        c_kv, k_rope = _mla_latent(p, x, cfg, positions)
        k_nope, v = _mla_expand(p, c_kv, cfg, hq)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, hq, cfg.qk_rope_dim)], dim=-1)
        out = prefill_attention(q, k, v, causal=causal, window=cfg.window)
        return out.reshape(b, s, hq * cfg.v_head_dim) @ p["wo"]
    q, k, v = _gqa_qkv(p, x, cfg, positions, hq, hkv)
    out = prefill_attention(q, k, v, causal=causal, window=cfg.window)
    return out.reshape(b, s, hq * cfg.head_dim) @ p["wo"]


# ------------------------------------------------------------ cross-attn
def cross_attention_kv(p: Param, enc_out: torch.Tensor, cfg: ModelConfig
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross K and V [B, S_enc, Hkv, D] from the
    encoder's output (what its decode cache holds)."""
    b, se, _ = enc_out.shape
    _, hkv = build_heads(cfg)
    return ((enc_out @ p["wk"]).reshape(b, se, hkv, cfg.head_dim),
            (enc_out @ p["wv"]).reshape(b, se, hkv, cfg.head_dim))


def attention_cross(p: Param, x: torch.Tensor, enc_out: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder-to-encoder cross attention (no RoPE, bidirectional).
    x [B, Sq, d], enc_out [B, S_enc, d] -> [B, Sq, d]."""
    b, sq, _ = x.shape
    hq, _ = build_heads(cfg)
    q = (x @ p["wq"]).reshape(b, sq, hq, cfg.head_dim)
    k, v = cross_attention_kv(p, enc_out, cfg)
    out = prefill_attention(q, k, v, causal=False, window=0)
    return out.reshape(b, sq, hq * cfg.head_dim) @ p["wo"]


def cross_attention_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           enc_len: torch.Tensor) -> torch.Tensor:
    """One decode token's cross attention over the cached encoder K/V
    [B, S_enc, Hkv, D], the first ``enc_len`` [B] positions seen."""
    b = x.shape[0]
    hq, _ = build_heads(cfg)
    q = (x @ p["wq"]).reshape(b, 1, hq, cfg.head_dim)
    out = decode_attention(q, k_cache, v_cache, enc_len)
    return out.reshape(b, 1, hq * cfg.head_dim) @ p["wo"]


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Zero decode caches: K and V [L, B, max_len, Hkv, D] (the original KV
    heads, as the reference's), or MLA's latent ``c_kv`` [L, B, max_len,
    r] and ``k_rope`` [L, B, max_len, rope]."""
    if cfg.attn == AttnKind.MLA:
        lead = (n_layers, batch, max_len)
        return {"c_kv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((*lead, cfg.qk_rope_dim), dtype=dtype,
                                      device=device)}
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mla_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                layer_cache: dict, cache_len: torch.Tensor,
                rows: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """The absorbed MLA decode (the reference's ``update_cache=True``
    branch, ``attention.py:263-305``): [B, 1, H * v] in x's dtype."""
    b = x.shape[0]
    hq, _ = build_heads(cfg)
    positions = cache_len[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions, hq)       # [B,1,H,*]
    c_new, kr_new = _mla_latent(p, x, cfg, positions)       # [B,1,r/rope]
    c_cache, kr_cache = layer_cache["c_kv"], layer_cache["k_rope"]
    c_cache[rows, at] = c_new[:, 0].to(c_cache.dtype)
    kr_cache[rows, at] = kr_new[:, 0].to(kr_cache.dtype)
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_dim
    w = p["wkv_b"].float().reshape(r, hq, nope + cfg.v_head_dim)
    w_uk, w_uv = w[..., :nope], w[..., nope:]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    c32, kr32 = c_cache.float(), kr_cache.float()
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat, c32)
         + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), kr32)) \
        / math.sqrt(cfg.qk_head_dim)
    pos = torch.arange(c_cache.shape[1], device=x.device)
    valid = pos[None, None, None, :] < (cache_len + 1)[:, None, None, None]
    prob = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", prob, c32)
    out = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    return out.reshape(b, 1, hq * cfg.v_head_dim).to(x.dtype)


def attention_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                     layer_cache: dict, cache_len: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x [B, 1, d]; ``layer_cache`` holds one layer's
    ``k``/``v`` [B, Smax, Hkv, D] (or MLA's ``c_kv``/``k_rope``), written
    at ``cache_len`` [B] in place (at ``Smax - 1`` past the end, as the
    reference's ``dynamic_update_slice`` clamps); returns ([B, 1, d], the
    cache)."""
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    smax = next(iter(layer_cache.values())).shape[1]
    at = cache_len.clamp(max=smax - 1)
    if cfg.attn == AttnKind.MLA:
        out = _mla_decode(p, x, cfg, layer_cache, cache_len, rows, at)
        return out @ p["wo"], layer_cache
    hq, hkv = build_heads(cfg)
    q, k, v = _gqa_qkv(p, x, cfg, cache_len[:, None], hq, hkv)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    k_cache[rows, at] = k[:, 0]
    v_cache[rows, at] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, cache_len + 1,
                           window=cfg.window)
    return out.reshape(b, 1, hq * cfg.head_dim) @ p["wo"], layer_cache
