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

``attention_decode`` has the reference's two paths.  With
``update_cache=True`` it writes the new token's K and V (or, for MLA, its
latent ``c_kv`` and ``k_rope``) into the caller's cache tensors in place
(the reference returns updated copies), which spares a copy of the whole
cache every step.  With ``update_cache=False`` (the split-KV decode) the
cache stays frozen: the token attends to the cache below ``cache_len``,
its own K/V are merged in by log-sum-exp (``_merge_lse``), and the
1-token delta is returned for the caller to commit.  MLA decodes in the
reference's absorbed form: the scores are taken against the latent cache
through ``q_nope @ W_uk``, and the output leaves the latent space through
``W_uv``, in fp32.

``tp`` is the tensor-parallel degree the parameters are built for: q heads
are padded to ``cfg.padded_heads(tp)`` (minicpm3's 40 to 48 at 16), as the
reference's ``build_heads``; the KV heads and the decode caches keep their
own count.  ``constrain(q/k/v, "attn_qkv")`` is the reference's hint (an
identity here, ``distributed.ctx``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.ctx import constrain
from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.models.config import AttnKind, ModelConfig
from repro_torch.models.layers import (Param, apply_rope, decode_attention,
                                       dense_init, rms_norm)

__all__ = ["attention_cross", "attention_decode", "attention_train",
           "build_heads", "cross_attention_decode", "cross_attention_kv",
           "init_attention", "init_kv_cache"]


def build_heads(cfg: ModelConfig, tp: int = 1) -> tuple[int, int]:
    """Effective (q_heads, kv_heads) at tensor-parallel degree ``tp``: q
    heads padded so ``tp`` divides them (none at 1), KV heads as they are;
    MLA expands its latent to one K/V head per q head."""
    hq = cfg.padded_heads(tp)
    if cfg.attn == AttnKind.MLA:
        return hq, hq
    return hq, cfg.n_kv_heads


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, layers: int | None = None, *,
                   tp: int = 1) -> Param:
    """The projections on the generator's device (``layers`` of them
    stacked on a leading axis, or one): GQA's ``wq``/``wk``/``wv``/``wo``
    (and the qk-norm weights), or MLA's low-rank tree, with
    ``build_heads(cfg, tp)`` heads."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = build_heads(cfg, tp)
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


def attention_train(p: Param, x: torch.Tensor, cfg: ModelConfig,
                    tp: int = 1, *, causal: bool | None = None
                    ) -> torch.Tensor:
    """Full-sequence self attention (train / prefill) at positions
    0..S-1, causal as ``cfg.causal`` unless ``causal`` says otherwise (the
    encoder's is not).  x [B, S, d] -> [B, S, d]."""
    b, s, _ = x.shape
    hq, hkv = build_heads(cfg, tp)
    positions = torch.arange(s, device=x.device)[None, :]
    causal = cfg.causal if causal is None else causal
    if cfg.attn == AttnKind.MLA:
        q_nope, q_rope = _mla_q(p, x, cfg, positions, hq)
        c_kv, k_rope = _mla_latent(p, x, cfg, positions)
        k_nope, v = _mla_expand(p, c_kv, cfg, hq)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, hq, cfg.qk_rope_dim)], dim=-1)
        out = prefill_attention(constrain(q, "attn_qkv"),
                                constrain(k, "attn_qkv"),
                                constrain(v, "attn_qkv"), causal=causal,
                                window=cfg.window)
        return out.reshape(b, s, hq * cfg.v_head_dim) @ p["wo"]
    q, k, v = _gqa_qkv(p, x, cfg, positions, hq, hkv)
    out = prefill_attention(constrain(q, "attn_qkv"), constrain(k, "attn_qkv"),
                            constrain(v, "attn_qkv"), causal=causal,
                            window=cfg.window)
    return out.reshape(b, s, hq * cfg.head_dim) @ p["wo"]


# ------------------------------------------------------------ cross-attn
def cross_attention_kv(p: Param, enc_out: torch.Tensor, cfg: ModelConfig,
                       tp: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross K and V [B, S_enc, Hkv, D] from the
    encoder's output (what its decode cache holds)."""
    b, se, _ = enc_out.shape
    _, hkv = build_heads(cfg, tp)
    return ((enc_out @ p["wk"]).reshape(b, se, hkv, cfg.head_dim),
            (enc_out @ p["wv"]).reshape(b, se, hkv, cfg.head_dim))


def attention_cross(p: Param, x: torch.Tensor, enc_out: torch.Tensor,
                    cfg: ModelConfig, tp: int = 1) -> torch.Tensor:
    """Decoder-to-encoder cross attention (no RoPE, bidirectional).
    x [B, Sq, d], enc_out [B, S_enc, d] -> [B, Sq, d]."""
    b, sq, _ = x.shape
    hq, _ = build_heads(cfg, tp)
    q = (x @ p["wq"]).reshape(b, sq, hq, cfg.head_dim)
    k, v = cross_attention_kv(p, enc_out, cfg, tp)
    out = prefill_attention(q, k, v, causal=False, window=0)
    return out.reshape(b, sq, hq * cfg.head_dim) @ p["wo"]


def cross_attention_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           enc_len: torch.Tensor, tp: int = 1
                           ) -> torch.Tensor:
    """One decode token's cross attention over the cached encoder K/V
    [B, S_enc, Hkv, D], the first ``enc_len`` [B] positions seen."""
    b = x.shape[0]
    hq, _ = build_heads(cfg, tp)
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


def _merge_lse(att_cache: torch.Tensor, lse_cache: torch.Tensor,
               att_self: torch.Tensor, s_self: torch.Tensor) -> torch.Tensor:
    """The exact online-softmax merge of the frozen cache's attention with
    the in-flight token's: att_* [B, 1, H, D] fp32 (att_self may
    broadcast), lse / s [B, H]."""
    lse_all = torch.logaddexp(lse_cache, s_self)
    w_c = torch.exp(lse_cache - lse_all)[:, None, :, None]
    w_s = torch.exp(s_self - lse_all)[:, None, :, None]
    return att_cache * w_c + att_self * w_s


def _mla_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                layer_cache: dict, cache_len: torch.Tensor, tp: int,
                update_cache: bool) -> tuple[torch.Tensor, dict]:
    """The absorbed MLA decode (the reference's ``attention.py:263-305``):
    ([B, 1, H * v] in x's dtype, the cache written in place or the
    1-token latent delta)."""
    b = x.shape[0]
    hq, _ = build_heads(cfg, tp)
    positions = cache_len[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions, hq)       # [B,1,H,*]
    c_new, kr_new = _mla_latent(p, x, cfg, positions)       # [B,1,r/rope]
    c_cache, kr_cache = layer_cache["c_kv"], layer_cache["k_rope"]
    c_new, kr_new = c_new.to(c_cache.dtype), kr_new.to(kr_cache.dtype)
    if update_cache:
        rows = torch.arange(b, device=x.device)
        at = cache_len.clamp(max=c_cache.shape[1] - 1)
        c_cache[rows, at] = c_new[:, 0]
        kr_cache[rows, at] = kr_new[:, 0]
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_dim
    w = p["wkv_b"].float().reshape(r, hq, nope + cfg.v_head_dim)
    w_uk, w_uv = w[..., :nope], w[..., nope:]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    c32, kr32 = c_cache.float(), kr_cache.float()
    root = math.sqrt(cfg.qk_head_dim)
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat, c32)
         + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), kr32)) / root
    pos = torch.arange(c_cache.shape[1], device=x.device)
    limit = cache_len + 1 if update_cache else cache_len
    s = torch.where(pos[None, None, None, :] < limit[:, None, None, None],
                    s, -1e30)
    o_lat = torch.einsum("bhqk,bkr->bqhr", torch.softmax(s, dim=-1), c32)
    if not update_cache:
        s_self = (torch.einsum("bqhr,bqr->bh", q_lat, c_new.float())
                  + torch.einsum("bqhr,bqr->bh", q_rope.float(),
                                 kr_new.float())) / root
        o_lat = _merge_lse(o_lat, torch.logsumexp(s, dim=-1)[:, :, 0],
                           c_new.float()[:, :, None, :], s_self)
    out = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    delta = layer_cache if update_cache else {"c_kv": c_new,
                                               "k_rope": kr_new}
    return out.reshape(b, 1, hq * cfg.v_head_dim).to(x.dtype), delta


def _split_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_cache: torch.Tensor, v_cache: torch.Tensor,
              cache_len: torch.Tensor, window: int) -> torch.Tensor:
    """The split-KV decode of one GQA token (the reference's
    ``attention.py:333-364``): q [B, 1, Hq, D] over the frozen cache's
    first ``cache_len`` positions (the last ``window`` of them when set),
    grouped by KV head without repeating it, merged with the token's own
    k / v [B, 1, Hkv, D] by log-sum-exp -> [B, 1, Hkv, g, D] fp32."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    q_g = q.reshape(b, 1, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bshd->bhgqs", q_g, k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    lim = cache_len[:, None, None, None, None]
    valid = pos < lim
    if window > 0:
        valid = valid & (pos >= lim - window)
    s = torch.where(valid, s, -1e30)
    att = torch.einsum("bhgqs,bshd->bqhgd",
                       torch.softmax(s, dim=-1).to(v_cache.dtype).float(),
                       v_cache.float())
    lse = torch.logsumexp(s, dim=-1)[..., 0]                 # [B,hkv,g]
    s_self = torch.einsum("bqhgd,bqhd->bhg", q_g, k.float()) * scale
    lse_all = torch.logaddexp(lse, s_self)
    return (att * torch.exp(lse - lse_all)[:, None, :, :, None]
            + v.float()[:, :, :, None, :]
            * torch.exp(s_self - lse_all)[:, None, :, :, None])


def attention_decode(p: Param, x: torch.Tensor, cfg: ModelConfig,
                     layer_cache: dict, cache_len: torch.Tensor, *,
                     tp: int = 1, update_cache: bool = True
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x [B, 1, d]; ``layer_cache`` holds one layer's
    ``k``/``v`` [B, Smax, Hkv, D] (or MLA's ``c_kv``/``k_rope``);
    ``cache_len`` [B] the tokens already in it.  Returns ([B, 1, d], the
    cache).

    ``update_cache=True`` writes the token at ``cache_len`` in place (at
    ``Smax - 1`` past the end, as the reference's ``dynamic_update_slice``
    clamps) and attends to ``cache_len + 1`` positions.
    ``update_cache=False`` leaves the cache as it is, attends to its first
    ``cache_len`` positions and the token itself (merged by log-sum-exp)
    and returns the token's 1-token delta in the cache's place: ``k``/``v``
    [B, 1, Hkv, D], or ``c_kv`` [B, 1, r] / ``k_rope`` [B, 1, rope]."""
    b = x.shape[0]
    if cfg.attn == AttnKind.MLA:
        out, cache = _mla_decode(p, x, cfg, layer_cache, cache_len, tp,
                                 update_cache)
        return out @ p["wo"], cache
    hq, hkv = build_heads(cfg, tp)
    q, k, v = _gqa_qkv(p, x, cfg, cache_len[:, None], hq, hkv)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    if not update_cache:
        out = _split_kv(q, k, v, k_cache, v_cache, cache_len, cfg.window)
        out = out.reshape(b, 1, hq * cfg.head_dim).to(x.dtype)
        return out @ p["wo"], {"k": k, "v": v}
    rows = torch.arange(b, device=x.device)
    at = cache_len.clamp(max=k_cache.shape[1] - 1)
    k_cache[rows, at] = k[:, 0]
    v_cache[rows, at] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, cache_len + 1,
                           window=cfg.window)
    return out.reshape(b, 1, hq * cfg.head_dim) @ p["wo"], layer_cache
