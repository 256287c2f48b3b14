"""Analytic model FLOPs and HBM bytes per (arch x shape) cell.

The port's own copy of the reference's ``src/repro/launch/roofline.py``
(arithmetic on the config; the results equal the reference's for every
cell).  ``model_flops`` is the step's *useful* compute:

  train   : 6 N_active tokens  +  3 x attention-context FLOPs
  prefill : 2 N_active tokens  +  attention-context FLOPs
  decode  : 2 N_active batch   +  KV-read attention FLOPs

Attention-context FLOPs (per token pair visited): 4 head_dim (QK^T + PV),
halved for causal masks, window-clipped for SWA, latent-rank-sized for
MLA; SSD chunks contribute linear terms.  ``model_bytes`` is the analytic
per-device HBM traffic of a production path with tiles kept on chip
(params, optimizer state, the per-layer carry, the flash K/V re-reads,
the decode caches), a model of the traffic, not a measurement of the
port.
"""
from __future__ import annotations

from repro_torch.models.config import (AttnKind, Family, ModelConfig,
                                       ShapeConfig)

__all__ = ["model_flops", "attention_flops", "model_bytes"]


def model_bytes(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                *, remat: str = "full", sp: bool = True,
                tp: int = 16) -> float:
    """Analytic per-device HBM traffic of the production path, with
    tiles resident on chip:

      params      read per fwd and per bwd (sharded 1/n_chips);
      opt state   3×fp32 read+write + master write (train);
      activations scan-carry h per layer written+read (seq/TP when SP);
      CE          per-chunk logits written+read once (remat: recomputed);
      KV cache    decode: full read per step + 1-token write;
      SSM state   decode: read+write per layer.
    """
    B, S = shape.global_batch, shape.seq_len
    P_total = cfg.n_params()
    p_bytes = 2.0 * P_total / n_chips            # bf16 shard
    d = cfg.d_model

    if shape.kind == "train":
        fwd_reads = p_bytes
        bwd_reads = p_bytes * (2.0 if remat == "full" else 1.0)
        grads = 4.0 * P_total / n_chips
        opt = (3 * 2 + 1) * 4.0 * P_total / n_chips   # m,v,master rw + p w
        tokens_dev = B * S / n_chips
        act_shard = tp if sp else 1
        acts = cfg.n_layers * (B / max(n_chips // tp, 1)) * (S / act_shard) \
            * d * 2.0 * 2.0                      # carry write+read, bf16
        return fwd_reads + bwd_reads + grads + opt + acts

    if shape.kind == "prefill":
        tokens_dev = B * S / n_chips
        acts = cfg.n_layers * tokens_dev * d * 2.0 * 2.0
        # flash KV re-reads: each q block streams K/V once
        nq = max(S // 512, 1)
        kv_bytes = 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim * 2.0 \
            * cfg.n_layers / n_chips
        return p_bytes + acts + kv_bytes * min(nq, 8)

    # decode
    if cfg.family == Family.SSM:
        state = B * cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim \
            * 4.0 * cfg.n_layers / n_chips
        return p_bytes + 2.0 * state
    if cfg.family == Family.HYBRID:
        state = B * cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim \
            * 4.0 * cfg.n_layers / n_chips
        n_groups = cfg.n_layers // max(cfg.attn_every, 1)
        kv_len = min(S, cfg.window) if cfg.window else S
        kv = 2.0 * B * kv_len * cfg.n_kv_heads * cfg.head_dim * 2.0 \
            * n_groups / n_chips
        return p_bytes + 2.0 * state + kv
    kv_len = min(S, cfg.window) if cfg.window else S
    if cfg.attn == AttnKind.MLA:
        kv = B * kv_len * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0 \
            * cfg.n_layers / n_chips
    else:
        kv = 2.0 * B * kv_len * cfg.n_kv_heads * cfg.head_dim * 2.0 \
            * cfg.n_layers / n_chips
    if cfg.family == Family.ENCDEC:
        kv += 2.0 * B * 4096 * cfg.n_kv_heads * cfg.head_dim * 2.0 \
            * cfg.n_layers / n_chips
    return p_bytes + kv


def attention_flops(cfg: ModelConfig, B: int, S_q: int, S_kv: int,
                    causal: bool) -> float:
    """Total attention context FLOPs for one forward pass, all layers."""
    if cfg.family == Family.SSM:
        return _ssd_flops(cfg, B, S_q) * cfg.n_layers
    if cfg.attn == AttnKind.MLA:
        per_pair = 2.0 * (cfg.qk_nope_dim + cfg.qk_rope_dim) \
            + 2.0 * cfg.v_head_dim
    else:
        per_pair = 4.0 * cfg.head_dim
    pairs = _visible_pairs(S_q, S_kv, causal, cfg.window)
    layers_with_attn = cfg.n_layers
    total = B * cfg.n_heads * pairs * per_pair
    if cfg.family == Family.HYBRID:
        n_groups = cfg.n_layers // max(cfg.attn_every, 1)
        total = B * cfg.n_heads * pairs * per_pair * n_groups \
            + _ssd_flops(cfg, B, S_q) * cfg.n_layers
        return total
    if cfg.family == Family.ENCDEC:
        enc = B * cfg.n_heads * _visible_pairs(S_kv, S_kv, False, 0) \
            * per_pair * cfg.n_enc_layers
        cross = B * cfg.n_heads * S_q * S_kv * per_pair * cfg.n_layers
        return total * 0 + enc + cross + \
            B * cfg.n_heads * _visible_pairs(S_q, S_q, True, 0) \
            * per_pair * cfg.n_layers
    return total * layers_with_attn


def _visible_pairs(S_q: int, S_kv: int, causal: bool, window: int) -> float:
    if causal and S_q == S_kv:
        pairs = S_q * (S_q + 1) / 2.0
        if window and window < S_q:
            pairs = min(pairs, S_q * float(window))
        return pairs
    if window and window < S_kv:
        return S_q * float(window)
    return float(S_q) * S_kv


def _ssd_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Chunked SSD per layer: intra-chunk quadratic + state updates."""
    Q = min(cfg.ssm_chunk, S)
    nh, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    nc = max(S // Q, 1)
    intra = nc * (2.0 * Q * Q * N + 2.0 * Q * Q * P) * nh   # CBᵀ then ·x
    inter = nc * (4.0 * Q * N * P) * nh                     # state in/out
    return B * (intra + inter)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = B * S
        return 6.0 * n_active * tokens + 3.0 * attention_flops(
            cfg, B, S, S, cfg.causal)
    if shape.kind == "prefill":
        tokens = B * S
        return 2.0 * n_active * tokens + attention_flops(
            cfg, B, S, S, cfg.causal)
    # decode: 1 token per sequence over an S-deep cache
    if cfg.family == Family.SSM:
        ctx = 0.0
        for _ in range(1):
            nh, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
            ctx = B * cfg.n_layers * nh * 4.0 * N * P
        return 2.0 * n_active * B + ctx
    if cfg.family == Family.HYBRID:
        nh, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
        ssm_ctx = B * cfg.n_layers * nh * 4.0 * N * P
        n_groups = cfg.n_layers // max(cfg.attn_every, 1)
        kv = min(S, cfg.window) if cfg.window else S
        attn_ctx = B * cfg.n_heads * kv * 4.0 * cfg.head_dim * n_groups
        return 2.0 * n_active * B + ssm_ctx + attn_ctx
    kv = min(S, cfg.window) if cfg.window else S
    if cfg.attn == AttnKind.MLA:
        per = 2.0 * (cfg.kv_lora_rank + cfg.qk_rope_dim) \
            + 2.0 * cfg.kv_lora_rank      # absorbed decode
    else:
        per = 4.0 * cfg.head_dim
    attn_ctx = B * cfg.n_heads * kv * per * cfg.n_layers
    if cfg.family == Family.ENCDEC:
        attn_ctx += B * cfg.n_heads * 4096 * 4.0 * cfg.head_dim \
            * cfg.n_layers                # cross-attention reads
    return 2.0 * n_active * B + attn_ctx
