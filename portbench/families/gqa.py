"""The ``gqa`` family: dense and MoE decoders with GQA attention and RoPE
in every layer (qwen3, qwen2-moe), each layer's K and V in the paged
pool.  See ``portbench/families/__init__.py`` for the interface; the
plain reference is ``portbench/reference/gqa.py``."""
from __future__ import annotations

import numpy as np
import torch

from portbench import weights, work
from repro_torch.models.config import AttnKind, Family, ModelConfig

__all__ = ["decode_bound_s", "engine_kwargs", "make_params", "model_config",
           "model_flops", "pool_layout", "prefill_bound_s"]


def _heads(cfg: dict) -> tuple[int, int, int]:
    """(q heads, KV heads, head dim) of the configuration file."""
    hq = cfg["num_attention_heads"]
    return (hq, cfg["num_key_value_heads"],
            cfg.get("head_dim") or cfg["hidden_size"] // hq)


def model_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` for a configuration file."""
    moe = bool(cfg.get("num_experts"))
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    kw = dict(name=cfg["name"], family=Family.MOE if moe else Family.DENSE,
              n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=hq,
              n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg.get("head_dim") or d // hq,
              d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
              attn=AttnKind.GQA, qk_norm=cfg["port"]["qk_norm"],
              rope_theta=float(cfg["rope_theta"]),
              rms_eps=cfg["rms_norm_eps"],
              tie_embeddings=cfg["tie_word_embeddings"],
              dtype=cfg["torch_dtype"])
    if moe:
        f, sf = cfg["moe_intermediate_size"], \
            cfg["shared_expert_intermediate_size"]
        kw.update(n_experts=cfg["num_experts"], n_shared_experts=sf // f,
                  top_k=cfg["num_experts_per_tok"], expert_d_ff=f,
                  shared_d_ff=sf,
                  capacity_factor=cfg["port"]["capacity_factor"])
    return ModelConfig(**kw)


def make_params(cfg: dict, seed: int, device: torch.device | str) -> dict:
    """The parameter tree of the configuration file ``cfg`` (its
    published keys), drawn from ``seed`` on ``device``: attention and the
    dense FFN or the MoE block in every layer, stacked on a leading layer
    axis."""
    draw = weights.Draw(cfg, seed, device)
    mat, norm = draw.mat, draw.norm
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hq, hkv, hd = _heads(cfg)
    vp = weights.padded_vocab(cfg)
    attn = {"wq": mat(L, d, hq * hd), "wk": mat(L, d, hkv * hd),
            "wv": mat(L, d, hkv * hd),
            "wo": mat(L, hq * hd, d, residual=True)}
    if cfg["port"]["qk_norm"]:
        attn["q_norm"], attn["k_norm"] = norm(L, hd), norm(L, hd)
    if cfg.get("num_experts"):
        e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        sf = cfg["shared_expert_intermediate_size"]
        mlp = {"router": mat(L, d, e),
               "w_gate": mat(L, e, d, f), "w_up": mat(L, e, d, f),
               "w_down": mat(L, e, f, d, residual=True),
               "shared_gate": mat(L, d, sf), "shared_up": mat(L, d, sf),
               "shared_down": mat(L, sf, d, residual=True)}
    else:
        ff = cfg["intermediate_size"]
        mlp = {"w_gate": mat(L, d, ff), "w_up": mat(L, d, ff),
               "w_down": mat(L, ff, d, residual=True)}
    params = {"embed": mat(vp, d, std=cfg["assumed"]["embedding_std"]),
              "final_norm": norm(d),
              "layers": {"ln1": norm(L, d), "attn": attn, "ln2": norm(L, d),
                         "mlp": mlp}}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = mat(d, vp)
    return params


def pool_layout(cfg: dict) -> tuple[int, int, int]:
    """Every layer pages its K and V."""
    return (cfg["num_hidden_layers"],) + _heads(cfg)[1:]


def engine_kwargs(cfg: dict) -> dict:
    return {}


def prefill_bound_s(cfg: dict, padded: int) -> dict:
    """One causal ``flash_attention`` call a layer."""
    return {"flash_attention": cfg["num_hidden_layers"] * work.bound_s(
        *work.flash_attention_work(padded, *_heads(cfg)))}


def decode_bound_s(cfg: dict, pages: list[np.ndarray], lens: np.ndarray,
                   page: int, pages_per_seq: int) -> dict:
    """One ``paged_attention`` call a layer over the step's rows."""
    seen = work.paged_positions(pages, lens, page)
    return {"paged_attention": cfg["num_hidden_layers"] * work.bound_s(
        *work.paged_attention_work(seen, len(lens), pages_per_seq,
                                   *_heads(cfg)))}


def _layer_params(cfg: dict) -> int:
    """Parameters a token meets in one block (projections, the dense FFN
    or the router, top-k and shared experts)."""
    d = cfg["hidden_size"]
    hq, hkv, hd = _heads(cfg)
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
    """Model FLOPs of serving, active parameters only (a token meets the
    shared and its top-k experts, not every expert the dense dispatch
    computes): each prompt of length S through every block (2 per
    parameter and token, causal attention 4 hd per pair and head) and one
    row of the head; each generated token at context c (positions before
    it) through every block, attention over c + 1 positions, and the
    head."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq, _, hd = _heads(cfg)
    per_tok = 2 * L * _layer_params(cfg)
    head = 2 * d * cfg["vocab_size"]
    s = np.asarray(prompt_lens, np.float64)
    c = np.asarray(decode_ctx, np.float64)
    pre = (per_tok * s + L * 4 * hd * hq * s * (s + 1) / 2 + head).sum()
    dec = (per_tok + L * 4 * hd * hq * (c + 1) + head).sum()
    return float(pre + dec)
