"""The model-level serving functions for the dense, SSM and hybrid families.

The port of the reference's ``src/repro/models/model.py``: ``init_params``,
``forward_hidden``, ``prefill`` (last-position logits), ``init_decode_cache``
and ``decode_step`` (one greedy step; logits past ``vocab_size`` masked).
Parameters are a nested dict with the reference's names and stacked layout
(every per-layer tensor has a leading layer axis; the hybrid's shared
attention block is one copy), so ``params_from_jax`` carries the
reference's weights across leaf by leaf.  PyTorch runs eagerly, so the
reference's ``lax.scan`` over layers is a Python loop.  Entry points run on
the CUDA card unless the caller asks for the CPU.

Prefill does not fill the decode cache (neither does the reference's): a
request's prompt is teacher-forced through ``decode_step``.  Left out,
each raising or absent as ROADMAP §1 says: the MoE, MLA and
encoder-decoder families (item 2), training's remat and losses (item 5),
and the split-KV ``commit=False`` path with the sharding hints (item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (attention_decode, attention_train,
                                          init_attention, init_kv_cache,
                                          not_ported)
from repro_torch.models.config import AttnKind, Family, ModelConfig
from repro_torch.models.layers import Param, dense_init, rms_norm, swiglu
from repro_torch.models.mamba2 import (init_mamba2_layer, init_ssm_state,
                                       mamba2_decode_step, mamba2_forward)

__all__ = ["decode_step", "forward_hidden", "hybrid_groups",
           "init_decode_cache", "init_params", "params_from_jax", "prefill"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in (Family.MOE, Family.ENCDEC):
        raise not_ported(f"the {cfg.family.value} family")
    if cfg.family != Family.SSM and cfg.attn == AttnKind.MLA:
        raise not_ported("MLA attention")


def hybrid_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, remainder) for the zamba2 layout:
    [group_size mamba layers + shared attn block] x n_groups + remainder."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


def _shared_after(cfg: ModelConfig) -> dict[int, int]:
    """Mamba-2 layer index -> the hybrid group whose shared attention
    block is applied right after it (empty for the other families)."""
    if cfg.family != Family.HYBRID:
        return {}
    n_groups, g, _ = hybrid_groups(cfg)
    return {(j + 1) * g - 1: j for j in range(n_groups)}


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, layers: int | None) -> Param:
    d, lead = cfg.d_model, (() if layers is None else (layers,))
    return {
        "ln1": torch.zeros((*lead, d), device=gen.device),
        "attn": init_attention(gen, cfg, dtype, layers),
        "ln2": torch.zeros((*lead, d), device=gen.device),
        "mlp": {
            "w_gate": dense_init(gen, (d, cfg.d_ff), dtype, layers=layers),
            "w_up": dense_init(gen, (d, cfg.d_ff), dtype, layers=layers),
            "w_down": dense_init(gen, (cfg.d_ff, d), dtype, layers=layers),
        },
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Param:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the CUDA card), matrices in ``cfg.dtype``.  Norm
    weights are zeros (``rms_norm`` scales by ``1 + w``), matrices fan-in
    truncated normals, the embedding std 0.02, as the reference's laws;
    the numbers differ (it draws from ``jax.random``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, n = cfg.d_model, cfg.n_layers
    params: Param = {
        "embed": dense_init(gen, (cfg.padded_vocab(), d), dtype, scale=0.02),
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.padded_vocab()), dtype)
    if cfg.family == Family.DENSE:
        params["layers"] = _init_attn_block(gen, cfg, dtype, n)
    else:
        params["layers"] = {"ln1": torch.zeros((n, d), device=dev),
                            "mixer": init_mamba2_layer(gen, cfg, dtype, n)}
    if cfg.family == Family.HYBRID:
        params["shared_attn"] = _init_attn_block(gen, cfg, dtype, None)
    return params


def _to_torch(x, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)      # a writable copy


def params_from_jax(tree: dict,
                    device: str | torch.device | None = None) -> Param:
    """The JAX package's parameter tree (``init_params``, leaves as numpy
    arrays) -> the port's parameters, same names and layout, on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_torch(node, dev)
    return conv(tree)


def _layer(params: Param, i: int) -> Param:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[i]
    return pick(params["layers"])


def _attn_mlp_block(p: Param, h: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    h = h + attention_train(p["attn"], rms_norm(h, p["ln1"], cfg.rms_eps),
                            cfg)
    hn = rms_norm(h, p["ln2"], cfg.rms_eps)
    return h + swiglu(hn, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"])


def _ssm_block(p: Param, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + mamba2_forward(p["mixer"], rms_norm(h, p["ln1"], cfg.rms_eps),
                              cfg)


def _lm_head(params: Param, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward_hidden(params: Param, cfg: ModelConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [B, S] -> final hidden states [B, S, d]."""
    _check_family(cfg)
    h = params["embed"][tokens]
    if cfg.family == Family.DENSE:
        for i in range(cfg.n_layers):
            h = _attn_mlp_block(_layer(params, i), h, cfg)
    else:
        shared = _shared_after(cfg)
        for i in range(cfg.n_layers):
            h = _ssm_block(_layer(params, i), h, cfg)
            if i in shared:
                h = _attn_mlp_block(params["shared_attn"], h, cfg)
    return rms_norm(h, params["final_norm"], cfg.rms_eps)


def prefill(params: Param, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward -> fp32 logits of the last position [B, V_padded]
    (unmasked, as the reference's)."""
    h = forward_hidden(params, cfg, tokens)
    return h[:, -1].float() @ _lm_head(params, cfg).float()


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None) -> dict:
    """Zero decode state on ``device`` (default: the CUDA card): ``len``
    [B], the KV caches of every attention layer (or of each hybrid group's
    shared-block application) in ``cfg.dtype``, and
    the fp32 conv and SSM states of every Mamba-2 layer."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    cache: dict = {"len": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    if cfg.family == Family.DENSE:
        cache["kv"] = init_kv_cache(cfg, cfg.n_layers, batch, max_len, dtype,
                                    dev)
        return cache
    cache["ssm"] = init_ssm_state(cfg, batch, layers=cfg.n_layers, device=dev)
    if cfg.family == Family.HYBRID:
        cache["kv"] = init_kv_cache(cfg, hybrid_groups(cfg)[0], batch,
                                    max_len, dtype, dev)
    return cache


def _decode_attn_block(p: Param, h: torch.Tensor, cfg: ModelConfig,
                       kv: dict, i: int, cache_len: torch.Tensor
                       ) -> torch.Tensor:
    a, _ = attention_decode(p["attn"], rms_norm(h, p["ln1"], cfg.rms_eps),
                            cfg, {"k": kv["k"][i], "v": kv["v"][i]},
                            cache_len)
    h = h + a
    hn = rms_norm(h, p["ln2"], cfg.rms_eps)
    return h + swiglu(hn, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"])


def _decode_ssm_block(p: Param, h: torch.Tensor, cfg: ModelConfig,
                      ssm: dict, i: int) -> torch.Tensor:
    x, new = mamba2_decode_step(p["mixer"], rms_norm(h, p["ln1"],
                                                     cfg.rms_eps),
                                {"conv": ssm["conv"][i], "ssm": ssm["ssm"][i]},
                                cfg)
    ssm["conv"][i] = new["conv"]
    ssm["ssm"][i] = new["ssm"]
    return h + x


def decode_step(params: Param, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One greedy decode step.  tokens [B] -> (fp32 logits [B, V_padded]
    with the padded vocab at -1e30, the cache).  The cache's K/V and SSM
    tensors are updated in place; the returned dict carries ``len`` + 1."""
    _check_family(cfg)
    h = params["embed"][tokens][:, None, :]                  # [B,1,d]
    cache_len = cache["len"]
    if cfg.family == Family.DENSE:
        for i in range(cfg.n_layers):
            h = _decode_attn_block(_layer(params, i), h, cfg, cache["kv"], i,
                                   cache_len)
    else:
        shared = _shared_after(cfg)
        for i in range(cfg.n_layers):
            h = _decode_ssm_block(_layer(params, i), h, cfg, cache["ssm"], i)
            if i in shared:
                h = _decode_attn_block(params["shared_attn"], h, cfg,
                                       cache["kv"], shared[i], cache_len)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ _lm_head(params, cfg).float()
    logits[:, cfg.vocab_size:] = -1e30
    return logits, {**cache, "len": cache_len + 1}
