"""The benchmark's weights: made on the device from the run's seed.

Plain tensors in the port's parameter layout (a nested dict, every
per-layer tensor stacked on a leading layer axis), one draw from a
``torch.Generator`` on the device per leaf, in the type they are served
in.  The port's ``init_params`` is not called: the same tensors go to
the program and, widened to fp32 layer by layer, to the reference.

Each matrix is normal with std 1/sqrt(its contraction axis), and the
products that write into the residual stream (``wo``, ``w_down``,
``shared_down``) a further 1/sqrt(2 L) smaller (GPT-2's scaled init), so
that the L blocks' outputs do not drown the tokens' embeddings: without
it the random MoE's token states collapse onto the attention average and
its router sends most tokens to the same few experts.  The embedding has
the configuration file's ``assumed.embedding_std``; the norms' offsets
(the port scales by 1 + w) are fp32 normal with std 0.1, so the norm
weights are not all one.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_params", "padded_vocab"]

NORM_STD = 0.1


def padded_vocab(cfg: dict) -> int:
    """The port's vocabulary rows: ``vocab_size`` rounded up to 256."""
    return -(-cfg["vocab_size"] // 256) * 256


def make_params(cfg: dict, seed: int, device: torch.device | str) -> dict:
    """The parameter tree of the configuration file ``cfg`` (its
    published keys), drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**64)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    vp = padded_vocab(cfg)

    def mat(*shape, std=None, residual=False):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        if std is None:
            std = 1 / math.sqrt(shape[-2] * (2 * L if residual else 1))
        return t.mul_(std)

    def norm(*shape):
        return torch.randn(shape, generator=gen, device=dev).mul_(NORM_STD)

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
