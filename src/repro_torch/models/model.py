"""The model-level serving functions for every family of the reference.

The port of the reference's ``src/repro/models/model.py``: ``init_params``,
``forward_hidden``, ``prefill`` (last-position logits), ``init_decode_cache``
and ``decode_step`` (one greedy step; logits past ``vocab_size`` masked),
for the dense (GQA, sliding-window or MLA attention), MoE, SSM, hybrid and
encoder-decoder families.  Parameters are a nested dict with the
reference's names and stacked layout (every per-layer tensor has a leading
layer axis; the hybrid's shared attention block is one copy), so
``params_from_jax`` carries the reference's weights across leaf by leaf.
PyTorch runs eagerly, so the reference's ``lax.scan`` over layers is a
Python loop.  Entry points run on the CUDA card unless the caller asks for
the CPU.

The encoder-decoder family takes the encoder's input as stub embeddings
(``enc_embeds`` [B, S_enc, d], the speech frontend left out as in the
reference): the encoder stack (bidirectional), ``enc_norm``, then the
decoder with cross attention over that output in every layer.  Its decode
cache holds each decoder layer's cross K and V, which the caller fills
with ``attention.cross_attention_kv`` from the encoder's output.

Prefill does not fill the decode cache (neither does the reference's): a
request's prompt is teacher-forced through ``decode_step``.  ``prefill``
and ``decode_step`` run under ``torch.no_grad()``.

Training: ``loss_fn`` is ``forward_hidden`` then ``chunked_cross_entropy``
(512-token chunks, each under ``torch.utils.checkpoint``, so the
[B, S, vocab] logits never exist at once).  ``forward_hidden``
rematerialises each block as ``cfg.remat`` says (``_maybe_remat``) while
grad mode is on; the kernels on its path record their autograd nodes
through ``kernels.autograd``.

Distribution (the reference's ``tp`` and ``constrain`` hints):
``init_params(tp=)`` builds the tree a tensor-parallel degree needs (q
heads padded to ``cfg.padded_heads(tp)``, MoE experts to
``cfg.padded_experts(tp)``, whose router logits are masked), and every
forward takes the same ``tp``.  The hints ("act", "gathered", "dec_mlp",
and in the layers "attn_qkv", "mlp_mid", "moe_xe") sit where the
reference's do; on one controller they change no value
(``distributed.ctx``).  ``init_params(device="meta")`` builds the tree's
shapes only, allocating nothing (the dry run's stand-ins).

``decode_step(commit=False)`` is the split-KV decode: the attention
caches stay frozen, each layer's new K/V (or latent) comes back as a
1-token delta stacked [L, B, 1, ...] in the cache's ``kv`` place, and
``len`` is left for the caller's commit; SSM states update in place as
with ``commit=True``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.distributed.ctx import constrain
from repro_torch.models.attention import (attention_cross, attention_decode,
                                          attention_train,
                                          cross_attention_decode,
                                          init_attention, init_kv_cache)
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.layers import (MetaGenerator, Param, dense_init,
                                       moe_ffn, rms_norm, swiglu)
from repro_torch.models.mamba2 import (init_mamba2_layer, init_ssm_state,
                                       mamba2_decode_step, mamba2_forward)

__all__ = ["chunked_cross_entropy", "decode_step", "forward_hidden",
           "hybrid_groups", "init_decode_cache", "init_params", "loss_fn",
           "params_from_jax", "prefill"]

_ATTN_FAMILIES = (Family.DENSE, Family.MOE, Family.ENCDEC)


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


def _init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              layers: int | None, tp: int = 1) -> Param:
    d = cfg.d_model
    if cfg.family != Family.MOE:
        return {
            "w_gate": dense_init(gen, (d, cfg.d_ff), dtype, layers=layers),
            "w_up": dense_init(gen, (d, cfg.d_ff), dtype, layers=layers),
            "w_down": dense_init(gen, (cfg.d_ff, d), dtype, layers=layers),
        }
    # the reference's _init_moe, experts padded to the EP degree (= tp);
    # its fan-in is each tensor's first axis, the expert count for experts
    e, f = cfg.padded_experts(tp), cfg.expert_d_ff
    p = {
        "router": dense_init(gen, (d, e), dtype, layers=layers),
        "w_gate": dense_init(gen, (e, d, f), dtype, layers=layers),
        "w_up": dense_init(gen, (e, d, f), dtype, layers=layers),
        "w_down": dense_init(gen, (e, f, d), dtype, layers=layers),
    }
    if cfg.shared_d_ff:
        sf = cfg.shared_d_ff
        p["shared_gate"] = dense_init(gen, (d, sf), dtype, layers=layers)
        p["shared_up"] = dense_init(gen, (d, sf), dtype, layers=layers)
        p["shared_down"] = dense_init(gen, (sf, d), dtype, layers=layers)
    return p


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, layers: int | None,
                     cross: bool = False, tp: int = 1) -> Param:
    d, lead = cfg.d_model, (() if layers is None else (layers,))
    p = {
        "ln1": torch.zeros((*lead, d), device=gen.device),
        "attn": init_attention(gen, cfg, dtype, layers, tp=tp),
        "ln2": torch.zeros((*lead, d), device=gen.device),
        "mlp": _init_mlp(gen, cfg, dtype, layers, tp),
    }
    if cross:
        p["ln_x"] = torch.zeros((*lead, d), device=gen.device)
        p["cross"] = init_attention(gen, cfg, dtype, layers, tp=tp)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None, *,
                tp: int = 1) -> Param:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the CUDA card), matrices in ``cfg.dtype``, built
    for tensor-parallel degree ``tp``.  Norm weights are zeros
    (``rms_norm`` scales by ``1 + w``), matrices fan-in truncated normals,
    the embedding std 0.02, as the reference's laws; the numbers differ
    (it draws from ``jax.random``).  On ``"meta"`` the tree has the
    shapes and dtypes only: nothing is drawn or allocated."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    if dev.type == "meta":
        gen = MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, n = cfg.d_model, cfg.n_layers
    params: Param = {
        "embed": dense_init(gen, (cfg.padded_vocab(), d), dtype, scale=0.02),
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.padded_vocab()), dtype)
    if cfg.family == Family.ENCDEC:
        params["enc_layers"] = _init_attn_block(gen, cfg, dtype,
                                                cfg.n_enc_layers, tp=tp)
        params["layers"] = _init_attn_block(gen, cfg, dtype, n, cross=True,
                                            tp=tp)
        params["enc_norm"] = torch.zeros((d,), device=dev)
    elif cfg.family in _ATTN_FAMILIES:
        params["layers"] = _init_attn_block(gen, cfg, dtype, n, tp=tp)
    else:
        params["layers"] = {"ln1": torch.zeros((n, d), device=dev),
                            "mixer": init_mamba2_layer(gen, cfg, dtype, n)}
    if cfg.family == Family.HYBRID:
        params["shared_attn"] = _init_attn_block(gen, cfg, dtype, None,
                                                 tp=tp)
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


def _layer(params: Param, i: int, stack: str = "layers") -> Param:
    """Layer ``i``'s parameters of a stack: views into the stacked
    tensors."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[i]
    return pick(params[stack])


def _ffn(p: Param, hn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's feed-forward: the routed experts (and shared ones) for
    the MoE family, SwiGLU otherwise."""
    if cfg.family == Family.MOE:
        return moe_ffn(hn, p["mlp"], cfg)
    return swiglu(hn, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                  p["mlp"]["w_down"])


def _attn_mlp_block(p: Param, h: torch.Tensor, cfg: ModelConfig,
                    tp: int = 1, *, causal: bool | None = None,
                    enc_out: torch.Tensor | None = None) -> torch.Tensor:
    x = constrain(rms_norm(h, p["ln1"], cfg.rms_eps), "gathered")
    h = h + attention_train(p["attn"], x, cfg, tp, causal=causal)
    if enc_out is not None:
        h = h + attention_cross(
            p["cross"],
            constrain(rms_norm(h, p["ln_x"], cfg.rms_eps), "gathered"),
            enc_out, cfg, tp)
    hn = constrain(rms_norm(h, p["ln2"], cfg.rms_eps), "gathered")
    return h + _ffn(p, constrain(hn, "dec_mlp"), cfg)


def _ssm_block(p: Param, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + mamba2_forward(p["mixer"], rms_norm(h, p["ln1"], cfg.rms_eps),
                              cfg)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots_with_no_batch_dims_saveable``: keep the products without
    batch dims (``mm``, ``addmm``: every ``x @ W`` of a block), recompute
    the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` (a block: h -> h) under ``cfg.remat`` while grad mode is on:
    ``"full"`` saves nothing inside it (recomputed in the backward),
    ``"dots"`` saves the outputs of the products without batch dims, as
    the reference's ``jax.checkpoint`` policies; ``"none"`` and no-grad
    runs (prefill, the server) return ``fn``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: none, full or dots")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _lm_head(params: Param, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _encode(params: Param, cfg: ModelConfig, enc_embeds: torch.Tensor,
            tp: int = 1) -> torch.Tensor:
    """The encoder stack (bidirectional) and ``enc_norm``: enc_embeds
    [B, S_enc, d] -> the encoder's output [B, S_enc, d]."""
    e = enc_embeds
    for i in range(cfg.n_enc_layers):
        p = _layer(params, i, "enc_layers")
        e = constrain(_maybe_remat(lambda x, p=p: _attn_mlp_block(
            p, x, cfg, tp, causal=False), cfg)(constrain(e, "act")), "act")
    return rms_norm(e, params["enc_norm"], cfg.rms_eps)


def forward_hidden(params: Param, cfg: ModelConfig, tokens: torch.Tensor,
                   tp: int = 1, *, enc_embeds: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Token ids [B, S] (and, for the encoder-decoder family, the
    encoder's stub embeddings ``enc_embeds`` [B, S_enc, d]) -> final
    hidden states [B, S, d].  Each block runs under ``_maybe_remat``
    where the reference's does: every block of the dense, MoE, SSM and
    encoder-decoder stacks, and the hybrid's grouped Mamba-2 blocks and
    shared attention block, not its tail."""
    h = constrain(params["embed"][tokens], "act")
    if cfg.family == Family.ENCDEC:
        if enc_embeds is None:
            raise ValueError("the encoder-decoder family needs the "
                             "encoder's stub embeddings (enc_embeds)")
        enc_out = _encode(params, cfg, enc_embeds, tp)
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            h = constrain(_maybe_remat(lambda x, p=p: _attn_mlp_block(
                p, x, cfg, tp, causal=True, enc_out=enc_out), cfg)(
                    constrain(h, "act")), "act")
    elif cfg.family in _ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            h = constrain(_maybe_remat(lambda x, p=p: _attn_mlp_block(
                p, x, cfg, tp), cfg)(constrain(h, "act")), "act")
    else:
        shared = _shared_after(cfg)
        n_groups, g, _ = hybrid_groups(cfg) \
            if cfg.family == Family.HYBRID else (0, 0, 0)
        for i in range(cfg.n_layers):
            def block(x, p=_layer(params, i)):
                return _ssm_block(p, x, cfg)
            # the hybrid's tail (past its last group) is not rematerialised
            if cfg.family == Family.SSM or i < n_groups * g:
                block = _maybe_remat(block, cfg)
                h = constrain(block(constrain(h, "act")), "act")
            else:
                h = block(h)
            if i in shared:
                h = constrain(_maybe_remat(lambda x: _attn_mlp_block(
                    params["shared_attn"], x, cfg, tp), cfg)(h), "act")
    return rms_norm(h, params["final_norm"], cfg.rms_eps)


def _ce_chunk(h_c: torch.Tensor, head32: torch.Tensor, y_c: torch.Tensor,
              vocab_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (its unmasked tokens, its summed cross entropy)."""
    logits = h_c.float() @ head32                            # [B, c, Vp]
    logits = logits.masked_fill(
        torch.arange(logits.shape[-1], device=logits.device) >= vocab_real,
        -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        y_c.clamp(min=0).long()[..., None])[..., 0]
    mask = (y_c >= 0).float()
    return mask.sum(), ((lse - gold) * mask).sum()


def chunked_cross_entropy(h: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, vocab_real: int,
                          chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy without the [B, S, V] logits: h [B, S, d],
    lm_head [d, Vp], labels [B, S] (< 0 masked) -> a float32 scalar.

    The sequence is padded to whole chunks of ``chunk`` (labels -1) and
    each chunk's logits are formed, reduced and dropped; under grad mode
    each chunk runs under ``torch.utils.checkpoint`` and is recomputed in
    the backward, as the reference's ``@jax.checkpoint`` body.  Columns
    past ``vocab_real`` are -1e30.  The logits are fp32: the product of
    the operands widened to fp32 (exact products of bf16 values, fp32
    sums), the reference's ``preferred_element_type=f32``; the head is
    widened once for all chunks."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    head32 = lm_head.float()
    n_tok = torch.zeros((), device=h.device)
    s_ce = torch.zeros((), device=h.device)
    for c in range(n):
        part = (h[:, c * chunk:(c + 1) * chunk], head32,
                labels[:, c * chunk:(c + 1) * chunk], vocab_real)
        if torch.is_grad_enabled():
            nt, sc = checkpoint(_ce_chunk, *part, use_reentrant=False)
        else:
            nt, sc = _ce_chunk(*part)
        n_tok, s_ce = n_tok + nt, s_ce + sc
    return s_ce / torch.clamp(n_tok, min=1.0)


def loss_fn(params: Param, cfg: ModelConfig, batch: dict,
            tp: int = 1) -> torch.Tensor:
    """batch: {"tokens": [B, S] int, "labels": [B, S] int (-1 pad),
    optional "enc_embeds": [B, S_enc, d]}, tensors on the parameters'
    device -> the mean next-token cross entropy (float32 scalar).  The
    stub embeddings enter in the parameters' dtype (the data pipeline
    makes them float32)."""
    enc = batch.get("enc_embeds")
    if enc is not None:
        enc = enc.to(params["embed"].dtype)
    h = forward_hidden(params, cfg, batch["tokens"], tp, enc_embeds=enc)
    return chunked_cross_entropy(h, _lm_head(params, cfg), batch["labels"],
                                 cfg.vocab_size)


@torch.no_grad()
def prefill(params: Param, cfg: ModelConfig, tokens: torch.Tensor,
            tp: int = 1, *, enc_embeds: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Prefill forward -> fp32 logits of the last position [B, V_padded]
    (unmasked, as the reference's)."""
    h = forward_hidden(params, cfg, tokens, tp, enc_embeds=enc_embeds)
    return h[:, -1].float() @ _lm_head(params, cfg).float()


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device | None = None,
                      enc_len: int = 0, *, tp: int = 1) -> dict:
    """Zero decode state on ``device`` (default: the CUDA card): ``len``
    [B], the KV caches of every attention layer (MLA: its latent caches;
    the hybrid: each group's shared-block application) in ``cfg.dtype``,
    the fp32 conv and SSM states of every Mamba-2 layer, and for the
    encoder-decoder family each decoder layer's cross K and V
    [L, B, enc_len, Hkv, D] (zeros, for the caller to fill) and
    ``enc_len`` [B].  No shape depends on ``tp`` (the caches keep the
    original KV heads, as the reference's); it is taken for the
    reference's signature."""
    del tp
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    cache: dict = {"len": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}
    if cfg.family in _ATTN_FAMILIES:
        cache["kv"] = init_kv_cache(cfg, cfg.n_layers, batch, max_len, dtype,
                                    dev)
        if cfg.family == Family.ENCDEC:
            shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads,
                     cfg.head_dim)
            cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["enc_len"] = torch.full((batch,), enc_len,
                                          dtype=torch.int32, device=dev)
        return cache
    cache["ssm"] = init_ssm_state(cfg, batch, layers=cfg.n_layers, device=dev)
    if cfg.family == Family.HYBRID:
        cache["kv"] = init_kv_cache(cfg, hybrid_groups(cfg)[0], batch,
                                    max_len, dtype, dev)
    return cache


def _decode_attn_block(p: Param, h: torch.Tensor, cfg: ModelConfig,
                       cache: dict, i: int, cache_len: torch.Tensor,
                       tp: int, commit: bool) -> tuple[torch.Tensor, dict]:
    """Block ``i``'s decode: self attention over layer ``i`` of the cache
    (written in place, or its 1-token delta returned when not
    ``commit``), cross attention over its encoder K/V where the cache
    has them, then the feed-forward."""
    a, delta = attention_decode(
        p["attn"], rms_norm(h, p["ln1"], cfg.rms_eps), cfg,
        {k: t[i] for k, t in cache["kv"].items()}, cache_len, tp=tp,
        update_cache=commit)
    h = h + a
    if "cross_k" in cache:
        h = h + cross_attention_decode(
            p["cross"], rms_norm(h, p["ln_x"], cfg.rms_eps), cfg,
            cache["cross_k"][i], cache["cross_v"][i], cache["enc_len"], tp)
    hn = constrain(rms_norm(h, p["ln2"], cfg.rms_eps), "dec_mlp")
    return h + _ffn(p, hn, cfg), delta


def _decode_ssm_block(p: Param, h: torch.Tensor, cfg: ModelConfig,
                      ssm: dict, i: int) -> torch.Tensor:
    x, new = mamba2_decode_step(p["mixer"], rms_norm(h, p["ln1"],
                                                     cfg.rms_eps),
                                {"conv": ssm["conv"][i], "ssm": ssm["ssm"][i]},
                                cfg)
    ssm["conv"][i] = new["conv"]
    ssm["ssm"][i] = new["ssm"]
    return h + x


@torch.no_grad()
def decode_step(params: Param, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, tp: int = 1,
                commit: bool = True) -> tuple[torch.Tensor, dict]:
    """One greedy decode step.  tokens [B] -> (fp32 logits [B, V_padded]
    with the padded vocab at -1e30, the cache).  SSM states are updated
    in place.  With ``commit`` the K/V (or latent) caches are written in
    place too and the returned dict carries ``len`` + 1; without it they
    are left as they are, the returned dict's ``kv`` holds each attention
    layer's 1-token delta stacked [L, B, 1, ...] and ``len`` is
    unchanged."""
    h = params["embed"][tokens][:, None, :]                  # [B,1,d]
    cache_len = cache["len"]
    deltas = []
    if cfg.family in _ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            h, delta = _decode_attn_block(_layer(params, i), h, cfg, cache,
                                          i, cache_len, tp, commit)
            deltas.append(delta)
    else:
        shared = _shared_after(cfg)
        for i in range(cfg.n_layers):
            h = _decode_ssm_block(_layer(params, i), h, cfg, cache["ssm"], i)
            if i in shared:
                h, delta = _decode_attn_block(
                    params["shared_attn"], h, cfg, {"kv": cache["kv"]},
                    shared[i], cache_len, tp, commit)
                deltas.append(delta)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ _lm_head(params, cfg).float()
    logits[:, cfg.vocab_size:] = -1e30
    if commit:
        return logits, {**cache, "len": cache_len + 1}
    if not deltas:
        return logits, dict(cache)
    return logits, {**cache, "kv": {k: torch.stack([d[k] for d in deltas])
                                    for k in deltas[0]}}
