"""Shared neural layers: init, norms, RoPE, attention, SwiGLU.

The port of the reference's ``src/repro/models/layers.py``.  The formulas
are the reference's: ``rms_norm`` scales by ``1 + scale`` (norm weights
start at zero), RoPE rotates the two halves of D (not interleaved pairs),
``blockwise_attention`` (kept beside the kernel, in
``kernels/flash_attention/ref.py``) is the same online softmax over KV
blocks, and ``decode_attention`` the same masked softmax over the cache,
so at float32 the CPU path repeats the reference's arithmetic.  The
reference's sharding ``constrain`` calls are identities on one device and
are left out; ``moe_ffn`` waits for the MoE family (ROADMAP §1).

Matrix products run in the parameters' dtype (on the card cuBLAS
accumulates bfloat16 products in fp32 and rounds once).  The reference
rounds its projections to that dtype as well; only SwiGLU's gate and up
products stay fp32 there, which at bfloat16 the port rounds too.  At
float32, the dtype every comparison with the reference uses, the two are
the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import blockwise_attention

__all__ = ["Param", "apply_rope", "blockwise_attention", "decode_attention",
           "dense_init", "rms_norm", "rope_freqs", "swiglu"]

Param = dict  # nested-dict parameter trees, as the reference's


# --------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype, scale: float | None = None, *,
               layers: int | None = None) -> torch.Tensor:
    """Truncated-normal (-2, 2) fan-in init on the generator's device.

    ``layers`` stacks that many independent draws on a leading axis (the
    reference's vmapped init); each is drawn in fp32 and stored in
    ``dtype`` one layer at a time, so no fp32 copy of the stack is held.
    """
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape if layers is None else (layers, *shape),
                      dtype=dtype, device=gen.device)
    for part in ([out] if layers is None else out):
        draw = torch.empty(shape, device=gen.device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(draw * std)
    return out


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (D even), positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Single-step decode: q [B, 1, Hq, D] over caches [B, Smax, Hkv, D];
    ``cache_len`` [B] masks the valid prefix.  fp32 scores and softmax."""
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[2] // hkv
    if rep > 1:
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    pos = torch.arange(smax, device=q.device)[None, None, None, :]
    lim = cache_len[:, None, None, None]
    mask = pos < lim
    if window > 0:
        mask = mask & (pos >= lim - window)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# -------------------------------------------------------------------- FFNs
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = (x @ w_gate).float()
    u = (x @ w_up).float()
    return (F.silu(g) * u).to(x.dtype) @ w_down
