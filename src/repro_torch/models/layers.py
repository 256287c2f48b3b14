"""Shared neural layers: init, norms, RoPE, attention, SwiGLU.

The port of the reference's ``src/repro/models/layers.py``.  The formulas
are the reference's: ``rms_norm`` scales by ``1 + scale`` (norm weights
start at zero), RoPE rotates the two halves of D (not interleaved pairs),
``blockwise_attention`` (kept beside the kernel, in
``kernels/flash_attention/ref.py``) is the same online softmax over KV
blocks, and ``decode_attention`` the same masked softmax over the cache,
so at float32 the CPU path repeats the reference's arithmetic.  The
reference's sharding hints (``constrain`` "mlp_mid" and "moe_xe") sit
where its do and change no value (``distributed.ctx``).  ``moe_ffn`` is
the reference's grouped capacity-based top-k dispatch (GShard), each batch
row one routing group.

Matrix products run in the parameters' dtype (on the card cuBLAS
accumulates bfloat16 products in fp32 and rounds once).  The reference
rounds its projections to that dtype as well; only SwiGLU's gate and up
products stay fp32 there, which at bfloat16 the port rounds too.  At
float32, the dtype every comparison with the reference uses, the two are
the same.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import constrain
from repro_torch.kernels.flash_attention.ref import blockwise_attention
from repro_torch.models.config import ModelConfig

__all__ = ["MetaGenerator", "Param", "apply_rope", "blockwise_attention", "decode_attention",
           "dense_init", "moe_capacity", "moe_ffn", "moe_route", "rms_norm",
           "rope_freqs", "swiglu"]

Param = dict  # nested-dict parameter trees, as the reference's


# --------------------------------------------------------------------- init
class MetaGenerator:
    """Stands in for a ``torch.Generator`` when parameters are built on
    ``meta`` (shapes and dtypes only): the initialisers draw nothing."""

    device = torch.device("meta")


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
    if out.is_meta:
        return out
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
    return constrain((F.silu(g) * u).to(x.dtype), "mlp_mid") @ w_down


def moe_capacity(cfg: ModelConfig, tokens: int, experts: int) -> int:
    """Slots an expert has in a routing group of ``tokens``:
    ``max(ceil(cf * S * k / E), 4)``, in Python floats as the reference's
    ``np.ceil``."""
    return max(int(math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                             / experts)), 4)


@dataclasses.dataclass
class MoERoute:
    """One ``moe_ffn`` call's routing: fp32 ``gates`` [B, S, k] (0 where
    dropped), expert ``idx`` [B, S, k], ``keep`` [B, S, k], and ``dest``
    [B, S, k], each kept choice's row of the expert buffer laid out
    [E, B, capacity] (``E * B * capacity``, the trash row, when dropped)."""
    gates: torch.Tensor
    idx: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    capacity: int


def moe_route(x: torch.Tensor, p: Param, cfg: ModelConfig) -> MoERoute:
    """The reference's router (``src/repro/models/layers.py:240-259``):
    fp32 logits, padded experts (E > ``n_experts``, E read from
    ``w_gate``) at -1e30, top-k with ties to the lower index (a stable
    descending sort, as ``jax.lax.top_k``), a softmax over the k gates,
    each token's position in its expert's queue by an fp32 cumsum of the
    one-hot over the group's tokens, and ``keep = pos < capacity``."""
    b, s, _ = x.shape
    e = p["w_gate"].shape[0]
    logits = x.float() @ p["router"].float()                  # [B,S,E]
    if e > cfg.n_experts:
        logits[..., cfg.n_experts:] = -1e30
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = torch.softmax(top, dim=-1)
    cap = moe_capacity(cfg, s, e)
    onehot = F.one_hot(idx, e).float()                        # [B,S,k,E]
    per_tok = onehot.sum(2)                                   # [B,S,E]
    pos = torch.cumsum(per_tok, dim=1) - per_tok
    pos_k = pos.gather(2, idx).long()                         # [B,S,k]
    keep = pos_k < cap
    rows = torch.arange(b, device=x.device)[:, None, None]
    dest = torch.where(keep, (idx * b + rows) * cap + pos_k, e * b * cap)
    return MoERoute(torch.where(keep, gates, 0.0), idx, keep, dest, cap)


def moe_ffn(x: torch.Tensor, p: Param, cfg: ModelConfig) -> torch.Tensor:
    """Capacity-based top-k MoE, each batch row one routing group (the
    reference's ``moe_ffn`` at one device).  x [B, S, d] -> [B, S, d].

    Every kept choice is copied to its own row of an expert buffer
    [E, B * capacity, d] (dropped ones to a trash row that is cut off:
    each kept row has exactly one source, so the copy is exact); the three
    expert products are batched over E, ``g`` and ``u`` fp32 before
    ``silu(g) * u`` as in ``swiglu``; each choice's output is gathered back
    (0 when dropped) and combined with its gate in fp32; the shared
    experts' SwiGLU is added when ``shared_d_ff`` is set."""
    b, s, d = x.shape
    e, k = p["w_gate"].shape[0], cfg.top_k
    r = moe_route(x, p, cfg)
    rows = e * b * r.capacity
    flat = r.dest.reshape(-1)
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, flat, x[:, :, None, :].expand(b, s, k, d)
                    .reshape(-1, d))
    xe = constrain(buf[:rows].view(e, b * r.capacity, d), "moe_xe")
    g = torch.bmm(xe, p["w_gate"]).float()
    u = torch.bmm(xe, p["w_up"]).float()
    ye = constrain(torch.bmm((F.silu(g) * u).to(x.dtype), p["w_down"]),
                   "moe_xe")
    ye = torch.cat([ye.reshape(rows, d), ye.new_zeros((1, d))])
    y_tk = ye[flat].view(b, s, k, d).float()
    y = (y_tk * r.gates[..., None]).sum(2).to(x.dtype)
    if cfg.shared_d_ff:
        y = y + swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y
