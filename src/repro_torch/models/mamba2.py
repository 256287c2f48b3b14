"""Mamba-2 SSD (state-space duality) block: chunked prefill, O(1) decode.

The port of the reference's ``src/repro/models/mamba2.py``.  Prefill
projects, runs the causal depthwise conv and hands the chunked scan to
``kernels.mamba2_ssd.ops.mamba2_ssd_op`` in the kernel's layout ((batch
* head) rows, B and C shared by the heads of a batch row, no broadcast
copy): on a CUDA tensor that launches the hand-written ``mamba2_ssd``
kernel, on a CPU tensor it runs the plain chunked form, the reference's
inline scan.  The device decides, so the reference's ``use_kernel``
switch has no counterpart.  Decode keeps the conv window and the fp32
SSM state per layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd_op
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Param, dense_init, rms_norm

__all__ = ["init_mamba2_layer", "init_ssm_state", "mamba2_decode_step",
           "mamba2_forward"]


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_d_inner
    return d_inner, cfg.ssm_n_heads, d_inner + 2 * cfg.ssm_state


def init_mamba2_layer(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype, layers: int) -> Param:
    """``layers`` Mamba-2 mixers stacked on a leading axis, on the
    generator's device, with the reference's shapes and init laws."""
    d, dev = cfg.d_model, gen.device
    d_inner, nh, conv_dim = _dims(cfg)
    u = torch.rand((layers, nh), device=dev,
                   generator=None if dev.type == "meta" else gen)
    lo, hi = math.log(1e-3), math.log(0.1)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_inner + 2 * cfg.ssm_state + nh),
                              dtype, layers=layers),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), dtype,
                             scale=1.0 / math.sqrt(cfg.ssm_conv),
                             layers=layers),
        "conv_b": torch.zeros((layers, conv_dim), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)
                           ).repeat(layers, 1),
        "D": torch.ones((layers, nh), device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "out_proj": dense_init(gen, (d_inner, d), dtype, layers=layers),
        "norm": torch.zeros((layers, d_inner), device=dev),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, S, C], w [K, C]; the reference's sum
    of shifted products (no cuDNN, so no TF32)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s, :] * w[i] for i in range(k)) + b


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, _, _ = _dims(cfg)
    n = cfg.ssm_state
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _gate_out(p: Param, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    y = rms_norm((y * F.silu(z.float())).to(dtype), p["norm"], cfg.rms_eps)
    return y @ p["out_proj"]


def mamba2_forward(p: Param, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d] (chunked SSD); S must be a multiple of
    ``min(cfg.ssm_chunk, S)``."""
    b, s, _ = x.shape
    d_inner, nh, _ = _dims(cfg)
    n, hp, q = cfg.ssm_state, cfg.ssm_head_dim, min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must be divisible by chunk {q}")
    z, xbc, dt = _split_proj(x @ p["in_proj"], cfg)
    xbc = F.silu(_conv1d_causal(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_inner].reshape(b, s, nh, hp)
    dt = F.softplus(dt.float() + p["dt_bias"])               # [B,S,H]
    dA = dt * -torch.exp(p["A_log"])
    x_dt = (xs.float() * dt[..., None]).transpose(1, 2).reshape(b * nh, s, hp)
    y = mamba2_ssd_op(x_dt, xbc[..., d_inner:d_inner + n].float(),
                      xbc[..., d_inner + n:].float(),
                      dA.transpose(1, 2).reshape(b * nh, s), chunk=q)
    y = y.reshape(b, nh, s, hp).transpose(1, 2) + xs.float() * p["D"][:, None]
    return _gate_out(p, y.reshape(b, s, d_inner), z, cfg, x.dtype)


# ------------------------------------------------------------------ decode
def init_ssm_state(cfg: ModelConfig, batch: int, *, layers: int,
                   device: torch.device) -> dict:
    """Zero conv windows [L, B, K-1, conv] and SSM states [L, B, H, N, P],
    both fp32 as the reference's."""
    _, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, conv_dim),
                            device=device),
        "ssm": torch.zeros((layers, batch, nh, cfg.ssm_state,
                            cfg.ssm_head_dim), device=device),
    }


def mamba2_decode_step(p: Param, x: torch.Tensor, state: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x: [B, 1, d] one token -> (out [B, 1, d], new state); state holds
    one layer's ``conv`` [B, K-1, conv] and ``ssm`` [B, H, N, P]."""
    b = x.shape[0]
    d_inner, nh, _ = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(x @ p["in_proj"], cfg)
    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xbc_t = F.silu(conv).to(x.dtype)                         # [B, conv]
    xs = xbc_t[:, :d_inner].reshape(b, nh, hp).float()
    bm = xbc_t[:, d_inner:d_inner + n].float()
    cm = xbc_t[:, d_inner + n:].float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])        # [B,H]
    decay = torch.exp(dt1 * -torch.exp(p["A_log"]))
    ssm = state["ssm"] * decay[:, :, None, None] \
        + torch.einsum("bn,bh,bhp->bhnp", bm, dt1, xs)
    y = torch.einsum("bn,bhnp->bhp", cm, ssm) + xs * p["D"][:, None]
    out = _gate_out(p, y.reshape(b, 1, d_inner), z, cfg, x.dtype)
    return out, {"conv": window[:, 1:], "ssm": ssm}
