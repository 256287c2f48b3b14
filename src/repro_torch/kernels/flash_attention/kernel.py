"""Launcher of the hand-written CUDA prefill-attention kernel.

``flash_attention`` (``csrc/flash_attention.cu``) replaces the
reference's Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:98``: causal and
sliding-window attention with an fp32 online softmax, one CTA per (batch,
head, query tile) looping over the key tiles the band can reach, query
head h reading KV head ``h // (Hq / Hkv)``.  bf16 runs on the tensor cores
(``wgmma`` fed by TMA from a producer warp, 128 query rows a CTA in two
consumer warpgroups, P as bf16 hi + lo), fp32 on the CUDA cores (32-row
tiles).  The kernel takes element strides, so it reads the model's
``[B, S, H, D]`` projections through ``[B, H, S, D]`` views in place.  The
source says what bounds it on the card.  On a CPU tensor the wrapper
returns the reference's own prefill, ``ref.blockwise_attention``; the
dense ``ref.attention_ref`` is the definition both are held against.
The launch writes through ``ctypes`` and records no autograd node: the
differentiable route is ``ops.prefill_attention`` (its ``FlashAttention``
Function), and on a CUDA tensor with grad mode on and an input that
requires grad this launcher raises rather than return a detached output.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import load_library
from repro_torch.kernels.autograd import wants_grad
from repro_torch.kernels.flash_attention.ref import blockwise_attention

__all__ = ["flash_attention"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc"
           / "flash_attention.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("flash_attention", SOURCES),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention", SOURCES)
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _strides(t: torch.Tensor) -> tuple[int, ...]:
    """Element strides of the batch, head and sequence axes (0 where the
    axis has one element: its stride is never used)."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:3],
                                                       t.stride()[:3]))


def _readable(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place, else a contiguous
    copy with its last axis zero-padded to ``cols``.  In place means: last
    axis contiguous and ``cols`` long, the other strides multiples of 4
    elements for float32 (the fp32 body's 16-byte loads) and of 8 for
    bfloat16 (TMA's 16-byte strides), a 16-byte aligned base."""
    step = 4 if t.dtype == torch.float32 else 8
    if t.shape[-1] == cols and t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and not any(st % step for st in _strides(t)):
        return t
    return F.pad(t, (0, cols - t.shape[-1])).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k [B, Hkv, Skv, D]; v [B, Hkv, Skv, Dv] (Hkv
    divides Hq) -> [B, Hq, Sq, Dv] in q's dtype, scores scaled by
    ``1 / sqrt(D)``.

    On CUDA tensors (float32 or bfloat16; D and Dv multiples of 4 up to
    128) this launches the kernel on the current stream and raises if it
    cannot.  The kernel reads any layout whose last axis is contiguous,
    with the other strides multiples of 4 elements (8 in bfloat16, whose
    head dims must also be multiples of 8) and a 16-byte aligned base: the
    model's ``[B, S, H, D]`` projections seen as ``[B, H, S, D]``.  Only a
    tensor it cannot read is copied (zero-padded to the next multiple of 8
    in bfloat16).  The output takes q's layout: when q's head stride is
    below its sequence stride it is a ``[B, H, S, Dv]`` view of a
    contiguous ``[B, S, H, Dv]`` tensor.  On CPU tensors it
    returns ``blockwise_attention`` on views, without a copy.
    ``flash_attention.launches`` counts launches.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    named = (("q", q), ("k", k), ("v", v))
    if k.shape != (b, hkv, skv, d) or v.shape[:3] != k.shape[:3] \
            or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k of "
                         f"[B, Hkv, Skv, D] and v of [B, Hkv, Skv, Dv] with "
                         f"Hkv dividing Hq, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if any(t.device != q.device or t.dtype != q.dtype for _, t in named):
        raise ValueError("flash_attention: q, k and v must share one device "
                         "and dtype")
    if q.device.type != "cuda":
        return blockwise_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
    if wants_grad(q, k, v):
        raise RuntimeError("flash_attention: the kernel records no autograd "
                           "node and an input requires grad; differentiate "
                           "through kernels.flash_attention.ops."
                           "prefill_attention (its FlashAttention Function)")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q, k and v must be float32 or "
                         f"bfloat16, got {q.dtype}")
    for name, n in (("D", d), ("Dv", dv)):
        if n % 4 or not 0 < n <= MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {name} = {n} must "
                             f"be a multiple of 4 up to {MAX_HEAD_DIM}")
    # bfloat16 head dims go to the tensor cores as multiples of 8 (the
    # padding is zeros: the scores and the output are unchanged)
    step = 8 if q.dtype == torch.bfloat16 else 1
    dp, dvp = -(-d // step) * step, -(-dv // step) * step
    q, k, v = _readable(q, dp), _readable(k, dp), _readable(v, dvp)
    if q.stride(1) < q.stride(2):              # the model's [B, S, H, D]
        out = torch.empty((b, sq, hq, dvp), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        out = torch.empty((b, hq, sq, dvp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :dv]
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in _strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b,
        hq, hkv, sq, skv, dp, dvp, 1.0 / math.sqrt(d), int(causal),
        int(window), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed (cudaError "
                           f"{err})")
    flash_attention.launches += 1
    return out[..., :dv]


flash_attention.launches = 0
