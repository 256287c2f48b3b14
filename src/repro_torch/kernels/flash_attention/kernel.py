"""Launcher of the hand-written CUDA prefill-attention kernel.

``flash_attention`` (``csrc/flash_attention.cu``) replaces the
reference's Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:98``: causal and
sliding-window attention with an fp32 online softmax, one CTA per
(batch, head, 32-row query tile) looping over the key tiles the band can
reach, query head h reading KV head ``h // (Hq / Hkv)``.  The source says
what bounds it on the card.  On a CPU tensor the wrapper returns the
reference's own prefill, ``ref.blockwise_attention``; the dense
``ref.attention_ref`` is the definition both are held against.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import load_library
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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k [B, Hkv, Skv, D]; v [B, Hkv, Skv, Dv] (Hkv
    divides Hq) -> [B, Hq, Sq, Dv] in q's dtype, scores scaled by
    ``1 / sqrt(D)``.

    On CUDA tensors (float32 or bfloat16; D and Dv multiples of 4 up to
    128) this launches the kernel on the current stream, after copying a
    strided view to the contiguous layout it reads, and raises if it
    cannot; on CPU tensors it returns ``blockwise_attention`` on views,
    without a copy.  ``flash_attention.launches`` counts launches.
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a 16-byte "
                             f"aligned float32 or bfloat16 tensor, got "
                             f"{t.dtype}")
    for name, n in (("D", d), ("Dv", dv)):
        if n % 4 or not 0 < n <= MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {name} = {n} must "
                             f"be a multiple of 4 up to {MAX_HEAD_DIM}")
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, dv, 1.0 / math.sqrt(d), int(causal), int(window),
        DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed (cudaError "
                           f"{err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
