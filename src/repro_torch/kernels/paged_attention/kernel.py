"""Launcher of the hand-written CUDA paged decode-attention kernel.

``paged_attention`` (``csrc/paged_attention.cu``) replaces the
reference's Pallas TPU kernel
``src/repro/kernels/paged_attention/kernel.py:76``: GQA decode attention
of one query token per sequence over a paged KV pool, located through
per-sequence block tables, with an fp32 online softmax.  One CTA per
(batch row, KV head) reads its row's table and length itself and walks
only the positions below the length; the source says what bounds it on
the card.  On a CPU tensor the wrapper returns ``ref.paged_attention_ref``,
the definition the kernel is held against.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc"
           / "paged_attention.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("paged_attention", SOURCES),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16


def _lib() -> ctypes.CDLL:
    lib = load_library("paged_attention", SOURCES)
    fn = lib.paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D]; k/v_pages [n_pool, page, Hkv, D] (Hkv divides Hq);
    block_tables [B, pages_per_seq] and seq_lens [B], int32 -> [B, Hq, D]
    in q's dtype, scores scaled by ``1 / sqrt(D)``.

    On CUDA tensors (contiguous; q and the pages float32 or bfloat16 of one
    dtype, D a multiple of 4 up to 128, Hq / Hkv up to 16) this launches
    the kernel on the current stream and raises if it cannot; it reads no
    length or table entry on the host; an entry outside the pool is
    clamped into it.  A row of length 0 comes back as 0, as from the
    Pallas kernel (``ref.paged_attention_ref`` gives the mean of its
    gathered V).  On CPU tensors it returns ``ref.paged_attention_ref``.
    ``paged_attention.launches`` counts launches.
    """
    b, hq, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: k_pages and v_pages must be "
                         f"[n_pool, page, Hkv, D] of one shape, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    n_pool, page, hkv, dk = k_pages.shape
    if dk != d or hkv == 0 or hq % hkv or block_tables.dim() != 2 \
            or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"paged_attention: q {tuple(q.shape)} needs pages "
                         f"of head dim {d} with Hkv dividing Hq, tables "
                         f"[B, pages_per_seq] and lengths [B], got pages "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(seq_lens.shape)}")
    named = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), ("seq_lens", seq_lens))
    if any(t.device != q.device for _, t in named):
        raise ValueError("paged_attention: all inputs must share one device")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q and the pages must share one "
                         "dtype")
    if q.device.type != "cuda":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens)
    if q.dtype not in DTYPES:
        raise ValueError(f"paged_attention: float32 or bfloat16 inputs, got "
                         f"{q.dtype}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32, got "
                             f"{t.dtype}")
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if d % 4 or not 0 < d <= MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged_attention: head dim {d} must be a multiple "
                         f"of 4 up to {MAX_HEAD_DIM} and Hq / Hkv = "
                         f"{hq // hkv} at most {MAX_GROUP}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b,
        n_pool, hq, hkv, d, page, block_tables.shape[1], 1.0 / math.sqrt(d),
        DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed (cudaError {err})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
