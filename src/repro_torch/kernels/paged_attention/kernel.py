"""Launcher of the hand-written CUDA paged decode-attention kernel.

``paged_attention`` (``csrc/paged_attention.cu``) replaces the
reference's Pallas TPU kernel
``src/repro/kernels/paged_attention/kernel.py:76``: GQA decode attention
of one query token per sequence over a paged KV pool, located through
per-sequence block tables, with an fp32 online softmax.  Split-KV: the
grid is (KV head, row, split), each split a run of whole pages that a CTA
streams through a cp.async ring in shared memory, reading its row's table
and length itself and only the positions below the length; the splits'
fp32 partials are merged by the log-sum-exp combination in a second
small kernel.  ``split_count`` picks the splits from the
table's width and the SM count (the lengths stay on the card).  The
source says what bounds it on the card.  On a CPU tensor the wrapper
returns ``ref.paged_attention_ref``, the definition the kernel is held
against; ``ref.paged_attention_split_ref`` is the kernel's decomposition
in plain torch.  The serving decode hands in its in-flight token's K/V
(``k_self`` / ``v_self``), which is not in the pool yet: the kernel folds
it in as one more partial of the same log-sum-exp merge.  The launch
writes through ``ctypes`` and records no autograd node (decode is never
differentiated; the reference's decode calls the plain version): on CUDA
tensors with grad mode on and an input that requires grad it raises
rather than return a detached output.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.costs import kernel_op
from repro_torch.kernels import load_library
from repro_torch.kernels.autograd import wants_grad
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_work"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc"
           / "paged_attention.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("paged_attention", SOURCES),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16
# positions a CTA's tile holds (the source's TileOf), the table entries a
# CTA stages (kMaxSplitPages), and the CTAs aimed at per SM
TILE = {torch.float32: 32, torch.bfloat16: 64}
MAX_SPLIT_PAGES = 1024
CTAS_PER_SM = 4


def _lib() -> ctypes.CDLL:
    lib = load_library("paged_attention", SOURCES)
    fn = lib.paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_count(batch: int, hkv: int, pages_per_seq: int, page: int,
                tile: int, sms: int) -> tuple[int, int]:
    """``(n_split, pages_per_split)`` of a launch: enough splits of whole
    pages that ``batch * hkv * n_split`` reaches about ``CTAS_PER_SM``
    CTAs per SM, but none shorter than two tiles (unless the table is)
    and none holding more than ``MAX_SPLIT_PAGES`` table entries.  Only
    the table's width is known here: the lengths stay on the card, so a
    split past a row's length reads nothing."""
    pps = max(int(pages_per_seq), 1)
    want = -(-CTAS_PER_SM * sms // max(batch * hkv, 1))
    min_pages = -(-2 * tile // page)
    per = max(1, min(max(-(-pps // want), min_pages), MAX_SPLIT_PAGES))
    return -(-pps // per), per


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor,
                    k_self: torch.Tensor | None = None,
                    v_self: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Hq, D]; k/v_pages [n_pool, page, Hkv, D] (Hkv divides Hq);
    block_tables [B, pages_per_seq] and seq_lens [B], int32 -> [B, Hq, D]
    in q's dtype, scores scaled by ``1 / sqrt(D)``.  With ``k_self`` and
    ``v_self`` ([B, Hkv, D] in q's dtype) the attention also covers one
    in-flight position past each row's pooled ones (score ``q . k_self``,
    value ``v_self``); without them the call is unchanged.

    On CUDA tensors (contiguous; q and the pages float32 or bfloat16 of one
    dtype, D a multiple of 4 up to 128, Hq / Hkv up to 16) this launches
    the kernel on the current stream and raises if it cannot; it reads no
    length or table entry on the host; an entry outside the pool is
    clamped into it.  The splits (``split_count``) are merged by a second
    kernel, in order, so a call gives the same bits every time; the
    in-flight position is merged after the splits (with one split, by the
    split's own kernel).  A row of length 0 comes back as 0, as from the
    Pallas kernel (``ref.paged_attention_ref`` gives the mean of its
    gathered V), or as ``v_self`` exactly.  On CPU tensors it returns
    ``ref.paged_attention_ref``.  ``paged_attention.launches`` counts
    calls that launched (one or two kernels each), ``.self_folds`` those
    of them with the in-flight position; ``costs.kernel_op`` counts each
    call's work as ``paged_attention_work``.
    """
    with kernel_op("paged_attention", lambda: paged_attention_work(
            q, k_pages, seq_lens)):
        return _paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                                k_self, v_self)


def paged_attention_work(q: torch.Tensor, k_pages: torch.Tensor,
                         seq_lens: torch.Tensor) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's useful work: 4 D FLOPs per (head,
    position below the row's length); q read, each row's K and V
    positions read once and the output written once."""
    _, hq, d = q.shape
    hkv = k_pages.shape[2]
    seen = int(seq_lens.sum())
    return (4 * d * hq * seen,
            (2 * q.numel() + 2 * seen * hkv * d) * q.element_size())


def _paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, k_self: torch.Tensor | None,
                     v_self: torch.Tensor | None) -> torch.Tensor:
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
    fold = k_self is not None
    if fold != (v_self is not None):
        raise ValueError("paged_attention: k_self and v_self come together")
    values = [k_pages, v_pages]
    if fold:
        if k_self.shape != (b, hkv, d) or v_self.shape != (b, hkv, d):
            raise ValueError(f"paged_attention: k_self and v_self must be "
                             f"[B, Hkv, D] = {[b, hkv, d]}, got "
                             f"{tuple(k_self.shape)} and "
                             f"{tuple(v_self.shape)}")
        named += (("k_self", k_self), ("v_self", v_self))
        values += [k_self, v_self]
    if any(t.device != q.device for _, t in named):
        raise ValueError("paged_attention: all inputs must share one device")
    if any(t.dtype != q.dtype for t in values):
        raise ValueError("paged_attention: q, the pages and the in-flight "
                         "K/V must share one dtype")
    if q.device.type != "cuda":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens, k_self, v_self)
    if wants_grad(q, *values):
        raise RuntimeError("paged_attention: the kernel records no autograd "
                           "node and an input requires grad; it has no "
                           "differentiable route (decode is not trained)")
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
    if n_pool * page >= 2**31:
        raise ValueError(f"paged_attention: a pool of {n_pool} pages of "
                         f"{page} positions exceeds the kernel's int32 "
                         f"positions")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    pps = block_tables.shape[1]
    n_split, per = split_count(b, hkv, pps, page, TILE[q.dtype],
                               _sm_count(q.device.index))
    ws = None
    if n_split > 1:
        ws = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                         device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        k_self.data_ptr() if fold else None,
        v_self.data_ptr() if fold else None, out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, n_pool, hq, hkv, d, page,
        pps, per, n_split, 1.0 / math.sqrt(d), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed (cudaError {err})")
    paged_attention.launches += 1
    paged_attention.self_folds += fold
    return out


paged_attention.launches = 0
paged_attention.self_folds = 0
