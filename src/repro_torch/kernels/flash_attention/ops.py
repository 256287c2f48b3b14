"""Prefill attention at the model's layout, on the tensors' device.

``prefill_attention`` takes the model's ``[B, S, H, D]`` layout with
grouped KV heads (the reference's ``blockwise_attention`` signature)
and hands ``kernel.flash_attention`` its ``[B, H, S, D]`` views: the
hand-written kernel on a CUDA tensor (which reads them in place through
their strides and writes a contiguous ``[B, S, Hq, Dv]`` output, so the
caller's reshape to ``[B, S, Hq * Dv]`` moves nothing), the reference's
blockwise prefill on a CPU tensor (which takes the views back, with no
copy).  It stands where the reference's
``src/repro/kernels/flash_attention/ops.py:25`` does; the device replaces
its ``use_kernel`` switch, and the KV heads are not repeated.

Training differentiates it.  With grad mode on and an input that
requires grad, the op runs inside ``FlashAttention``
(``kernels.autograd.recompute_function``) on every device: the forward
runs the device's implementation (the kernel on a CUDA tensor, the
blockwise prefill on a CPU tensor) and saves q, k and v; the backward
recomputes ``ref.blockwise_attention`` on them and differentiates that, as
the reference differentiates its blockwise prefill (on the CPU this gives
plain autograd's gradients bit for bit).  Under ``torch.no_grad()``
nothing is saved.

On ``meta`` tensors (the dry run's shapes) there are no values: the
output and the gradients are their shapes alone.  Each call is counted by
``costs.kernel_op`` as ``prefill_attention_work``, its useful work, and
each backward as ``prefill_attention_backward_work``, whichever
implementation runs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.costs import kernel_op
from repro_torch.kernels.autograd import recompute_function, wants_grad
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import blockwise_attention

__all__ = ["FlashAttention", "prefill_attention",
           "prefill_attention_backward_work", "prefill_attention_work",
           "seen_pairs"]


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """The kernel on the model's layout (looked up at call time, so a
    wrapper installed on this module's ``flash_attention`` sees it)."""
    if q.device.type == "meta":              # no values: only the shape
        return q.new_empty((*q.shape[:3], v.shape[-1]))
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)


def seen_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, positions absolute from 0 on
    both axes: key j is seen by query i when j <= i (causal) and
    j > i - window (window > 0)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                    np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def prefill_attention_work(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool,
                           window: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's useful work: 2 (D + Dv) FLOPs per
    seen (query, key) pair and head; q, k, v read and the output written
    once (the "bound by operations" of PERF.md's kernel table)."""
    b, sq, hq, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    flops = 2 * (d + dv) * b * hq * seen_pairs(sq, skv, causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + b * sq * hq * dv) \
        * q.element_size()
    return flops, nbytes


def prefill_attention_backward_work(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, causal: bool,
                                    window: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward's useful work: per seen (query,
    key) pair and head, the forward's two products' four gradient products
    and the scores recomputed (the forward saves none of them), 2 (3 D +
    2 Dv) FLOPs; q, k, v and the output's gradient read, and their
    gradients written, once."""
    b, sq, hq, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    flops = 2 * (3 * d + 2 * dv) * b * hq * seen_pairs(sq, skv, causal,
                                                         window)
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + b * sq * hq * dv) \
        * q.element_size()
    return flops, nbytes


FlashAttention = recompute_function(
    _kernel, blockwise_attention, "FlashAttention",
    cost=("prefill_attention.backward", prefill_attention_backward_work))


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    with kernel_op("prefill_attention", lambda: prefill_attention_work(
            q, k, v, causal, window)):
        if wants_grad(q, k, v):
            return FlashAttention.apply(dict(causal=causal, window=window),
                                        q, k, v)
        return _kernel(q, k, v, causal=causal, window=window)
