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

Training differentiates it.  On a CUDA tensor with grad mode on and an
input that requires grad, the kernel runs inside ``FlashAttention``
(``kernels.autograd.recompute_function``): the forward launches it and
saves q, k and v; the backward recomputes ``ref.blockwise_attention`` on
them and differentiates that, as the reference differentiates its
blockwise prefill.  On a CPU tensor the blockwise prefill runs under
ordinary autograd; under ``torch.no_grad()`` nothing is saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import recompute_function, wants_grad
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import blockwise_attention

__all__ = ["FlashAttention", "prefill_attention"]


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """The kernel on the model's layout (looked up at call time, so a
    wrapper installed on this module's ``flash_attention`` sees it)."""
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)


FlashAttention = recompute_function(_kernel, blockwise_attention,
                                    "FlashAttention")


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    if q.device.type == "cuda" and wants_grad(q, k, v):
        return FlashAttention.apply(dict(causal=causal, window=window),
                                    q, k, v)
    return _kernel(q, k, v, causal=causal, window=window)
