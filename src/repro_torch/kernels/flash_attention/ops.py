"""Prefill attention at the model's layout, on the tensors' device.

``prefill_attention`` takes the model's ``[B, S, H, D]`` layout with
grouped KV heads (the reference's ``blockwise_attention`` signature)
and hands ``kernel.flash_attention`` its ``[B, H, S, D]`` views: the
hand-written kernel on a CUDA tensor (which copies them to that layout),
the reference's blockwise prefill on a CPU tensor (which takes the
views back, with no copy).  It stands where the reference's
``src/repro/kernels/flash_attention/ops.py:25`` does; the device replaces
its ``use_kernel`` switch, and the KV heads are not repeated.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["prefill_attention"]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
