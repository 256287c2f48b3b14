"""Dispatch of the SSD chunked scan, on the tensors' device.

``mamba2_ssd_op`` is the counterpart of the reference's
``src/repro/kernels/mamba2_ssd/ops.py:20``: it forms the within-chunk
cumsum from per-step ``dt * A`` and calls ``kernel.mamba2_ssd``, which
launches the hand-written kernel on a CUDA tensor and runs the plain
chunked form on a CPU tensor.  The device decides the route, so the
reference's ``use_kernel`` switch has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import seg_from_dA

__all__ = ["mamba2_ssd_op"]


def mamba2_ssd_op(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dA: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x_dt [BH, S, P], B/C [G, S, N] (G divides BH), dA [BH, S] -> y
    [BH, S, P] (fp32 in, fp32 out)."""
    seg = seg_from_dA(dA.float(), chunk).contiguous()
    return mamba2_ssd(x_dt.contiguous(), B.contiguous(), C.contiguous(), seg,
                      chunk=chunk)
