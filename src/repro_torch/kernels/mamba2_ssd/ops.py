"""Dispatch of the SSD chunked scan, on the tensors' device.

``mamba2_ssd_op`` is the counterpart of the reference's
``src/repro/kernels/mamba2_ssd/ops.py:20``: it forms the within-chunk
cumsum from per-step ``dt * A`` and calls ``kernel.mamba2_ssd``, which
launches the hand-written kernel on a CUDA tensor and runs the plain
chunked form on a CPU tensor.  The device decides the route, so the
reference's ``use_kernel`` switch has no counterpart.

Training differentiates it.  On CUDA tensors with grad mode on and an
input that requires grad, the kernel runs inside ``Mamba2SSD``
(``kernels.autograd.recompute_function``): the forward launches it and
saves x_dt, B, C and seg; the backward recomputes
``ref.mamba2_ssd_chunked`` on them and differentiates that (the cumsum
that makes seg stays under ordinary autograd), as the reference
differentiates its inline chunked scan off the TPU.  On CPU tensors the
chunked form runs under ordinary autograd; under ``torch.no_grad()``
nothing is saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import recompute_function, wants_grad
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked, seg_from_dA

__all__ = ["Mamba2SSD", "mamba2_ssd_op"]


def _kernel(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The kernel (looked up at call time, so a wrapper installed on this
    module's ``mamba2_ssd`` sees it)."""
    return mamba2_ssd(x_dt, B, C, seg, chunk=chunk)


Mamba2SSD = recompute_function(_kernel, mamba2_ssd_chunked, "Mamba2SSD")


def mamba2_ssd_op(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dA: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x_dt [BH, S, P], B/C [G, S, N] (G divides BH), dA [BH, S] -> y
    [BH, S, P] (fp32 in, fp32 out)."""
    args = (x_dt.contiguous(), B.contiguous(), C.contiguous(),
            seg_from_dA(dA.float(), chunk).contiguous())
    if x_dt.device.type == "cuda" and wants_grad(*args):
        return Mamba2SSD.apply(dict(chunk=chunk), *args)
    return _kernel(*args, chunk=chunk)
