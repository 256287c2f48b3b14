"""Dispatch of the SSD chunked scan, on the tensors' device.

``mamba2_ssd_op`` is the counterpart of the reference's
``src/repro/kernels/mamba2_ssd/ops.py:20``: it forms the within-chunk
cumsum from per-step ``dt * A`` and calls ``kernel.mamba2_ssd``, which
launches the hand-written kernel on a CUDA tensor and runs the plain
chunked form on a CPU tensor.  The device decides the route, so the
reference's ``use_kernel`` switch has no counterpart.

Training differentiates it.  With grad mode on and an input that
requires grad, the op runs inside ``Mamba2SSD``
(``kernels.autograd.recompute_function``) on every device: the forward
runs the device's implementation (the kernel on CUDA tensors, the plain
chunked form on CPU tensors) and saves x_dt, B, C and seg; the backward
recomputes ``ref.mamba2_ssd_chunked`` on them and differentiates that
(the cumsum that makes seg stays under ordinary autograd), as the
reference differentiates its inline chunked scan off the TPU.  Under
``torch.no_grad()`` nothing is saved; on ``meta`` the output and the
gradients are their shapes alone.  Each call is counted by
``costs.kernel_op`` as ``mamba2_ssd_work``, its useful work, and each
backward as ``mamba2_ssd_backward_work``, whichever implementation runs.
"""
from __future__ import annotations

import torch

from repro_torch.costs import kernel_op
from repro_torch.kernels.autograd import recompute_function, wants_grad
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked, seg_from_dA

__all__ = ["Mamba2SSD", "mamba2_ssd_backward_work", "mamba2_ssd_op",
           "mamba2_ssd_work"]


def _kernel(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The kernel (looked up at call time, so a wrapper installed on this
    module's ``mamba2_ssd`` sees it).  On ``meta`` there are no values:
    the output is its shape alone."""
    if x_dt.device.type == "meta":
        return torch.empty_like(x_dt)
    return mamba2_ssd(x_dt, B, C, seg, chunk=chunk)


def mamba2_ssd_work(x_dt: torch.Tensor, B: torch.Tensor,
                    chunk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call's useful work: per row and chunk
    Q(Q+1)/2 P multiply-adds for the causal intra product and 2 Q N P for
    the inter term and the state, per group and chunk Q(Q+1)/2 N for the
    shared scores; x, B, C, seg read and y written once, fp32 (the bound
    of PERF.md's kernel table)."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    macs = bh * nc * (pairs * p + 2 * chunk * n * p) + g * nc * pairs * n
    return 2 * macs, 4 * (2 * bh * s * p + 2 * g * s * n + bh * s)


def mamba2_ssd_backward_work(x_dt: torch.Tensor, B: torch.Tensor,
                             C: torch.Tensor, seg: torch.Tensor, *,
                             chunk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward's useful work: each of the
    forward's products gives two gradient products of its size, and the
    shared scores and the chunk states are recomputed (the forward saves
    neither); x, B, C, seg and the output's gradient read, and their
    gradients written, once, fp32."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    fwd = bh * nc * (pairs * p + 2 * chunk * n * p) + g * nc * pairs * n
    macs = 2 * fwd + g * nc * pairs * n + bh * nc * chunk * n * p
    return 2 * macs, 4 * (3 * bh * s * p + 4 * g * s * n + 2 * bh * s)


Mamba2SSD = recompute_function(
    _kernel, mamba2_ssd_chunked, "Mamba2SSD",
    cost=("mamba2_ssd.backward", mamba2_ssd_backward_work))


def mamba2_ssd_op(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dA: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x_dt [BH, S, P], B/C [G, S, N] (G divides BH), dA [BH, S] -> y
    [BH, S, P] (fp32 in, fp32 out)."""
    args = (x_dt.contiguous(), B.contiguous(), C.contiguous(),
            seg_from_dA(dA.float(), chunk).contiguous())
    with kernel_op("mamba2_ssd", lambda: mamba2_ssd_work(x_dt, B, chunk)):
        if wants_grad(*args):
            return Mamba2SSD.apply(dict(chunk=chunk), *args)
        return _kernel(*args, chunk=chunk)
