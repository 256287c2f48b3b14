"""Gradients through the hand-written forward kernels.

The reference has no ``custom_vjp``: its training forward differentiates
plain XLA code (``blockwise_attention``, the inline chunked SSD scan).
The port launches hand-written forward kernels through ``ctypes``, which
autograd cannot see, so ``recompute_function`` wraps such a kernel in a
``torch.autograd.Function``: its forward launches the kernel and saves
only the inputs; its backward recomputes the kernel's plain version on
detached copies of those inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of that recompute, which is the reference's own
gradient algorithm.  No backward kernel is involved.

Given ``cost=(name, work)``, the backward runs inside
``costs.kernel_op(name, work)``: the cost reader counts it by the work
formula, not by the recompute it dispatches, so a step's count is the
same on the card, the CPU and ``meta``.  On ``meta`` there are no values
and the backward recomputes nothing: each gradient is its shape alone.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.costs import kernel_op

__all__ = ["recompute_function", "wants_grad"]


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record a node for these inputs: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_function(forward: Callable, plain: Callable, name: str,
                       cost: tuple[str, Callable] | None = None
                       ) -> type[torch.autograd.Function]:
    """A ``torch.autograd.Function`` named ``name``, applied as
    ``Fn.apply(static, *tensors)``: the forward returns ``forward(*tensors,
    **static)`` (run by autograd with grad mode off), the backward
    ``torch.autograd.grad`` of ``plain(*tensors, **static)`` recomputed on
    detached copies, for the inputs that need a gradient.  ``static`` is a
    dict of the non-tensor arguments; ``cost`` is ``(op name,
    work(*tensors, **static) -> (flops, bytes))`` of the backward (module
    docstring).  A test builds one with ``forward = plain`` to hold the
    construction itself against plain autograd."""

    def fwd(ctx, static: dict, *tensors: torch.Tensor) -> torch.Tensor:
        ctx.static = static
        ctx.save_for_backward(*tensors)
        return forward(*tensors, **static)

    def bwd(ctx, grad: torch.Tensor):
        saved = ctx.saved_tensors            # unpacked once (checkpoint)
        if cost is None:
            return recompute(ctx, saved, grad)
        with kernel_op(cost[0], lambda: cost[1](*saved, **ctx.static)):
            return recompute(ctx, saved, grad)

    def recompute(ctx, saved: tuple, grad: torch.Tensor):
        needs = ctx.needs_input_grad[1:]
        if grad.device.type == "meta":
            return (None, *(torch.empty_like(t) if need else None
                            for t, need in zip(saved, needs)))
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, needs)]
            out = plain(*xs, **ctx.static)
        grads = iter(torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], grad,
            allow_unused=True))
        return (None, *(next(grads) if need else None for need in needs))

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(fwd), "backward": staticmethod(bwd),
                 "__doc__": f"{name}: a forward kernel with the plain "
                            f"version's recomputed gradient."})
