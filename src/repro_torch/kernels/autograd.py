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
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["recompute_function", "wants_grad"]


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record a node for these inputs: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_function(forward: Callable, plain: Callable,
                       name: str) -> type[torch.autograd.Function]:
    """A ``torch.autograd.Function`` named ``name``, applied as
    ``Fn.apply(static, *tensors)``: the forward returns ``forward(*tensors,
    **static)`` (run by autograd with grad mode off), the backward
    ``torch.autograd.grad`` of ``plain(*tensors, **static)`` recomputed on
    detached copies, for the inputs that need a gradient.  ``static`` is a
    dict of the non-tensor arguments.  A test builds one with ``forward =
    plain`` to hold the construction itself against plain autograd."""

    def fwd(ctx, static: dict, *tensors: torch.Tensor) -> torch.Tensor:
        ctx.static = static
        ctx.save_for_backward(*tensors)
        return forward(*tensors, **static)

    def bwd(ctx, grad: torch.Tensor):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
            out = plain(*xs, **ctx.static)
        grads = iter(torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], grad,
            allow_unused=True))
        return (None, *(next(grads) if need else None for need in needs))

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(fwd), "backward": staticmethod(bwd),
                 "__doc__": f"{name}: a forward kernel with the plain "
                            f"version's recomputed gradient."})
