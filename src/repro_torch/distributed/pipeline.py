"""GPipe pipeline parallelism over a mesh axis (``pod`` by default).

The port of the reference's ``src/repro/distributed/pipeline.py``: layer
ranges (stages) sit on the devices of one mesh axis and microbatches
stream through them, so only stage-boundary activations cross between
devices.  The schedule is the reference's GPipe: ``n_micro + n_stages -
1`` ticks, stage ``i`` working on microbatch ``t - i`` at tick ``t``.
The reference runs it under ``shard_map`` with every stage computing
every tick and a ``ppermute`` ring; the port's mesh is one controller
(``distributed.sharding``), so each tick issues each busy stage's work
under its device, leaves the bubble's idle (stage, tick) pairs out, and
the ring's ``ppermute`` becomes ``.to(next device)``.  The final stage's
outputs come back to the first device.  Autograd follows the moves, so
gradients flow through the pipeline.
"""
from __future__ import annotations

import torch

from repro_torch.costs import moved
from repro_torch.device import on_device
from repro_torch.tree import tree_map

__all__ = ["pipeline_forward", "stack_stages"]


def stack_stages(params, n_stages: int):
    """Split a stacked-layer param tree [L, ...] into [n_stages, L/S, ...]."""
    def one(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree_map(one, params)


def _send(h: torch.Tensor, dev: torch.device) -> torch.Tensor:
    moved("collective-permute", h.numel() * h.element_size())
    return h.to(dev)


def pipeline_forward(stage_fn, stage_params, x: torch.Tensor, *, mesh,
                     axis: str = "pod", n_microbatches: int = 2
                     ) -> torch.Tensor:
    """Run ``x`` [B, ...] through the stages on the ``axis`` devices of
    ``mesh`` (the other axes at index 0).

    stage_fn(stage_params_slice, h) -> h applies one stage's layers;
    stage_params is a tree with a leading [n_stages, ...] axis (slice i
    moves to stage i's device).  Returns the final stage's output [B, ...]
    on the first stage's device.
    """
    names = mesh.axis_names
    at = [0] * len(names)
    at[names.index(axis)] = slice(None)
    devs = list(mesh.devices[tuple(at)])
    n_stages = len(devs)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches
    params = [tree_map(lambda t, i=i: t[i].to(devs[i]), stage_params)
              for i in range(n_stages)]
    x0 = x.to(devs[0])
    carry: list = [None] * n_stages          # what each stage takes next
    outs: list = [None] * n_microbatches
    for t in range(n_microbatches + n_stages - 1):
        sent: list = [None] * n_stages
        for i in range(n_stages):
            m = t - i
            if not 0 <= m < n_microbatches:
                continue                             # the bubble
            h = x0[m * mb:(m + 1) * mb] if i == 0 else carry[i]
            with on_device(devs[i]):
                h = stage_fn(params[i], h)
            if i == n_stages - 1:
                outs[m] = h
            else:
                sent[i + 1] = _send(h, devs[i + 1])
        carry = sent
    if n_stages > 1:
        outs = [_send(o, devs[0]) for o in outs]
    return torch.cat(outs)
