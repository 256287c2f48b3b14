"""The control plane's 1-D shard mesh: one process, a tuple of devices.

The reference's ``control_plane_mesh`` is a ``("shards",)`` JAX mesh of
every local device in one process; ``shard_map`` runs the same stage
closures on each shard and its collectives stay in-process.  The port
keeps that single controller: a ``ShardMesh`` is the tuple of devices the
shards run on, and the sharded window pipeline (``core.shard_pipeline``)
issues each shard's work under its device and moves the per-shard
summaries to the first device itself.  No process group is involved, so
the manager, ``analyze_windows`` and ``DeviceWindowPipeline`` keep being
called from one process.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["ShardMesh", "control_plane_mesh"]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The shards of the control plane, one device each, in mesh order.

    A device may repeat: repeated devices are logical shards on one
    device, each with its own tape chunk, stages and kernel launches (the
    counterpart of the reference harness's forced host devices).  The
    first device gathers the summaries and runs the budget cut.
    """

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def control_plane_mesh(n_shards: int | None = None,
                       device: str | torch.device | None = None
                       ) -> ShardMesh:
    """The 1-D mesh of the sharded control plane.

    On the card (``device`` None or CUDA) every visible card, capped at
    ``n_shards``: a one-card machine runs the sharded path as a 1-shard
    mesh, as the reference degrades to however many devices exist.  On
    another device (the CPU) ``n_shards`` logical shards of it (default
    1).  Raises when the card is asked for and none is visible.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        k = len(cards) if n_shards is None else max(1, min(int(n_shards),
                                                           len(cards)))
        return ShardMesh(tuple(cards[:k]))
    k = 1 if n_shards is None else max(1, int(n_shards))
    return ShardMesh((dev,) * k)
