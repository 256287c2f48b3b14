"""Gradient compression for data parallelism across shards.

The port of the reference's ``src/repro/optim/compression.py``: an int8
all-reduce with error feedback (the 1-bit-Adam family, Seide et al. /
Tang et al.).  Before the all-reduce each shard quantizes its gradient
to int8 with a per-tensor scale, keeps the quantization residual, and
adds it back the next step; the wire carries a quarter of fp32's bytes.
``quantize_int8`` and ``dequantize_int8`` are the reference's arithmetic
(both ``round``s half to even).
"""
from __future__ import annotations

import torch

from repro_torch.costs import moved
from repro_torch.distributed.sharding import Mesh, ShardMesh
from repro_torch.tree import tree_map

__all__ = ["compressed_psum", "dequantize_int8", "init_error_state",
           "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 q = clip(round(x / scale), -127, 127), fp32 scale =
    max |x| / 127 + 1e-12)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _ring(mesh: ShardMesh | Mesh, axis_name: str | None) -> ShardMesh:
    """The shards a reduce runs over: a ``ShardMesh`` as it is, or the
    devices along ``axis_name`` of a ``Mesh`` (the other axes at 0)."""
    if isinstance(mesh, ShardMesh):
        return mesh
    at = [0] * len(mesh.axis_names)
    at[mesh.axis_names.index(axis_name)] = slice(None)
    return ShardMesh(tuple(mesh.devices[tuple(at)]))


@torch.no_grad()
def compressed_psum(grads: list, err_state: list, mesh: ShardMesh | Mesh,
                    axis_name: str | None = None) -> tuple[list, list]:
    """Error-feedback int8 all-reduce over the shards of ``mesh`` (a
    ``ShardMesh``, or a ``Mesh``'s ``axis_name`` axis).

    ``grads`` and ``err_state`` hold one tree per shard, on that shard's
    device.  Each shard quantizes ``g + e`` and keeps ``g + e - deq`` as
    its new error; the int8 payloads and fp32 scales cross to the first
    device, which dequantizes them, sums them in shard order and divides
    by the shard count; the mean crosses back.  Returns (one fp32 mean
    tree per shard, on its device; one new error tree per shard).

    The reference's ``compressed_psum(grads, err, axis_name)`` runs inside
    ``shard_map`` on every shard at once, its ``lax.psum`` of the
    dequantized values over the named axis; the port keeps the mesh's
    single controller (``distributed.sharding``), so one call takes every
    shard's tree and does the reduce itself.  The values are the same:
    each shard's mean is ``sum_s deq_s / n``.
    """
    mesh = _ring(mesh, axis_name)
    n = mesh.size
    if len(grads) != n or len(err_state) != n:
        raise ValueError(f"compressed_psum: {n} shards, got {len(grads)} "
                         f"gradient and {len(err_state)} error trees")
    root = mesh.devices[0]

    def one(*leaves):
        """One leaf of every shard -> (the mean on the first device, each
        shard's new error)."""
        total, errs = None, []
        for g, e in zip(leaves[:n], leaves[n:]):
            g32 = g.to(torch.float32) + e
            q, scale = quantize_int8(g32)
            errs.append(g32 - dequantize_int8(q, scale))
            moved("all-reduce", q.numel() + 4)
            deq = dequantize_int8(q.to(root), scale.to(root))
            total = deq if total is None else total + deq
        return total / float(n), errs

    out = tree_map(one, *grads, *err_state)
    return ([tree_map(lambda o, d=dev: o[0].to(d), out)
             for dev in mesh.devices],
            [tree_map(lambda o, s=s: o[1][s], out) for s in range(n)])
