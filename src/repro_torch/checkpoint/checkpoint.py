"""Checkpointing with async save, in the reference's on-disk format.

The port of the reference's ``src/repro/checkpoint/checkpoint.py``: one
``.npz`` of the tree's leaves keyed by their ``/``-joined dict path
(``params/embed``, ``opt/count``, ``step``), bf16 stored as f32, and a
JSON manifest (paths, shapes, dtypes, step); saves are atomic (tmp +
rename), the latest complete step wins, and an async writer thread
overlaps serialization with the next step.  A checkpoint written by
either package restores into the other.  A placed tree
(``distributed.sharding.place``) is saved as its whole (gathered) leaves:
the manifest holds logical shapes only.  ``restore_checkpoint`` puts each
leaf on its like-leaf's device and dtype, or, given ``shardings=``,
places it by that tree: the elastic restore, onto any mesh, whatever mesh
the checkpoint was written from.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, gather, place
from repro_torch.tree import tree_items, tree_map, tree_unflatten

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bf16 widened to f32, exactly); a
    placed leaf is gathered whole."""
    if isinstance(leaf, ShardedTensor):
        leaf = gather(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, step: int) -> str:
    """Writes ``step_<step>.npz`` and ``step_<step>.json`` under ``path``
    (created); returns the npz's path."""
    os.makedirs(path, exist_ok=True)
    flat = {k: _host(v) for k, v in tree_items(tree)}
    tmp = os.path.join(path, f".tmp_step_{step}.npz")
    final = os.path.join(path, f"step_{step}.npz")
    np.savez(tmp, **flat)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
    }
    with open(os.path.join(path, f".tmp_step_{step}.json"), "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, final)
    os.rename(os.path.join(path, f".tmp_step_{step}.json"),
              os.path.join(path, f"step_{step}.json"))
    return final


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-5]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".json")]
    return max(steps) if steps else None


def restore_checkpoint(path: str, like_tree, step: int | None = None,
                       shardings=None):
    """Restore into the structure of ``like_tree`` (its leaves' devices
    and dtypes; placed or not) -> (tree, step).  ``shardings``: a
    matching tree of ``NamedSharding``s; each restored leaf is placed by
    it (the elastic restore re-shards here)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    with np.load(os.path.join(path, f"step_{step}.npz")) as data:
        leaves = [torch.from_numpy(data[key]).to(
            device="cpu" if shardings is not None else leaf.device,
            dtype=leaf.dtype) for key, leaf in tree_items(like_tree)]
    tree = tree_unflatten(like_tree, leaves)
    if shardings is not None:
        tree = place(tree, shardings)
    return tree, step


class AsyncCheckpointer:
    """Background writer: overlap checkpoint serialization with training."""

    def __init__(self, path: str):
        self.path = path
        self._thread: threading.Thread | None = None

    def save(self, tree, step: int) -> None:
        """Copies ``tree`` to the host now (the caller may go on updating
        the device tensors) and writes it in a thread."""
        self.wait()
        host_tree = tree_map(_host, tree)
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.path, host_tree, step),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
