"""Train-step factory: loss -> gradients (with microbatch accumulation)
-> AdamW, on one device or sharded over a mesh.

The port of the reference's ``src/repro/train/steps.py``.  The step is
eager PyTorch: gradients come from ``torch.autograd.grad`` over the
parameter leaves (through the kernels' autograd Functions on the card),
microbatches are a Python loop that sums and then scales by 1 / m, as the
reference's ``lax.scan``.  ``tp`` is the tensor-parallel degree the
parameters were built for (``init_params(tp=)``).

With ``grad_shardings`` (a param tree of ``NamedSharding``s over a
``distributed.sharding.Mesh``) the step is the single-controller
counterpart of the reference's ``jit(step, in_shardings=state_specs,
out_shardings=...)`` with each gradient leaf constrained to its FSDP
shard; each leaf's gradient sharding must be its parameter's in the
placed state (``param_specs`` on the state's mesh), as the reference's
callers give it.  The state is placed (``distributed.sharding.place`` by
``state_specs``); the batch is split by ``batch_specs`` over ``DP(mesh)``,
and each block of rows computes its loss and gradient under its DP
device, on the parameters gathered there (the FSDP all-gather); the
gradients are summed onto ``grad_shardings``' shards (the FSDP
reduce-scatter), each block weighted by its share of the microbatch's
labelled tokens so the loss is the global batch's mean, as the
reference's; AdamW then runs shard by shard with the global gradient
norm, and the new state stays placed as the old.  Without
``grad_shardings`` the step is the one-device step.
"""
from __future__ import annotations

import torch

from repro_torch.costs import moved
from repro_torch.device import on_device, to_device
from repro_torch.distributed.sharding import (ShardedTensor, _gather_leaf,
                                              batch_specs, shard_blocks)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_unflatten)

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params) -> dict:
    """{"params", "opt" (``init_opt_state``), "step": int32 0}: the
    reference's names, so checkpoints cross between the packages."""
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _on(batch: dict, dev: torch.device) -> dict:
    """The batch's arrays (numpy or tensors) on ``dev``."""
    return {k: to_device(torch.as_tensor(v), dev) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tp: int = 1,
                    microbatches: int = 1, grad_shardings=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    ``loss`` (the mean over microbatches), ``grad_norm`` (before
    clipping) and ``lr_step`` (the optimiser's count after the step), as
    device tensors.  ``batch`` holds numpy arrays or tensors whose leading
    axis ``microbatches`` divides; the new state's parameters are
    detached leaves of the old dtypes.  With ``grad_shardings`` the state
    is a placed one and so is the new state."""

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, cfg, batch, tp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_unflatten(params, grads)

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        rows = next(iter(batch.values())).shape[0] // microbatches
        tot_l = torch.zeros((), device=tree_leaves(params)[0].device)
        tot_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(microbatches):
            l, g = value_and_grad(params, {
                k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
            tot_l = tot_l + l
            tot_g = tree_map(torch.add, tot_g, g)
        inv = 1.0 / microbatches
        return tot_l * inv, tree_map(lambda g: g * inv, tot_g)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        dev = tree_leaves(params)[0].device
        loss, grads = grads_of(params, _on(batch, dev))
        new_params, new_opt, gnorm = adamw_update(
            grads, state["opt"], opt_cfg, params=state["params"])
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr_step": new_opt["count"]}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    if grad_shardings is None:
        return train_step
    return _sharded_step(value_and_grad, opt_cfg, microbatches,
                         grad_shardings)


def row_blocks(batch: dict, mesh) -> list[tuple[int, int, int]]:
    """The batch's distinct row blocks under ``batch_specs`` over
    ``DP(mesh)``: (first row, end row, the first mesh position holding
    it), in row order."""
    key = "tokens" if "tokens" in batch else next(iter(batch))
    leaf = batch[key]
    sharding = batch_specs({key: leaf}, mesh)[key]
    return sorted((blk[0][0], blk[0][1], pos[0]) for blk, pos in
                  shard_blocks(tuple(leaf.shape), sharding).items())


def _sharded_step(value_and_grad, opt_cfg: AdamWConfig, microbatches: int,
                  grad_shardings):
    """The step of ``make_train_step(grad_shardings=)`` (module
    docstring)."""
    gsh = dict(tree_items(grad_shardings))
    mesh = next(iter(gsh.values())).mesh
    devs = mesh.devices.reshape(-1)
    root = devs[0]

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        blocks = row_blocks(batch, mesh)
        m = max(microbatches, 1)
        rows = next(iter(batch.values())).shape[0] // m
        pleaves = dict(tree_items(state["params"]))
        gathered: dict[int, dict] = {}      # DP position -> whole params
        # summed gradient blocks: path -> block key -> fp32 tensor
        acc: dict[str, dict] = {}
        loss = torch.zeros((), device=root)
        for i in range(m):
            lo, hi = i * rows, (i + 1) * rows
            parts = [(max(a, lo), min(b, hi), d) for a, b, d in blocks
                     if max(a, lo) < min(b, hi)]
            counts = [int((batch["labels"][a:b] >= 0).sum())
                      if "labels" in batch else b - a for a, b, _ in parts]
            total = max(sum(counts), 1)
            for (a, b, pos), n in zip(parts, counts):
                dev = devs[pos]
                with on_device(dev):
                    if pos not in gathered:        # the FSDP all-gather
                        gathered[pos] = {
                            path: _gather_leaf(x, dev).requires_grad_(True)
                            for path, x in pleaves.items()}
                    params = tree_unflatten(
                        state["params"], [gathered[pos][p] for p in pleaves])
                    part_loss, grads = value_and_grad(params, _on(
                        {k: v[a:b] for k, v in batch.items()}, dev))
                    w = n / total / m
                    loss = loss + (part_loss * w).to(root)
                    for path, g in tree_items(grads):
                        _reduce_scatter(acc.setdefault(path, {}), g, w,
                                        gsh[path])
        return _apply(state, acc, gsh, opt_cfg, loss, root)

    return train_step


def _reduce_scatter(acc: dict, g: torch.Tensor, w: float, sharding) -> None:
    """Adds ``w * g``'s part of each distinct block of ``sharding`` to
    ``acc`` (block -> fp32 tensor on the device of its first holder)."""
    devs = sharding.mesh.devices.reshape(-1)
    for block, positions in shard_blocks(tuple(g.shape), sharding).items():
        part = (g[tuple(slice(a, b) for a, b in block)].float() * w) \
            .to(devs[positions[0]])
        moved("reduce-scatter", part.numel() * part.element_size())
        acc[block] = acc[block] + part if block in acc else part


def _apply(state: dict, acc: dict, gsh: dict, opt_cfg: AdamWConfig,
           loss: torch.Tensor, root: torch.device) -> tuple[dict, dict]:
    """AdamW shard by shard on the summed gradient blocks; the new state
    placed as the old."""
    pleaves = dict(tree_items(state["params"]))
    opt = state["opt"]
    moments = {k: dict(tree_items(opt[k])) for k in ("master", "mu", "nu")}
    sq = [torch.sum(torch.square(t)).to(root)
          for path in pleaves for t in acc[path].values()]
    gnorm = torch.sqrt(sum(sq))
    moved("all-reduce", 4 * len(sq))
    # per device: flat trees of the blocks its first holder keeps
    groups: dict[torch.device, dict] = {}
    where: dict[str, dict] = {}
    for path, x in pleaves.items():
        if tuple(gsh[path].spec) != tuple(x.sharding.spec):
            raise ValueError(f"grad_shardings: {path} is sharded "
                             f"{gsh[path].spec}, its parameter "
                             f"{x.sharding.spec}")
        where[path] = {}
        for block, positions in x.unique().items():
            i = positions[0]
            dev = x.shards[i].device
            name = f"{path}@{i}"
            grp = groups.setdefault(dev, {"g": {}, "p": {}, "master": {},
                                          "mu": {}, "nu": {}})
            grp["g"][name] = acc[path][block]
            grp["p"][name] = x.shards[i]
            for k in ("master", "mu", "nu"):
                grp[k][name] = moments[k][path].shards[i]
            where[path][block] = (dev, name)
    out: dict[torch.device, tuple] = {}
    for dev, grp in groups.items():
        count = _shard_on(opt["count"], dev)
        with on_device(dev):
            out[dev] = adamw_update(grp["g"], {"master": grp["master"],
                                               "mu": grp["mu"],
                                               "nu": grp["nu"],
                                               "count": count},
                                    opt_cfg, params=grp["p"],
                                    gnorm=gnorm.to(dev))

    def rebuild(path: str, x: ShardedTensor, pick) -> ShardedTensor:
        shards = [None] * len(x.shards)
        for block, positions in x.unique().items():
            dev, name = where[path][block]
            t = pick(out[dev])[name]
            for i in positions:
                shards[i] = t if i == positions[0] else \
                    torch.empty_like(t, device=x.shards[i].device).copy_(t)
        return ShardedTensor(x.sharding, x.shape, t.dtype, shards)

    new_params = tree_unflatten(state["params"], [
        rebuild(p, x, lambda o: o[0]) for p, x in pleaves.items()])
    new_opt = {k: tree_unflatten(opt[k], [
        rebuild(p, x, lambda o, k=k: o[1][k])
        for p, x in dict(tree_items(opt[k])).items()])
        for k in ("master", "mu", "nu")}
    new_opt["count"] = _bump(opt["count"])
    metrics = {"loss": loss, "grad_norm": gnorm,
               "lr_step": _shard_on(new_opt["count"], root)}
    return {"params": new_params, "opt": new_opt,
            "step": _bump(state["step"])}, metrics


def _shard_on(x, dev: torch.device) -> torch.Tensor:
    """A replicated leaf's shard on ``dev`` (a plain tensor moved there)."""
    if isinstance(x, ShardedTensor):
        for t in x.shards:
            if t.device == dev:
                return t
        return x.shards[0].to(dev)
    return x.to(dev)


def _bump(x):
    """A replicated counter plus one, placed as it was."""
    if isinstance(x, ShardedTensor):
        return ShardedTensor(x.sharding, x.shape, x.dtype,
                             [t + 1 for t in x.shards])
    return x + 1
