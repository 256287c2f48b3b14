"""Train-step factory: loss -> gradients (with microbatch accumulation)
-> AdamW.

The port of the reference's ``src/repro/train/steps.py`` at one device.
The reference's ``tp`` and ``grad_shardings`` (tensor parallelism and
each gradient leaf constrained to its FSDP shard) belong to the specs of
``distributed/`` and are left out (ROADMAP §1 item 6), as ``build_heads``
leaves out its ``tp``.  The step is eager PyTorch: gradients come from
``torch.autograd.grad`` over the parameter leaves (through the kernels'
autograd Functions on the card), microbatches are a Python loop that sums
and then scales by 1 / m, as the reference's ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.device import to_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    ``loss`` (the mean over microbatches), ``grad_norm`` (before
    clipping) and ``lr_step`` (the optimiser's count after the step), as
    device tensors.  ``batch`` holds numpy arrays or tensors whose leading
    axis ``microbatches`` divides; the new state's parameters are
    detached leaves of the old dtypes."""

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, cfg, batch)
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

    return train_step

