"""AdamW with fp32 master weights and schedules (no torch.optim).

The port of the reference's ``src/repro/optim/adamw.py``: parameters
train in their own dtype (bf16 matrices, fp32 norm scales); the optimiser
keeps fp32 master copies and moments.  Decoupled weight decay
(Loshchilov & Hutter) with global-norm clipping.  The update is
functional, as the reference's: it returns new trees and leaves the
caller's state as it was.  Every quantity stays a tensor on the
parameters' device (the learning rate and bias corrections are fp32
tensors of the int32 ``count``), so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_update", "cosine_schedule",
           "init_opt_state", "linear_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"      # cosine | linear | constant


def _warm_prog(step: torch.Tensor, cfg: AdamWConfig):
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return warm, prog


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then a half cosine to 0 at ``total_steps`` (step an
    fp32 tensor)."""
    warm, prog = _warm_prog(step, cfg)
    return cfg.lr_peak * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def linear_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then linear decay to 0 at ``total_steps``."""
    warm, prog = _warm_prog(step, cfg)
    return cfg.lr_peak * warm * (1.0 - prog)


def _lr(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    if cfg.schedule == "cosine":
        return cosine_schedule(step, cfg)
    if cfg.schedule == "linear":
        return linear_schedule(step, cfg)
    return torch.full((), cfg.lr_peak, device=step.device)


def init_opt_state(params) -> dict:
    """fp32 ``master`` (a copy of every leaf), zero fp32 ``mu`` and ``nu``,
    an int32 ``count`` of 0, on the parameters' device."""
    dev = tree_leaves(params)[0].device

    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return {"master": tree_map(lambda x: x.detach().to(torch.float32,
                                                       copy=True), params),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, opt_state: dict, cfg: AdamWConfig, params=None,
                 gnorm: torch.Tensor | None = None):
    """Returns (new_params, new_opt_state, grad_norm).

    ``params`` (the old tree) gives each new leaf its dtype, so bf16
    leaves stay bf16 and fp32 leaves (norm scales) fp32; without it every
    leaf comes back bf16, as the reference's.  The global norm sums the
    leaves' squares in ``jax.tree`` order; a caller that updates a part
    of the tree (a sharded step, shard by shard) passes the whole tree's
    ``gnorm`` for the clipping."""
    count = opt_state["count"] + 1
    g32 = tree_map(lambda g: g.to(torch.float32), grads)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                               for g in tree_leaves(g32)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    g32 = tree_map(lambda g: g * scale, g32)

    step = count.to(torch.float32)
    lr = _lr(step, cfg)
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                  opt_state["mu"], g32)
    nu = tree_map(lambda n, g: cfg.b2 * n + (1 - cfg.b2) * g * g,
                  opt_state["nu"], g32)

    def upd(p, m, n):
        mh, nh = m / b1c, n / b2c
        return p - lr * (mh / (torch.sqrt(nh) + cfg.eps)
                         + cfg.weight_decay * p)

    master = tree_map(upd, opt_state["master"], mu, nu)
    if params is not None:
        new_params = tree_map(lambda x, p: x.to(p.dtype), master, params)
    else:
        new_params = tree_map(lambda x: x.to(torch.bfloat16), master)
    return new_params, {"master": master, "mu": mu, "nu": nu,
                        "count": count}, gnorm
