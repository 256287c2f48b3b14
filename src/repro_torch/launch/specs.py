"""Stand-in inputs and the step function of every dry-run cell.

The port of the reference's ``src/repro/launch/specs.py``.
``build_cell(arch, shape)`` returns the cell's step and its arguments:

  train_*            -> train_step(state, batch)
  prefill_*          -> prefill(params, batch)   (last-position logits)
  decode_* / long_*  -> serve_step(params, tokens, cache)   (1 new token)

On ``device="meta"`` (the default, the dry run's) every stand-in (params,
optimizer state, batch, cache) is a meta tensor: shapes and dtypes only,
no storage, so a 104B model costs nothing to build (the counterpart of
the reference's ``eval_shape``).  On a real device the same step gets
values: parameters from ``seed``, token ids and encoder embeddings
drawn from it, and a decode cache filled with seeded normal values and
``len`` = ``seq_len - 1`` (instead of a prefill of that length), so a
cell can run for real; ``global_batch`` cuts the batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import place, state_specs
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, Family, ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

__all__ = ["CellSpec", "ENC_DECODE_CROSS_LEN", "TP_DEGREE", "build_cell"]

TP_DEGREE = 16                       # production model-axis size
ENC_DECODE_CROSS_LEN = 4096          # enc-dec decode: encoder output length
ENC_TRAIN_RATIO = 1                  # enc len == dec len for train/prefill


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    step_fn: object                 # the callable the cell runs
    args: tuple                     # its arguments (meta tensors on meta)
    kind: str                       # train | prefill | decode


def build_cell(arch: str, shape_name: str, *, tp: int = TP_DEGREE,
               remat: str | None = "full", microbatches: int = 1,
               commit: bool = False, grad_shardings=None,
               device: str | torch.device = "meta", seed: int = 0,
               global_batch: int | None = None) -> CellSpec:
    """The cell's step and arguments (module docstring).  Train cells
    take ``remat``; with ``grad_shardings`` the train step is the sharded
    one and its state is placed by ``state_specs`` on their mesh.  Decode
    cells run ``decode_step(commit=commit)``: ``False`` is the split-KV
    decode with the cache frozen."""
    dev = resolve_device(device)
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if remat is not None and shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=remat)
    b = global_batch or shape.global_batch
    s = shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)

    def tokens(*size):
        if gen is None:
            return torch.empty(size, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, size, generator=gen,
                             dtype=torch.int32, device=dev)

    def normal(*size):
        out = torch.empty(size, dtype=dtype, device=dev)
        return out if gen is None else out.normal_(generator=gen)

    params = M.init_params(cfg, seed, dev, tp=tp)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(), tp=tp,
                               microbatches=microbatches,
                               grad_shardings=grad_shardings)
        state = init_train_state(params)
        if grad_shardings is not None:
            mesh = tree_leaves(grad_shardings)[0].mesh
            state = place(state, state_specs(state, mesh))
        batch = {"tokens": tokens(b, s), "labels": tokens(b, s)}
        if cfg.family == Family.ENCDEC:
            batch["enc_embeds"] = normal(b, s * ENC_TRAIN_RATIO, cfg.d_model)
        return CellSpec(arch, shape, cfg, step, (state, batch), "train")

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return M.prefill(params, cfg, batch["tokens"], tp,
                             enc_embeds=batch.get("enc_embeds"))
        batch = {"tokens": tokens(b, s if cfg.family != Family.ENCDEC
                                  else s // 8)}
        if cfg.family == Family.ENCDEC:
            batch["enc_embeds"] = normal(b, s, cfg.d_model)
        return CellSpec(arch, shape, cfg, prefill_step, (params, batch),
                        "prefill")

    # decode: one new token against a seq_len-deep cache, kept frozen
    # (split-KV + lse merge) unless commit
    def serve_step(params, tokens, cache):
        return M.decode_step(params, cfg, tokens, cache, tp, commit=commit)

    enc_len = ENC_DECODE_CROSS_LEN if cfg.family == Family.ENCDEC else 0
    cache = M.init_decode_cache(cfg, b, s, dev, enc_len=enc_len, tp=tp)
    if gen is not None:
        for t in [*cache.get("kv", {}).values(),
                  *(cache[k] for k in ("cross_k", "cross_v") if k in cache)]:
            t.normal_(generator=gen)
        cache["len"].fill_(s - 1)
    return CellSpec(arch, shape, cfg, serve_step, (params, tokens(b), cache),
                    "decode")

