"""The benchmark's weights: made on the device from the run's seed.

Plain tensors in the port's parameter layout (a nested dict, every
per-layer tensor stacked on a leading layer axis), one draw from a
``torch.Generator`` on the device per leaf, in the type they are served
in.  The port's ``init_params`` is not called: the same tensors go to
the program and, widened to fp32 layer by layer, to the reference.  Each
family's ``make_params`` lays out the tree and draws its leaves, in a
fixed order, with a ``Draw``.

Each matrix is normal with std 1/sqrt(its contraction axis), and the
products that write into the residual stream (``wo``, ``w_down``,
``shared_down``) a further 1/sqrt(2 L) smaller (GPT-2's scaled init), so
that the L blocks' outputs do not drown the tokens' embeddings: without
it the random MoE's token states collapse onto the attention average and
its router sends most tokens to the same few experts.  The embedding has
the configuration file's ``assumed.embedding_std``; the norms' offsets
(the port scales by 1 + w) are fp32 normal with std 0.1, so the norm
weights are not all one.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Draw", "padded_vocab"]

NORM_STD = 0.1


def padded_vocab(cfg: dict) -> int:
    """The port's vocabulary rows: ``vocab_size`` rounded up to 256."""
    return -(-cfg["vocab_size"] // 256) * 256


class Draw:
    """Leaves drawn one after another from one generator on ``device``,
    seeded with ``seed``."""

    def __init__(self, cfg: dict, seed: int, device: torch.device | str):
        self.dev = torch.device(device)
        self.dtype = getattr(torch, cfg["torch_dtype"])
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed % 2**64)
        self.layers = cfg["num_hidden_layers"]

    def mat(self, *shape, std=None, residual=False) -> torch.Tensor:
        """A matrix (stack) in the served type; ``std`` by default
        1/sqrt(the contraction axis ``shape[-2]``), and with ``residual``
        1/sqrt(2 L) smaller."""
        t = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=self.dtype)
        if std is None:
            std = 1 / math.sqrt(shape[-2]
                                * (2 * self.layers if residual else 1))
        return t.mul_(std)

    def norm(self, *shape) -> torch.Tensor:
        """A norm's offsets from 1, in fp32."""
        return torch.randn(shape, generator=self.gen, device=self.dev) \
            .mul_(NORM_STD)
