"""Assigned-architecture registry: ``--arch <id>`` resolves here.

The port's own copy of the reference's ``repro.configs`` (data only).
Each module defines ``CONFIG`` (exact pool spec) and ``SMOKE_CONFIG``
(a reduced same-family config for CPU smoke tests).  ``SKIP_SHAPES`` lists
shape cells inapplicable to the family.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES

ARCH_IDS = [
    "qwen2_moe_a2_7b",
    "deepseek_moe_16b",
    "chameleon_34b",
    "zamba2_7b",
    "mamba2_780m",
    "command_r_plus_104b",
    "minicpm3_4b",
    "qwen3_0_6b",
    "h2o_danube_3_4b",
    "seamless_m4t_large_v2",
]

# accept dashed aliases from the pool listing
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE_CONFIG


def skip_shapes(arch: str) -> set[str]:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return getattr(mod, "SKIP_SHAPES", set())


def all_cells() -> list[tuple[str, ShapeConfig]]:
    """Every (arch, shape) cell that runs (40 minus documented skips)."""
    cells = []
    for a in ARCH_IDS:
        skips = skip_shapes(a)
        for s in SHAPES.values():
            if s.name not in skips:
                cells.append((a, s))
    return cells
