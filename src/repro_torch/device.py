"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; the CPU is used only when asked for.

    Raises when the card is requested (explicitly or by default) and none
    is visible — never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the port on the CPU")
    return dev
