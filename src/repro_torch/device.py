"""Where the port's entry points run (on the card unless asked otherwise),
and how host tensors cross to it."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["on_device", "resolve_device", "to_device"]


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


def to_device(x: torch.Tensor, device: str | torch.device) -> torch.Tensor:
    """``x`` on ``device``.  A host tensor crosses to a CUDA device from
    pinned memory with ``non_blocking=True``: the copy is queued on the
    current stream and the host does not wait for the card (a pageable
    copy would synchronize the stream first).  Elsewhere ``x.to``."""
    dev = torch.device(device)
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


def on_device(dev: torch.device):
    """Work issued under ``dev``: its card made current for a CUDA device
    (a mesh's shards may sit on distinct cards), nothing elsewhere."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())
