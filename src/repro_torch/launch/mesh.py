"""Production meshes, on the caller's device.

The port of the reference's ``src/repro/launch/mesh.py``: functions, so
importing this module touches no device.  A mesh is one controller's set
of ``torch.device``s (``distributed.sharding.Mesh``); these meshes are
made of logical shards of the one device the caller names (the machine
that runs the port has one card).  ``None`` means the CUDA card and
raises without one, as the port's other entry points; the dry run passes
``"meta"``, which allocates nothing (the counterpart of the reference's
forced host devices plus ``eval_shape``).

Axes: ``model`` (16) carries TP / EP / SP, ``data`` (16) FSDP gathers and
the DP gradient reduction, ``pod`` (2) only the DP gradient reduction or
pipeline stage boundaries.
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh

__all__ = ["dp_axes", "make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data",
    "model")``, logical shards of ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.of(resolve_device(device), shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device=None) -> Mesh:
    """A small mesh for tests: (data, model), or (pod, data, model)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return Mesh.of(resolve_device(device), shape, axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') when the pod axis exists."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
