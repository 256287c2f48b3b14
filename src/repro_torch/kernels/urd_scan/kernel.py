"""Launcher of the hand-written CUDA reuse-distance kernel.

``urd_scan`` (``csrc/urd_scan.cu``) replaces the reference's Pallas TPU
kernel ``src/repro/kernels/urd_scan/kernel.py:62``: one warp walks each
row's own reuse interval and counts the positions whose next occurrence
reaches the row.  It counts in int32; the source says what bounds it on
the card.  Cold rows (``prev < 0``) come back as -1, here and in the
plain versions.  On a CPU tensor the wrapper takes the plain merge-tree
route (``kernels.cache_sim.ref.stack_distances_tree``), which gives the
same integers at any length; the dense ``ref.urd_scan_ref`` is the
definition the kernel is held against, for small n.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.cache_sim.kernel import _check_int32, _check_shapes
from repro_torch.kernels.cache_sim.ref import stack_distances_tree

__all__ = ["urd_scan"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc" / "urd_scan.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("urd_scan", SOURCES),)
_MAX_N = 2**31 - 32                 # the kernel's j + 32 stays in int32


def _lib() -> ctypes.CDLL:
    lib = load_library("urd_scan", SOURCES)
    fn = lib.urd_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def urd_scan(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """prev/nxt int32[n] -> counts int32[n]; -1 at cold rows.

    ``counts[i] = #{ j : prev[i] < j < i, nxt[j] >= i }``.  On CUDA
    tensors this launches the kernel on the current stream (and raises if
    the launch is refused); on CPU tensors it returns the plain merge-tree
    count.  ``urd_scan.launches`` counts kernel launches.
    """
    links = (("prev", prev), ("nxt", nxt))
    _check_shapes(*links)
    if prev.device.type != "cuda":
        return stack_distances_tree(prev, nxt).to(torch.int32)
    _check_int32(*links)
    n = prev.shape[0]
    if n >= _MAX_N:
        raise ValueError(f"tape of {n} accesses exceeds the kernel's "
                         f"int32 positions (< {_MAX_N})")
    out = torch.empty_like(prev)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = _lib().urd_scan(prev.data_ptr(), nxt.data_ptr(), out.data_ptr(), n,
                          stream)
    if err != 0:
        raise RuntimeError(f"urd_scan launch failed (cudaError {err})")
    urd_scan.launches += 1
    return out


urd_scan.launches = 0
