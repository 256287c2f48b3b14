"""Launcher of the hand-written CUDA ``cache_sim_scan`` (``csrc/cache_sim.cu``).

Replaces the reference's Pallas TPU kernel
(``src/repro/kernels/cache_sim/kernel.py:63``).  The kernel walks each
row's own reuse interval with one warp and counts in int32; the source
says what bounds it on the card.  Cold rows (``prev < 0``) come back as
-1, here and in the plain version (``ref.cache_sim_ref``).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.cache_sim.ref import cache_sim_ref

__all__ = ["cache_sim_scan"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc" / "cache_sim.cu"]
_MAX_N = 2**31 - 32                 # the kernel's j + 32 stays in int32


def _lib() -> ctypes.CDLL:
    lib = load_library("cache_sim", SOURCES)
    fn = lib.cache_sim_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cache_sim_scan(prev: torch.Tensor, nxt: torch.Tensor,
                   occ: torch.Tensor) -> torch.Tensor:
    """prev/nxt/occ int32[n] -> counts int32[n]; -1 at cold rows.

    ``counts[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i }``.
    On CUDA tensors this launches the kernel on the current stream (and
    raises if the launch is refused); on CPU tensors it returns the plain
    version ``cache_sim_ref``.  ``cache_sim_scan.launches`` counts kernel
    launches.
    """
    if not (prev.shape == nxt.shape == occ.shape and prev.dim() == 1):
        raise ValueError(f"prev/nxt/occ must be 1-D of one length, got "
                         f"{tuple(prev.shape)}, {tuple(nxt.shape)}, "
                         f"{tuple(occ.shape)}")
    if not (prev.device == nxt.device == occ.device):
        raise ValueError("prev/nxt/occ must lie on one device")
    if prev.device.type != "cuda":
        return cache_sim_ref(prev, nxt, occ)
    for name, t in (("prev", prev), ("nxt", nxt), ("occ", occ)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype}")
    n = prev.shape[0]
    if n >= _MAX_N:
        raise ValueError(f"tape of {n} accesses exceeds the kernel's "
                         f"int32 positions (< {_MAX_N})")
    out = torch.empty_like(prev)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = _lib().cache_sim_scan(prev.data_ptr(), nxt.data_ptr(),
                                occ.data_ptr(), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"cache_sim_scan launch failed (cudaError {err})")
    cache_sim_scan.launches += 1
    return out


cache_sim_scan.launches = 0
