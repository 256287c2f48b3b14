"""Launchers of the hand-written CUDA stack-distance kernels.

* ``cache_sim_scan`` (``csrc/cache_sim.cu``) replaces the reference's
  Pallas TPU kernel ``src/repro/kernels/cache_sim/kernel.py:63``: one
  warp walks each row's own reuse interval.
* ``cache_sim_segments_scan`` (``csrc/cache_sim_segments.cu``) replaces
  ``kernel.py:136``: the same count on a padded, self-aligned
  multi-tenant tape, j restricted to the row's ``seg_width`` block; a
  thread block stages its row tile's range through shared memory.

Both count in int32; each source says what bounds it on the card.  Cold
rows (``prev < 0``) come back as -1, here and in the plain versions
(``ref.cache_sim_ref``, ``ref.cache_sim_segments_ref``).  Each source is
its own library, so the two build in parallel.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
                                               cache_sim_segments_ref)

__all__ = ["cache_sim_scan", "cache_sim_segments_scan"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "cache_sim.cu"]
SEGMENTS_SOURCES = [_CSRC / "cache_sim_segments.cu"]
_MAX_N = 2**31 - 32                 # the kernel's j + 32 stays in int32
_MAX_M = 2**31 - 2**14              # every chunk end stays in int32


def _lib() -> ctypes.CDLL:
    lib = load_library("cache_sim", SOURCES)
    fn = lib.cache_sim_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _segments_lib() -> ctypes.CDLL:
    lib = load_library("cache_sim_segments", SEGMENTS_SOURCES)
    fn = lib.cache_sim_segments_scan
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_shapes(prev: torch.Tensor, nxt: torch.Tensor,
                        occ: torch.Tensor) -> None:
    if not (prev.shape == nxt.shape == occ.shape and prev.dim() == 1):
        raise ValueError(f"prev/nxt/occ must be 1-D of one length, got "
                         f"{tuple(prev.shape)}, {tuple(nxt.shape)}, "
                         f"{tuple(occ.shape)}")
    if not (prev.device == nxt.device == occ.device):
        raise ValueError("prev/nxt/occ must lie on one device")


def _check_int32(prev: torch.Tensor, nxt: torch.Tensor,
                 occ: torch.Tensor) -> None:
    for name, t in (("prev", prev), ("nxt", nxt), ("occ", occ)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype}")


def cache_sim_scan(prev: torch.Tensor, nxt: torch.Tensor,
                   occ: torch.Tensor) -> torch.Tensor:
    """prev/nxt/occ int32[n] -> counts int32[n]; -1 at cold rows.

    ``counts[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i }``.
    On CUDA tensors this launches the kernel on the current stream (and
    raises if the launch is refused); on CPU tensors it returns the plain
    version ``cache_sim_ref``.  ``cache_sim_scan.launches`` counts kernel
    launches.
    """
    _check_shapes(prev, nxt, occ)
    if prev.device.type != "cuda":
        return cache_sim_ref(prev, nxt, occ)
    _check_int32(prev, nxt, occ)
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


def cache_sim_segments_scan(prev: torch.Tensor, nxt: torch.Tensor,
                            occ: torch.Tensor,
                            seg_width: int) -> torch.Tensor:
    """prev/nxt/occ int32[m] -> counts int32[m]; -1 at cold and pad rows.

    ``counts[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i,
    j // seg_width == i // seg_width }`` on a tape whose length m is a
    multiple of ``seg_width`` (chunk-local links of one width group of a
    padded tape).  On CUDA tensors this launches the kernel on the
    current stream (and raises if the launch is refused); on CPU tensors
    it returns the plain version ``cache_sim_segments_ref``.
    ``cache_sim_segments_scan.launches`` counts kernel launches.
    """
    _check_shapes(prev, nxt, occ)
    m = prev.shape[0]
    seg_width = int(seg_width)
    if seg_width <= 0 or m % seg_width:
        raise ValueError(f"tape length {m} must be a positive multiple of "
                         f"seg_width {seg_width}")
    if prev.device.type != "cuda":
        return cache_sim_segments_ref(prev, nxt, occ, seg_width)
    _check_int32(prev, nxt, occ)
    if m >= _MAX_M:
        raise ValueError(f"padded tape of {m} entries exceeds the kernel's "
                         f"int32 positions (< {_MAX_M})")
    out = torch.empty_like(prev)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = _segments_lib().cache_sim_segments_scan(
        prev.data_ptr(), nxt.data_ptr(), occ.data_ptr(), out.data_ptr(), m,
        seg_width, stream)
    if err != 0:
        raise RuntimeError(f"cache_sim_segments_scan launch failed "
                           f"(cudaError {err})")
    cache_sim_segments_scan.launches += 1
    return out


cache_sim_segments_scan.launches = 0
