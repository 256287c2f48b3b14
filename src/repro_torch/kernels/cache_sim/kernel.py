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
from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                               cache_sim_ref,
                                               cache_sim_segments_ref,
                                               live_counts_ref)

__all__ = ["cache_sim_levels_scan", "cache_sim_scan",
           "cache_sim_segments_scan", "live_count_scan"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "cache_sim.cu"]
SEGMENTS_SOURCES = [_CSRC / "cache_sim_segments.cu"]
LEVELS_SOURCES = [_CSRC / "cache_sim_levels.cu"]
LIVE_SOURCES = [_CSRC / "live_count.cu"]
# (library name, sources) of every kernel here, for building them together
LIBRARIES = (("cache_sim", SOURCES), ("cache_sim_segments", SEGMENTS_SOURCES),
             ("cache_sim_levels", LEVELS_SOURCES),
             ("live_count", LIVE_SOURCES))
_LIVE_TILE = 8192                   # live_count.cu's kTile
_MAX_N = 2**31 - 32                 # the kernel's j + 32 stays in int32
_MAX_LEVELS_N = 2**31 - 128         # cache_sim_levels.cu reads 128 ahead
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


def _levels_lib() -> ctypes.CDLL:
    lib = load_library("cache_sim_levels", LEVELS_SOURCES)
    fn = lib.cache_sim_levels_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _live_lib() -> ctypes.CDLL:
    lib = load_library("live_count", LIVE_SOURCES)
    fn = lib.live_count_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_shapes(*named: tuple[str, torch.Tensor]) -> None:
    first = named[0][1]
    if not all(t.shape == first.shape for _, t in named) \
            or first.dim() != 1:
        raise ValueError(f"{'/'.join(nm for nm, _ in named)} must be 1-D "
                         f"of one length, got "
                         f"{[tuple(t.shape) for _, t in named]}")
    if not all(t.device == first.device for _, t in named):
        raise ValueError(f"{'/'.join(nm for nm, _ in named)} must lie on "
                         f"one device")


def _check_int32(*named: tuple[str, torch.Tensor]) -> None:
    for name, t in named:
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
    links = (("prev", prev), ("nxt", nxt), ("occ", occ))
    _check_shapes(*links)
    if prev.device.type != "cuda":
        return cache_sim_ref(prev, nxt, occ)
    _check_int32(*links)
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
    links = (("prev", prev), ("nxt", nxt), ("occ", occ))
    _check_shapes(*links)
    m = prev.shape[0]
    seg_width = int(seg_width)
    if seg_width <= 0 or m % seg_width:
        raise ValueError(f"tape length {m} must be a positive multiple of "
                         f"seg_width {seg_width}")
    if prev.device.type != "cuda":
        return cache_sim_segments_ref(prev, nxt, occ, seg_width)
    _check_int32(*links)
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


def cache_sim_levels_scan(prev: torch.Tensor, nxt: torch.Tensor,
                          occ: torch.Tensor, cap1: torch.Tensor,
                          captot: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """prev/nxt/occ/cap1/captot int32[n] -> masks ``(l1, union)`` int32[n].

    With ``SD[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i }``:
    ``l1[i] = prev[i] >= 0 and SD[i] < cap1[i]`` and ``union[i] =
    prev[i] >= 0 and SD[i] < captot[i]``, 0/1; cold rows are 0.  Needs
    ``cap1 <= captot`` row by row.  On CUDA tensors this launches the
    kernel on the current stream (and raises if the launch is refused);
    on CPU tensors it returns the plain version ``cache_sim_levels_ref``.
    ``cache_sim_levels_scan.launches`` counts kernel launches.
    """
    args = (("prev", prev), ("nxt", nxt), ("occ", occ), ("cap1", cap1),
            ("captot", captot))
    _check_shapes(*args)
    if prev.device.type != "cuda":
        return cache_sim_levels_ref(prev, nxt, occ, cap1, captot)
    _check_int32(*args)
    n = prev.shape[0]
    if n >= _MAX_LEVELS_N:
        raise ValueError(f"tape of {n} accesses exceeds the kernel's "
                         f"int32 positions (< {_MAX_LEVELS_N})")
    # a deliberate host read of the input check; RL001 flags it only
    # because the reference's jitted code calls its own function of this
    # name (the lint resolves callees by name across kernel modules),
    # and nothing traces this torch wrapper
    if not bool((cap1 <= captot).all()):  # repro-lint: disable=RL001
        raise ValueError("cap1 must not exceed captot on any row")
    l1 = torch.empty_like(prev)
    un = torch.empty_like(prev)
    if n == 0:
        return l1, un
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = _levels_lib().cache_sim_levels_scan(
        prev.data_ptr(), nxt.data_ptr(), occ.data_ptr(), cap1.data_ptr(),
        captot.data_ptr(), l1.data_ptr(), un.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"cache_sim_levels_scan launch failed "
                           f"(cudaError {err})")
    cache_sim_levels_scan.launches += 1
    return l1, un


cache_sim_levels_scan.launches = 0


def live_count_scan(nxt: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """nxt/occ int32[n] -> live counts int32[n].

    ``L[i] = #{ j <= i : occ[j] > 0, nxt[j] > i }`` (rows with
    ``nxt[j] <= j`` never count).  On CUDA tensors this launches the
    kernel on the current stream (and raises if the launch is refused);
    on CPU tensors it returns the plain version ``live_counts_ref``.
    ``live_count_scan.launches`` counts kernel launches.
    """
    args = (("nxt", nxt), ("occ", occ))
    _check_shapes(*args)
    if nxt.device.type != "cuda":
        return live_counts_ref(nxt, occ)
    _check_int32(*args)
    n = nxt.shape[0]
    if n >= _MAX_M:
        raise ValueError(f"tape of {n} accesses exceeds the kernel's "
                         f"int32 positions (< {_MAX_M})")
    out = torch.empty_like(nxt)
    if n == 0:
        return out
    scratch = torch.empty(n + -(-n // _LIVE_TILE), dtype=torch.int32,
                          device=nxt.device)
    stream = torch.cuda.current_stream(nxt.device).cuda_stream
    err = _live_lib().live_count_scan(nxt.data_ptr(), occ.data_ptr(),
                                      out.data_ptr(), scratch.data_ptr(), n,
                                      stream)
    if err != 0:
        raise RuntimeError(f"live_count_scan launch failed "
                           f"(cudaError {err})")
    live_count_scan.launches += 1
    return out


live_count_scan.launches = 0
