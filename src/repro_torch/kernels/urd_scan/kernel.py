"""Launcher of the hand-written CUDA reuse-distance kernel.

``urd_scan`` (``csrc/urd_scan.cu``) replaces the reference's Pallas TPU
kernel ``src/repro/kernels/urd_scan/kernel.py:62``: ``cache_sim_scan``'s
tiled count on sorted tiles (``kernels/cache_sim/csrc/tiled_count.cuh``)
with every position occupying, keyed on ``nxt`` itself, two kernels a
call (``kernels.cache_sim.ref.cache_sim_tiled_ref`` with ``occ = 1`` is
the decomposition in plain torch).  It counts in int32; the source says
what bounds it on the card.  Cold rows (``prev < 0``) come back as -1,
here and in the plain versions.  On a CPU tensor the wrapper takes the
plain merge-tree route (``kernels.cache_sim.ref.stack_distances_tree``),
which gives the same integers at any length; the dense
``ref.urd_scan_ref`` is the definition the kernel is held against, for
small n.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.cache_sim.kernel import (_check_int32, _check_shapes,
                                                  tiled_scratch)
from repro_torch.kernels.cache_sim.ref import stack_distances_tree

__all__ = ["urd_scan"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc" / "urd_scan.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("urd_scan", SOURCES),)
_MAX_N = 2**31 - 32                 # the contract's bound: n, i in int32


def _lib() -> ctypes.CDLL:
    lib = load_library("urd_scan", SOURCES)
    fn = lib.urd_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def urd_scan(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """prev/nxt int32[n] -> counts int32[n]; -1 at cold rows.

    ``counts[i] = #{ j : prev[i] < j < i, nxt[j] >= i }``.  On CUDA
    tensors this launches the two kernels on the current stream (and
    raises if a launch is refused); on CPU tensors it returns the plain
    merge-tree count.  ``urd_scan.launches`` counts calls that launched.
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
    if nxt.data_ptr() % 16:         # the kernel reads nxt as 16-byte vectors
        nxt = nxt.clone()
    scratch = tiled_scratch(n, prev.device, keys=False)
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    err = _lib().urd_scan(prev.data_ptr(), nxt.data_ptr(), out.data_ptr(),
                          scratch.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"urd_scan launch failed (cudaError {err})")
    urd_scan.launches += 1
    return out


urd_scan.launches = 0
