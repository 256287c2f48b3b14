"""Launcher of the hand-written CUDA SSD chunked scan.

``mamba2_ssd`` (``csrc/mamba2_ssd.cu``) replaces the reference's Pallas
TPU kernel ``src/repro/kernels/mamba2_ssd/kernel.py:68``: one CTA per
(batch * head) row loops over the row's chunks with the fp32 state in
shared memory, cutting each chunk into 64-row strips.  The source says
what bounds it on the card.  On a CPU tensor the wrapper returns the
plain chunked form ``ref.mamba2_ssd_chunked``; the sequential
``ref.mamba2_ssd_ref`` is the definition both are held against.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked

__all__ = ["mamba2_ssd"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("mamba2_ssd", SOURCES),)
_MAX_SMEM = 232448              # bytes of shared memory a block may use
_MAX_P = 128


def _lib() -> ctypes.CDLL:
    lib = load_library("mamba2_ssd", SOURCES)
    fn = lib.mamba2_ssd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mamba2_ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.mamba2_ssd_smem_bytes.restype = ctypes.c_int
    return lib


def mamba2_ssd(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Chunked SSD scan.

    x_dt [BH, S, P] (x * dt, batch and heads flattened); B, C [G, S, N],
    shared by the ``BH / G`` consecutive rows of a group; seg [BH, S, 1],
    the within-chunk cumsum of dt * A (``ref.seg_from_dA``); returns y
    [BH, S, P].  On CUDA tensors (fp32) this launches the kernel on the
    current stream and raises if it cannot; on CPU tensors it returns
    ``mamba2_ssd_chunked``.  ``mamba2_ssd.launches`` counts launches.
    """
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    named = (("x_dt", x_dt), ("B", B), ("C", C), ("seg", seg))
    if C.shape != B.shape or B.shape[1] != s or seg.shape != (bh, s, 1) \
            or g == 0 or bh % g:
        raise ValueError(f"mamba2_ssd: x_dt {tuple(x_dt.shape)} needs B and "
                         f"C of [G, S, N] with G dividing BH and seg of "
                         f"[BH, S, 1], got {[tuple(t.shape) for _, t in named]}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"mamba2_ssd: seq {s} must be a multiple of chunk "
                         f"{chunk}")
    if any(t.device != x_dt.device for _, t in named):
        raise ValueError("mamba2_ssd: x_dt, B, C and seg must lie on one "
                         "device")
    if x_dt.device.type != "cuda":
        return mamba2_ssd_chunked(x_dt, B, C, seg, chunk=chunk)
    for name, t in named:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mamba2_ssd: {name} must be a contiguous "
                             f"float32 tensor, got {t.dtype}")
    if p % 16 or not 0 < p <= _MAX_P:
        raise ValueError(f"mamba2_ssd: head dim {p} must be a multiple of "
                         f"16 up to {_MAX_P}")
    lib = _lib()
    if lib.mamba2_ssd_smem_bytes(p, n, chunk) > _MAX_SMEM:
        raise ValueError(f"mamba2_ssd: state {n} x head dim {p} at chunk "
                         f"{chunk} needs more shared memory than a block "
                         f"has")
    out = torch.empty_like(x_dt)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x_dt.device).cuda_stream
    err = lib.mamba2_ssd(x_dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                         seg.data_ptr(), out.data_ptr(), bh, s, p, n, g,
                         chunk, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd launch failed (cudaError {err})")
    mamba2_ssd.launches += 1
    return out


mamba2_ssd.launches = 0
