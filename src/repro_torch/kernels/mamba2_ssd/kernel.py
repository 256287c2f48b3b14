"""Launcher of the hand-written CUDA SSD chunked scan.

``mamba2_ssd`` (``csrc/mamba2_ssd.cu``) replaces the reference's Pallas
TPU kernel ``src/repro/kernels/mamba2_ssd/kernel.py:68``.  It launches
three kernels in order, the three passes of the chunked form:
``chunk_state`` (each chunk's own state, every chunk of every row in
parallel), ``state_pass`` (the sequential pass over chunk states, in
place) and ``chunk_scan`` (each chunk's output, with the scores of a
group of heads formed once per 64-row strip and applied to 8 heads), the
matrix products in 3xTF32 on the tensor cores.  Each pass also has a
launcher of its own here, held against its plain version in ``ref.py``.
The source says what bounds it on the card.  On a CPU tensor the wrapper
returns the plain chunked form ``ref.mamba2_ssd_chunked``; the sequential
``ref.mamba2_ssd_ref`` is the definition both are held against.
The launches write through ``ctypes`` and record no autograd node: the
differentiable route is ``ops.mamba2_ssd_op`` (its ``Mamba2SSD``
Function), and on CUDA tensors with grad mode on and an input that
requires grad ``mamba2_ssd`` and each pass's launcher raise rather than
return a detached output.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import load_library
from repro_torch.kernels.autograd import wants_grad
from repro_torch.kernels.mamba2_ssd.ref import (chunk_scan_ref,
                                                chunk_state_ref,
                                                mamba2_ssd_chunked,
                                                state_pass_ref)

__all__ = ["chunk_scan", "chunk_state", "mamba2_ssd", "state_pass"]

SOURCES = [pathlib.Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"]
# (library name, sources), for building it with the other kernels
LIBRARIES = (("mamba2_ssd", SOURCES),)
_MAX_SMEM = 232448              # bytes of shared memory a block may use
_MAX_N, _MAX_P = 128, 64         # the state, the head dim


def _lib() -> ctypes.CDLL:
    lib = load_library("mamba2_ssd", SOURCES)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("mamba2_ssd", [ptr] * 6 + [i] * 6 + [ptr]),
            ("mamba2_ssd_chunk_state", [ptr] * 4 + [i] * 6 + [ptr]),
            ("mamba2_ssd_state_pass", [ptr] * 2 + [i] * 5 + [ptr]),
            ("mamba2_ssd_chunk_scan", [ptr] * 6 + [i] * 6 + [ptr]),
            ("mamba2_ssd_smem_bytes", [i] * 3)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x_dt: torch.Tensor, B: torch.Tensor,
           seg: torch.Tensor, chunk: int, *more) -> bool:
    """Validates the shapes; True when the tensors lie on the card (and
    then also their dtype, layout and the kernel's limits)."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    named = (("x_dt", x_dt), ("B", B), ("seg", seg), *more)
    if B.shape[1] != s or seg.shape != (bh, s, 1) or g == 0 or bh % g:
        raise ValueError(f"{name}: x_dt {tuple(x_dt.shape)} needs B and "
                         f"C of [G, S, N] with G dividing BH and seg of "
                         f"[BH, S, 1], got {[tuple(t.shape) for _, t in named]}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"{name}: seq {s} must be a multiple of chunk "
                         f"{chunk}")
    if any(t.device != x_dt.device for _, t in named):
        raise ValueError(f"{name}: x_dt, B, C and seg must lie on one "
                         f"device")
    if x_dt.device.type != "cuda":
        return False
    _no_grad_inputs(name, *(t for _, t in named))
    for nm, t in named:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous float32 "
                             f"tensor, got {t.dtype}")
    if p % 16 or not 0 < p <= _MAX_P or n % 4 or not 0 < n <= _MAX_N:
        raise ValueError(f"{name}: head dim {p} must be a multiple of 16 "
                         f"up to {_MAX_P} and state {n} a multiple of 4 up "
                         f"to {_MAX_N}")
    if _lib().mamba2_ssd_smem_bytes(p, n, chunk) > _MAX_SMEM:
        raise ValueError(f"{name}: state {n} x head dim {p} at chunk "
                         f"{chunk} needs more shared memory than a block "
                         f"has")
    return True


def _no_grad_inputs(name: str, *tensors: torch.Tensor) -> None:
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel records no autograd node and "
                           f"an input requires grad; differentiate through "
                           f"kernels.mamba2_ssd.ops.mamba2_ssd_op (its "
                           f"Mamba2SSD Function)")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def chunk_state(x_dt: torch.Tensor, B: torch.Tensor, seg: torch.Tensor, *,
                chunk: int) -> torch.Tensor:
    """Pass 1 alone: [BH, S / chunk - 1, N, P] chunk states (the kernel on
    CUDA tensors, ``ref.chunk_state_ref`` on CPU tensors)."""
    if not _check("chunk_state", x_dt, B, seg, chunk):
        return chunk_state_ref(x_dt, B, seg, chunk=chunk)
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    states = torch.empty((bh, s // chunk - 1, n, p), device=x_dt.device)
    if states.numel():
        _launched("chunk_state", _lib().mamba2_ssd_chunk_state(
            x_dt.data_ptr(), B.data_ptr(), seg.data_ptr(), states.data_ptr(),
            bh, s, p, n, g, chunk, _stream(x_dt)))
    return states


def state_pass(states: torch.Tensor, seg: torch.Tensor, *,
               chunk: int) -> torch.Tensor:
    """Pass 2 alone: the states entering chunks 1 .. S / chunk - 1 from
    the chunk states (the kernel on a CUDA tensor, in place, returning
    ``states``; ``ref.state_pass_ref`` on a CPU tensor)."""
    bh, nc1, n, p = states.shape
    if states.device.type != "cuda":
        return state_pass_ref(states, seg, chunk=chunk)
    _no_grad_inputs("state_pass", states, seg)
    if seg.shape != (bh, (nc1 + 1) * chunk, 1) or seg.device != states.device:
        raise ValueError(f"state_pass: states {tuple(states.shape)} need seg "
                         f"of [BH, S, 1] on their device, got "
                         f"{tuple(seg.shape)}")
    for nm, t in (("states", states), ("seg", seg)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"state_pass: {nm} must be a contiguous "
                             f"float32 tensor, got {t.dtype}")
    if p % 16 or not 0 < p <= _MAX_P or n % 4 or not 0 < n <= _MAX_N:
        raise ValueError(f"state_pass: head dim {p} must be a multiple of "
                         f"16 up to {_MAX_P} and state {n} a multiple of 4 "
                         f"up to {_MAX_N}")
    if states.numel():
        _launched("state_pass", _lib().mamba2_ssd_state_pass(
            seg.data_ptr(), states.data_ptr(), bh, (nc1 + 1) * chunk, p, n,
            chunk, _stream(states)))
    return states


def chunk_scan(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               seg: torch.Tensor, h_in: torch.Tensor, *,
               chunk: int) -> torch.Tensor:
    """Pass 3 alone: y [BH, S, P] from the states entering each chunk
    (``h_in``, pass 2's output; the kernel on CUDA tensors,
    ``ref.chunk_scan_ref`` on CPU tensors)."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    if h_in.shape != (bh, s // max(chunk, 1) - 1, n, p) or \
            C.shape != B.shape:
        raise ValueError(f"chunk_scan: x_dt {tuple(x_dt.shape)} needs C of "
                         f"B's shape and h_in of [BH, S / chunk - 1, N, P], "
                         f"got {tuple(C.shape)} and {tuple(h_in.shape)}")
    if not _check("chunk_scan", x_dt, B, seg, chunk, ("C", C),
                  ("h_in", h_in)):
        return chunk_scan_ref(x_dt, B, C, seg, h_in, chunk=chunk)
    out = torch.empty_like(x_dt)
    if out.numel():
        _launched("chunk_scan", _lib().mamba2_ssd_chunk_scan(
            x_dt.data_ptr(), B.data_ptr(), C.data_ptr(), seg.data_ptr(),
            h_in.data_ptr(), out.data_ptr(), bh, s, p, n, g, chunk,
            _stream(x_dt)))
    return out


def mamba2_ssd(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Chunked SSD scan.

    x_dt [BH, S, P] (x * dt, batch and heads flattened); B, C [G, S, N],
    shared by the ``BH / G`` consecutive rows of a group; seg [BH, S, 1],
    the within-chunk cumsum of dt * A (``ref.seg_from_dA``); returns y
    [BH, S, P].  On CUDA tensors (fp32; P a multiple of 16 up to 64, N a
    multiple of 4 up to 128) this launches the three passes on the current stream
    (a [BH, S / chunk - 1, N, P] fp32 buffer of chunk states between
    them) and raises if it cannot; on CPU tensors it returns
    ``mamba2_ssd_chunked``.  ``mamba2_ssd.launches`` counts calls that
    launched.
    """
    if C.shape != B.shape:
        raise ValueError(f"mamba2_ssd: x_dt {tuple(x_dt.shape)} needs B and "
                         f"C of [G, S, N] with G dividing BH and seg of "
                         f"[BH, S, 1], got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    if not _check("mamba2_ssd", x_dt, B, seg, chunk, ("C", C)):
        return mamba2_ssd_chunked(x_dt, B, C, seg, chunk=chunk)
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    out = torch.empty_like(x_dt)
    if out.numel() == 0:
        return out
    states = torch.empty((bh, s // chunk - 1, n, p), device=x_dt.device)
    _launched("mamba2_ssd", _lib().mamba2_ssd(
        x_dt.data_ptr(), B.data_ptr(), C.data_ptr(), seg.data_ptr(),
        states.data_ptr(), out.data_ptr(), bh, s, p, n, g, chunk,
        _stream(x_dt)))
    mamba2_ssd.launches += 1
    return out


mamba2_ssd.launches = 0
