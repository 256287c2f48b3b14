"""Launchers of the hand-written CUDA RO eviction-token replays.

``ro_token_replay_scan`` and ``ro_token_replay_levels_scan``
(``csrc/ro_replay.cu``) replace no TPU kernel: the reference replays an
RO tenant under eviction pressure with a host loop, or on a TPU host a
``lax.fori_loop`` (``src/repro/core/batch_sim.py:726``, ``:845``).  Each
replays several tenant blocks of one tape in one launch, a CTA a block:
all its threads lay out ``death`` and ``lvl``; then warp 0 walks the
block, its 32 lanes in lockstep (a victim is found by a ballot over a
window of pointer words), on read-only words that warps 1-3 stage ahead
of it in shared-memory rings (the victim pointers step past each token
they act on, so the walk never reads ``death``, ``lvl`` or ``dirty``),
while warps 4-7 compute each row's birth dirty flag by pointer jumping
along the read-hit chains, a 4,096-row tile behind the walk; last, all
threads clear the flags of tokens cleaned at their demotion and sum the
flushes (``csrc/ro_replay.cu`` says why and what bounds it;
``ref.ro_token_replay_pointer_ref`` and
``ref.ro_token_replay_levels_pointer_ref`` are the same formulation in
plain PyTorch).  The block descriptors are host integers (the caller
knows its blocks); they cross to the card once, from pinned memory, when
the launch is prepared (``prepare_launch``, which the wrappers launch
through).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.device import to_device
from repro_torch.kernels import load_library
from repro_torch.kernels.ro_replay.ref import (
    ro_token_replay_blocks_ref, ro_token_replay_levels_blocks_ref)

__all__ = ["ro_token_replay_levels_scan", "ro_token_replay_scan"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "ro_replay.cu"]
# (library name, sources), for building it beside the others
LIBRARIES = (("ro_replay", SOURCES),)
_MAX_N = 2**31 - 1                  # positions are int32 on the card
# the pointer arguments of each entry point (inputs, descriptors, outputs)
_POINTERS = {"ro_token_replay_scan": 8, "ro_token_replay_levels_scan": 9}


def library(name: str = "ro_replay", sources=None) -> ctypes.CDLL:
    """The kernels' library, built from ``sources`` (``SOURCES`` unless
    given) on first use, with its entry points' argument types set."""
    lib = load_library(name, SOURCES if sources is None else sources)
    for fn_name, ptrs in _POINTERS.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * ptrs
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_tape(is_read, prev, nxt, force, starts, ends) -> None:
    first = is_read
    if not all(t.dim() == 1 and t.shape == first.shape
               and t.device == first.device
               for t in (prev, nxt, force)):
        raise ValueError("is_read/prev/nxt/force must be 1-D of one length "
                         "on one device")
    for name, t, dt in (("is_read", is_read, torch.bool),
                        ("force", force, torch.bool),
                        ("prev", prev, torch.int32),
                        ("nxt", nxt, torch.int32)):
        if t.device.type == "cuda" and (t.dtype != dt
                                        or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor, got "
                             f"{t.dtype}")
    n = first.shape[0]
    if n > _MAX_N:
        raise ValueError(f"tape of {n} rows exceeds int32 positions")
    for s, e in zip(starts, ends):
        if not 0 <= s <= e <= n:
            raise ValueError(f"block [{s}, {e}) outside the tape of {n} rows")


def _descriptors(starts, ends, *caps) -> tuple[list[list[int]], int]:
    """Rows of (start, end, out, *caps) and the output length."""
    rows, out = [], 0
    for s, e, *c in zip(starts, ends, *caps):
        rows.append([int(s), int(e), out, *(int(x) for x in c)])
        out += int(e) - int(s)
    return rows, out


def prepare_launch(name: str, is_read: torch.Tensor, prev: torch.Tensor,
                   nxt: torch.Tensor, force: torch.Tensor, starts, ends,
                   *caps, lib: ctypes.CDLL | None = None):
    """Stage one launch of the entry point ``name`` on CUDA tensors: the
    block descriptors copied to the card and the outputs allocated, once.

    ``caps`` are the wrapper's (``caps``, or ``cap1, cap2, l2_end,
    clean2``).  Returns ``(launch, outputs)``: ``launch()`` runs the
    kernel on the current stream into ``outputs`` (a CUDA graph can
    capture it) and raises if the launch is refused; it is ``None`` when
    there are no blocks.  ``lib`` is the library to launch (``library()``
    unless given).  Nothing here counts launches: the wrappers do.
    """
    levels = name == "ro_token_replay_levels_scan"
    if levels:
        caps = (*caps[:3], [bool(c) for c in caps[3]])
    rows, m = _descriptors(starts, ends, *caps)
    dev = is_read.device
    outs = [torch.empty(m, dtype=torch.int32, device=dev),
            torch.empty(m, dtype=torch.bool, device=dev)]
    if levels:
        outs.append(torch.empty(m, dtype=torch.int8, device=dev))
    outs.append(torch.empty((2 if levels else 1) * len(rows),
                            dtype=torch.int64, device=dev))
    if not rows:
        return None, tuple(outs)
    desc = to_device(torch.tensor(rows, dtype=torch.int64), dev)
    fn = getattr(library() if lib is None else lib, name)
    args = (is_read, prev, nxt, force, desc, *outs)

    def launch() -> None:
        err = fn(*(t.data_ptr() for t in args), len(rows),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed (cudaError {err})")
    return launch, tuple(outs)


def ro_token_replay_scan(is_read: torch.Tensor, prev: torch.Tensor,
                         nxt: torch.Tensor, force: torch.Tensor, starts,
                         ends, caps
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Single-level RO replays of the blocks ``[starts[k], ends[k])`` of one
    tape at capacities ``caps[k]`` (host integers).

    ``is_read``/``force`` bool[n] and ``prev``/``nxt`` int32[n] (global
    positions, links severed at the blocks, ``nxt`` clamped to the block
    end).  Returns ``(death, dirty, flushes)``: ``death`` int32 (local
    positions) and ``dirty`` bool of the blocks' rows, block after block,
    and ``flushes`` int64[K].  On CUDA tensors this launches one kernel
    on the current stream (and raises if the launch is refused); on CPU
    tensors it returns the plain version ``ro_token_replay_blocks_ref``.
    ``ro_token_replay_scan.launches`` counts kernel launches.
    """
    _check_tape(is_read, prev, nxt, force, starts, ends)
    if is_read.device.type != "cuda":
        return ro_token_replay_blocks_ref(is_read, prev, nxt, force, starts,
                                          ends, caps)
    launch, outs = prepare_launch("ro_token_replay_scan", is_read, prev,
                                  nxt, force, starts, ends, caps)
    if launch is not None:
        launch()
        ro_token_replay_scan.launches += 1
    return outs


ro_token_replay_scan.launches = 0


def ro_token_replay_levels_scan(is_read: torch.Tensor, prev: torch.Tensor,
                                nxt: torch.Tensor, force: torch.Tensor,
                                starts, ends, cap1, cap2, l2_end, clean2
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """Two-level RO replays of the blocks ``[starts[k], ends[k])`` of one
    tape, block k at ``cap1[k]``/``cap2[k]`` with its warm-L2 rows below
    the local ``l2_end[k]`` and a clean L2 where ``clean2[k]`` (host
    values).

    Inputs as for ``ro_token_replay_scan``.  Returns ``(death, dirty,
    lvl, counts)``: the blocks' rows block after block (``death`` int32,
    local positions; ``lvl`` int8, the level each token died in) and
    ``counts`` int64[2K], the flushes of block k at k and its demotions
    at K + k.  On CUDA tensors this launches one kernel on the current
    stream (and raises if the launch is refused); on CPU tensors it
    returns the plain version ``ro_token_replay_levels_blocks_ref``.
    ``ro_token_replay_levels_scan.launches`` counts kernel launches.
    """
    _check_tape(is_read, prev, nxt, force, starts, ends)
    if is_read.device.type != "cuda":
        return ro_token_replay_levels_blocks_ref(
            is_read, prev, nxt, force, starts, ends, cap1, cap2, l2_end,
            clean2)
    launch, outs = prepare_launch("ro_token_replay_levels_scan", is_read,
                                  prev, nxt, force, starts, ends, cap1,
                                  cap2, l2_end, clean2)
    if launch is not None:
        launch()
        ro_token_replay_levels_scan.launches += 1
    return outs


ro_token_replay_levels_scan.launches = 0
