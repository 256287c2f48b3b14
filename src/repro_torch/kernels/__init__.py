"""Hand-written Hopper kernels for the hot spots, with their build helper.

Each subpackage keeps the reference's triad: ``kernel.py`` (the launcher
of a CUDA C++ kernel under ``csrc/``), ``ref.py`` (plain PyTorch versions
of the same function, which also run on the CPU) and ``ops.py`` (the
dispatch on the device of the tensors it is given).

Kernels are compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; the
library lands in ``_build/`` next to this file, keyed by a hash of its
sources and flags, so a checkout builds everything it runs from its own
sources.  Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "hopper_available",
           "load_library"]

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[tuple[str, ...], ctypes.CDLL] = {}


def hopper_available() -> bool:
    """True when a CUDA card of compute capability 9.0 or newer is visible
    (the target of every kernel here; replaces the reference's TPU
    ``tpu_compiler_params``)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and pathlib.Path(cand, "bin", "nvcc").exists():
            return str(pathlib.Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "(kernels are compiled on the machine with the "
                           "card)")
    return found


def build_library(name: str, sources: list[pathlib.Path]
                  ) -> tuple[pathlib.Path, str]:
    """Compile ``sources`` into ``_build/lib<name>-<hash>.so``.

    Returns the library path and the compiler's output (``-Xptxas -v``
    prints registers, shared memory and spills per kernel); an existing
    library with the same hash is reused and returns an empty log.  The
    build writes to a temporary name and renames, so two processes
    building at once never load a half-written file.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(pathlib.Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load_library(name: str, sources: list[pathlib.Path]) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process
    (a launch after the first neither rereads nor rehashes the sources)."""
    key = (name, *map(str, sources))
    lib = _LOADED.get(key)
    if lib is None:
        path, _ = build_library(name, sources)
        lib = ctypes.CDLL(str(path))
        _LOADED[key] = lib
    return lib
