"""Hand-written Hopper kernels for the hot spots, with their build helper.

Each subpackage keeps the reference's triad: ``kernel.py`` (the launcher
of a CUDA C++ kernel under ``csrc/``), ``ref.py`` (plain PyTorch versions
of the same function, which also run on the CPU) and ``ops.py`` (the
dispatch on the device of the tensors it is given).

Kernels are compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; the
library lands in ``_build/`` next to this file, keyed by a hash of its
sources, the headers they include and the flags, so a checkout builds
everything it runs from its own sources and an edited header rebuilds
every library that includes it.  Nothing is built or loaded at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "hopper_available",
           "library_path", "load_library"]

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[tuple[str, ...], ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


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


def _included(sources: list[pathlib.Path]) -> list[pathlib.Path]:
    """Every file the sources include by a quoted path (``#include
    "..."``, resolved against the including file), transitively, in a
    fixed order; system headers (``<...>``) are left to ``NVCC_FLAGS``."""
    found: dict[pathlib.Path, None] = {}
    todo = [pathlib.Path(s).resolve() for s in sources]
    while todo:
        src = todo.pop()
        for rel in _INCLUDE.findall(src.read_text()):
            inc = (src.parent / rel).resolve()
            if inc not in found:
                found[inc] = None
                todo.append(inc)
    return sorted(found)


def library_path(name: str, sources: list[pathlib.Path]) -> pathlib.Path:
    """``_build/lib<name>-<hash>.so``: the hash covers the flags, every
    source and every header the sources include, so editing any of them
    names a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *_included(sources)):
        h.update(pathlib.Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: list[pathlib.Path]
                  ) -> tuple[pathlib.Path, str]:
    """Compile ``sources`` into ``library_path(name, sources)``.

    ``nvcc`` is given the sources only; the headers they include are
    hashed with them.  Returns the library path and the compiler's output
    (``-Xptxas -v`` prints registers, shared memory and spills per
    kernel); an existing library with the same hash is reused and returns
    an empty log.  The build writes to a temporary name and renames, so
    two processes building at once never load a half-written file.
    """
    out = library_path(name, sources)
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
