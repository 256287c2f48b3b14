"""The port's kernel build helper: what names a library.

A library is ``_build/lib<name>-<hash>.so``, and the hash must change with
anything that changes the compiled code: the flags, the sources and every
header the sources include, which ``library_path`` finds itself from the
quoted ``#include`` lines.  ``cache_sim_scan``, ``cache_sim_levels_scan``,
``urd_scan`` and ``cache_sim_segments_scan`` share
``cache_sim/csrc/tiled_count.cuh``, so an edit to it must rename all four
libraries (a stale one would be loaded otherwise).  Nothing here
compiles: ``library_path`` only hashes.
"""
import pathlib
import re
import shutil

import pytest

from repro_torch import kernels
from repro_torch.kernels import library_path
from repro_torch.kernels.cache_sim.kernel import LIBRARIES as CACHE_SIM
from repro_torch.kernels.flash_attention.kernel import LIBRARIES as FLASH
from repro_torch.kernels.mamba2_ssd.kernel import LIBRARIES as SSD
from repro_torch.kernels.paged_attention.kernel import LIBRARIES as PAGED
from repro_torch.kernels.urd_scan.kernel import LIBRARIES as URD

LIBRARIES = CACHE_SIM + URD + FLASH + SSD + PAGED
ROOT = pathlib.Path(kernels.__file__).resolve().parent
SHARED = "tiled_count.cuh"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _includes(path):
    """Every file a source includes by a quoted path, transitively."""
    out, todo = set(), [pathlib.Path(path).resolve()]
    while todo:
        src = todo.pop()
        for rel in _INCLUDE.findall(src.read_text()):
            inc = (src.parent / rel).resolve()
            if inc not in out:
                out.add(inc)
                todo.append(inc)
    return out


def _copy_tree(tmp_path):
    """The kernels' device sources copied under tmp_path at the same
    relative paths, so that relative includes resolve in the copy."""
    for src in ROOT.glob("*/csrc/*"):
        dst = tmp_path / src.relative_to(ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    return {name: [tmp_path / pathlib.Path(s).resolve().relative_to(ROOT)
                   for s in srcs] for name, srcs in LIBRARIES}


@pytest.mark.parametrize("name", [lib[0] for lib in LIBRARIES])
def test_every_included_header_is_hashed(name, tmp_path):
    """One byte more in any file the library compiles (its sources and
    every header they include) renames it; one more in a file it does
    not include leaves its name."""
    copies = _copy_tree(tmp_path)
    sources = copies[name]
    assert all(s.suffix == ".cu" for s in sources)
    compiled = set(sources).union(*(_includes(s) for s in sources))
    for path in sorted(compiled):
        before = library_path(name, sources)
        path.write_text(path.read_text() + "\n")
        assert library_path(name, sources) != before, path
    others = sorted(set(tmp_path.glob("*/csrc/*")) - compiled)
    assert others
    before = library_path(name, sources)
    for path in others:
        path.write_text(path.read_text() + "\n")
    assert library_path(name, sources) == before


def test_editing_the_shared_header_renames_its_libraries(tmp_path):
    """Copies of the sources: one byte more in the shared header names a
    new library for each of its four users (the segments count takes it
    for blocks wider than shared memory) and for no other."""
    copies = _copy_tree(tmp_path)
    before = {name: library_path(name, srcs) for name, srcs in copies.items()}
    header = tmp_path / "cache_sim" / "csrc" / SHARED
    header.write_text(header.read_text() + "\n")
    after = {name: library_path(name, srcs) for name, srcs in copies.items()}
    changed = sorted(name for name in copies if after[name] != before[name])
    assert changed == ["cache_sim", "cache_sim_levels", "cache_sim_segments",
                       "urd_scan"]
    assert all(p.name.startswith(f"lib{name}-") and p.suffix == ".so"
               for name, p in after.items())
