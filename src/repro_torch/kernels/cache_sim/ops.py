"""Dispatch: occurrence links -> LRU stack distances, on the links' device.

``stack_distances`` is the counting step of the batch replay engine
(``repro_torch.core.batch_sim``) and of the monitor's recount.  A CUDA
tensor goes through the hand-written kernel (``kernel.cache_sim_scan``)
with every access occupying; a CPU tensor through the plain merge-tree
route, which gives the same integers, and -1 at cold rows.

``stack_distances_segments`` is the counting step of the SHARDS-sampled
monitor (``repro_torch.core.monitor``), the counterpart of the
reference's ``stack_distances_segments_accel``: the tape is re-laid out
power-of-two padded and self-aligned, and each distinct padded width is
one call of ``kernel.cache_sim_segments_scan`` on a CUDA tensor, or of
the merge-sort tree ``ref.cache_sim_segments_tree`` on a CPU tensor.

``segment_counts_device`` is the same count on a tape that is already
padded (the device window pipeline's count stage): one
``cache_sim_segments_scan`` call per width group, the kernel on a CUDA
tensor and the dense plain ``ref.cache_sim_segments_ref`` on a CPU one,
with nothing read back to the host.

``residency_levels`` is the two-level replay's both-level residency
(the reference's ``residency_levels_accel``): one
``kernel.cache_sim_levels_scan`` launch on a CUDA tensor, the merge-tree
distances (or, with an explicit occupancy, the dense
``ref.cache_sim_levels_ref``) compared with the two thresholds on a CPU
tensor.  ``ro_live_counts`` is the RO no-eviction guard's live count
(the reference's ``ro_live_counts_accel``): ``kernel.live_count_scan``
on a CUDA tensor, the O(n) ``ref.live_counts_delta`` on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cache_sim.kernel import (cache_sim_levels_scan,
                                                  cache_sim_scan,
                                                  cache_sim_segments_scan,
                                                  live_count_scan)
from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                               cache_sim_segments_tree,
                                               live_counts_delta,
                                               stack_distances_tree)

__all__ = ["residency_levels", "ro_live_counts", "segment_counts_device",
           "stack_distances", "stack_distances_segments", "width_groups_of"]


def stack_distances(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """int64 stack distances per access, -1 where cold (``prev < 0``).

    Links may be severed at tenant-block boundaries with ``nxt`` clamped
    to the block end: a hot access's interval never leaves its block, so
    one call counts a whole multi-tenant tape.
    """
    if prev.device.type == "cuda":
        p32 = prev.to(torch.int32).contiguous()
        counts = cache_sim_scan(p32, nxt.to(torch.int32).contiguous(),
                                torch.ones_like(p32))
        return counts.to(torch.int64)
    return stack_distances_tree(prev, nxt)


def residency_levels(prev: torch.Tensor, nxt: torch.Tensor,
                     cap1: torch.Tensor, captot: torch.Tensor,
                     occ: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both-level residency as bool masks ``(l1, union)`` per access.

    ``l1 = hot & (SD < cap1)``, ``union = hot & (SD < captot)`` with the
    per-access thresholds of the access's tenant (``occ`` defaults to
    every access occupying).  Links may be severed at tenant blocks as
    for ``stack_distances``, so one call covers a whole tape.
    """
    if prev.device.type == "cuda":
        p32 = prev.to(torch.int32).contiguous()
        o32 = (torch.ones_like(p32) if occ is None
               else occ.to(torch.int32).contiguous())
        l1, un = cache_sim_levels_scan(
            p32, nxt.to(torch.int32).contiguous(), o32,
            cap1.to(torch.int32).contiguous(),
            captot.to(torch.int32).contiguous())
        return l1.bool(), un.bool()
    if occ is not None:
        l1, un = cache_sim_levels_ref(prev, nxt, occ, cap1, captot)
        return l1.bool(), un.bool()
    sd = stack_distances_tree(prev, nxt)
    hot = sd >= 0
    return hot & (sd < cap1), hot & (sd < captot)


def ro_live_counts(nxt: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """int64 live counts ``L[i] = #{ j <= i : occ[j], nxt[j] > i }``.

    With ``occ = is_read`` the RO guard's live blocks after each access;
    with ``occ`` on the warm-L2 pseudo rows the still-untouched warm-L2
    blocks (``U2``).
    """
    if nxt.device.type == "cuda":
        counts = live_count_scan(nxt.to(torch.int32).contiguous(),
                                 occ.to(torch.int32).contiguous())
    else:
        counts = live_counts_delta(nxt, occ)
    return counts.to(torch.int64)


def width_groups_of(widths) -> tuple[tuple[int, int, int], ...]:
    """``(seg_width, lo, hi)`` spans of a padded tape's width runs.

    ``widths`` is ``padded_segment_layout``'s descending power-of-two
    width vector; each distinct width is one contiguous, self-aligned
    chunk ``[lo, hi)`` of the padded tape.
    """
    out: list[tuple[int, int, int]] = []
    lo = 0
    for w in torch.as_tensor(widths).tolist():
        if out and out[-1][0] == w:
            out[-1] = (w, out[-1][1], lo + w)
        else:
            out.append((w, lo, lo + w))
        lo += w
    return tuple(out)


def _group_links(gprev: torch.Tensor, gnxt: torch.Tensor, gocc: torch.Tensor,
                 lo: int, hi: int) -> tuple[torch.Tensor, ...]:
    """Chunk-local int32 links of the width group ``[lo, hi)`` of a padded
    tape."""
    gp = gprev[lo:hi]
    return (torch.where(gp >= 0, gp - lo, -1).to(torch.int32),
            (gnxt[lo:hi] - lo).to(torch.int32),
            gocc[lo:hi].to(torch.int32).contiguous())


def segment_counts_device(gprev: torch.Tensor, gnxt: torch.Tensor,
                          gocc: torch.Tensor, wg) -> torch.Tensor:
    """int64 segment-restricted SD over a padded tape; -1 at cold and pad
    rows.

    ``gprev``/``gnxt``/``gocc`` are ``batch_sim.padded_tape_links``'s
    links on the padded tape, ``wg`` its ``width_groups_of`` spans (host
    integers): one ``cache_sim_segments_scan`` call per width group (on
    a CPU tensor its plain version ``cache_sim_segments_ref``), nothing
    read back to the host.
    """
    parts = []
    for w, lo, hi in wg:
        p, q, o = _group_links(gprev, gnxt, gocc, lo, hi)
        parts.append(cache_sim_segments_scan(p, q, o, w))
    return torch.cat(parts).to(torch.int64)


def stack_distances_segments(prev: torch.Tensor, nxt: torch.Tensor,
                             bounds) -> torch.Tensor:
    """int64 SD per access of a multi-tenant tape; -1 where cold.

    ``prev``/``nxt`` are links severed at the segment boundaries
    ``bounds`` (per-tenant offsets) with ``nxt`` clamped to the segment
    end.  The links are scattered onto the tape's
    ``padded_segment_layout`` (pads cold and non-occupying), and each
    distinct padded width is counted in one call with chunk-local links:
    the CUDA kernel for a CUDA tensor, the merge-sort tree for a CPU
    tensor.
    """
    from repro_torch.core.batch_sim import (padded_segment_layout,
                                            padded_tape_links)
    dev = prev.device
    n = prev.shape[0]
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lay = padded_segment_layout(bounds, device=dev)
    src, tpos, _, _, widths, total, _ = lay
    if tpos.numel() == 0:
        return out
    if src is None:                              # layout kept tape order
        src = torch.arange(n, dtype=torch.int64, device=dev)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt, lay)
    counts = torch.empty(total, dtype=torch.int64, device=dev)
    for w, lo, hi in width_groups_of(widths):
        args = _group_links(gprev, gnxt, gocc, lo, hi)
        counts[lo:hi] = (cache_sim_segments_scan(*args, w)
                         if dev.type == "cuda"
                         else cache_sim_segments_tree(*args, w))
    hot = prev[src] >= 0
    out[src[hot]] = counts[tpos[hot]]
    return out
