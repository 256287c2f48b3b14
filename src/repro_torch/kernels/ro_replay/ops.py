"""Dispatch: a tape's pressured RO blocks -> their eviction-token replays.

The batch replay engine (``repro_torch.core.batch_sim.simulate_many``)
calls these on a CUDA tape with every pressured RO tenant of the window
at once: ``ro_token_replays`` for the single-level ones,
``ro_token_replays_levels`` for the two-level ones, one kernel launch
each (``kernel.ro_token_replay_scan``, ``kernel.ro_token_replay_levels_scan``);
on a CPU tape they return the plain versions (``ref``).  Each block's
outputs come back as a slice per block, in local positions, with its
flush (and demotion) count read once for all blocks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ro_replay.kernel import (ro_token_replay_levels_scan,
                                                  ro_token_replay_scan)

__all__ = ["ro_token_replays", "ro_token_replays_levels"]


def _split(x: torch.Tensor, starts, ends) -> list[torch.Tensor]:
    lens = [int(e) - int(s) for s, e in zip(starts, ends)]
    return list(torch.split(x, lens)) if lens else []


def ro_token_replays(is_read: torch.Tensor, prev: torch.Tensor,
                     nxt: torch.Tensor, force: torch.Tensor, starts, ends,
                     caps) -> list[tuple[torch.Tensor, torch.Tensor, int]]:
    """Per block ``(death, dirty, flushes)`` as ``ro_token_replay_ref``
    gives them (``death`` int64, local positions), the blocks replayed in
    one call.  ``prev``/``nxt`` are the tape's global int64 links."""
    death, dirty, fl = ro_token_replay_scan(
        is_read.contiguous(), prev.to(torch.int32).contiguous(),
        nxt.to(torch.int32).contiguous(), force.contiguous(), starts, ends,
        caps)
    death = death.to(torch.int64)
    return list(zip(_split(death, starts, ends), _split(dirty, starts, ends),
                    fl.tolist()))


def ro_token_replays_levels(is_read: torch.Tensor, prev: torch.Tensor,
                            nxt: torch.Tensor, force: torch.Tensor, starts,
                            ends, cap1, cap2, l2_end, clean2
                            ) -> list[tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, int, int]]:
    """Per block ``(death, dirty, lvl, flushes, demotions)`` as
    ``ro_token_replay_levels_ref`` gives them, the blocks replayed in one
    call (``l2_end`` local to each block)."""
    death, dirty, lvl, counts = ro_token_replay_levels_scan(
        is_read.contiguous(), prev.to(torch.int32).contiguous(),
        nxt.to(torch.int32).contiguous(), force.contiguous(), starts, ends,
        cap1, cap2, l2_end, clean2)
    k = len(starts)
    c = counts.tolist()
    death = death.to(torch.int64)
    return list(zip(_split(death, starts, ends), _split(dirty, starts, ends),
                    _split(lvl, starts, ends), c[:k], c[k:]))
