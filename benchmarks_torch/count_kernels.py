#!/usr/bin/env python3
"""Time the interval-count kernels at the shapes their paths give them.

    PYTHONPATH=src python benchmarks_torch/count_kernels.py [--src DIR]
        [--reps 20] [--tapes FILE]

On the CUDA card, with CUDA events: "a call" is ``--reps`` calls back to
back, the host's launch time included; "alone" is the same calls
captured in one CUDA graph and replayed, the kernels alone.  Every
result is held to a plain version first (the merge tree, or the O(n)
delta form of the live count).

* ``urd_scan`` at the control plane's seed row (``chip_smoke.py``'s
  ``CP_TENANTS``, ``CP_ACCESSES`` and ``CP_SEED``: tenant 0's window a
  call and alone, and every window one call each in turn, as the seed
  row launches them); at the Table-3 window ``msr_trace(TABLE3[0],
  ACCESSES, seed=3)``; and at the 16-tenant window-0 tape (``MSR_16`` x
  ``ACCESSES``, links severed per tenant).
* ``cache_sim_scan`` at that tape, every access occupying.
* ``cache_sim_levels_scan`` at that tape, every access occupying, with
  each tenant's even share of the ETICA deployment's capacities
  (``ETICA_CAP1`` and ``ETICA_CAP1 + ETICA_CAP2`` over 16); a call only.
* ``live_count_scan`` at two RO guard tapes: the pressure path's first
  (``make_manager("etica", PRESSURE_CAP1, MSR_16, capacity2=
  PRESSURE_CAP2, t_fast2=T_FAST2, w_threshold=0)``, window 1, about 1.05
  M rows) and the 256-tenant path's first (``make_manager("eci",
  SHARDS_CAPACITY, SHARDS_NAMES)``, window 1, about 16.8 M rows), the
  ``L`` count of ``ro_live_counts`` as the manager calls it.
* ``cache_sim_segments_scan`` at the 256-tenant path's window-0 sampled
  tape (``chip_smoke.sampled_tape``): each width group, and the three
  launches of a call in turn.

The guard tapes come from running those managers on the card for two
windows; ``--tapes FILE`` keeps them (with the sampled tape) in FILE, made
by the first run that names it and read by later ones, so that runs on
two trees time the same inputs without driving the managers again.  The
shapes, constants and timers are ``chip_smoke.py``'s, which times the
same kernels in its phase 14 for this checkout only.  ``--src`` names the
``src`` directory whose ``repro_torch`` is imported (default: this
checkout's), so that two trees, such as a commit and its parent, can be
timed in turn in one run on one card.  Prints the card's name and power
limit, a line per measurement and, last, one JSON object of the times in
ms.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (ACCESSES, CP_ACCESSES, CP_SEED,  # noqa: E402
                        CP_TENANTS, ETICA_CAP1, ETICA_CAP2, MSR_16,
                        PRESSURE_CAP1, PRESSURE_CAP2, SHARDS_CAPACITY,
                        SHARDS_NAMES, TABLE3, T_FAST2, Recorder, card_line,
                        cuda_ms, graph_ms, make_windows, run_windows,
                        sampled_tape)


def guard_tape(dev, windows, names, capacity, **kw):
    """(nxt, occ) int32 of the first ``ro_live_counts`` call of a manager
    driven over ``windows`` on the card: its first RO guard tape."""
    import repro_torch.core.batch_sim as bs
    with Recorder(bs, "ro_live_counts") as rec:
        run_windows(dev, windows, names, capacity, **kw)
    nxt, occ = rec.args
    return (nxt.to(torch.int32).contiguous(),
            occ.to(torch.int32).contiguous())


def make_tapes(dev) -> dict:
    """The guard tapes and the window-0 sampled tape, on the card."""
    tapes = {"pressure": guard_tape(
        dev, make_windows(MSR_16, 2), MSR_16, PRESSURE_CAP1,
        scheme="etica", capacity2=PRESSURE_CAP2, t_fast2=T_FAST2,
        w_threshold=0.0)}
    swindows = make_windows([nm.split("#")[0] for nm in SHARDS_NAMES], 2)
    _, _, args = sampled_tape(swindows[0], dev)
    tapes["segments"] = [(tuple(a), w) for a, w in args]
    tapes["256-tenant"] = guard_tape(dev, swindows, SHARDS_NAMES,
                                     SHARDS_CAPACITY)
    return tapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tapes", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("count_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core.batch_sim import segment_links
    from repro_torch.core.trace import prev_next_occurrence
    from repro_torch.data.traces import msr_trace, synthetic_mix
    from repro_torch.kernels.cache_sim.kernel import (cache_sim_levels_scan,
                                                      cache_sim_scan,
                                                      cache_sim_segments_scan,
                                                      live_count_scan)
    from repro_torch.kernels.cache_sim.ref import (cache_sim_segments_tree,
                                                   live_counts_delta,
                                                   stack_distances_tree)
    from repro_torch.kernels.urd_scan.kernel import urd_scan

    card = card_line()
    print(f"card: {card}; repro_torch from {args.src}")
    dev = torch.device("cuda")
    reps = args.reps
    times = {}

    def links32(prev, nxt):
        return prev.to(torch.int32), nxt.to(torch.int32)

    def held(what, got, prev, nxt):
        torch.cuda.synchronize()
        assert torch.equal(got.long(), stack_distances_tree(prev, nxt)), what

    # the seed row: a window a tenant
    mix = synthetic_mix(CP_TENANTS, CP_ACCESSES, seed=CP_SEED)
    seed_links = []
    for t in mix:
        prev, nxt = prev_next_occurrence(t.addrs.to(dev))
        seed_links.append((prev, nxt, *links32(prev, nxt)))
    prev, nxt, p32, n32 = seed_links[0]
    held("urd_scan seed row", urd_scan(p32, n32), prev, nxt)
    times["urd_seed_call"] = cuda_ms(lambda: urd_scan(p32, n32), reps)
    times["urd_seed_alone"] = graph_ms(lambda: urd_scan(p32, n32), reps)
    every = [(p, n) for _, _, p, n in seed_links]
    times["urd_seed_row_1024"] = cuda_ms(
        lambda: [urd_scan(p, n) for p, n in every], 1)
    print(f"urd_scan, seed row (tenant 0 of synthetic_mix({CP_TENANTS}, "
          f"{CP_ACCESSES}, seed={CP_SEED}), {int((prev >= 0).sum())} hot "
          f"rows): {times['urd_seed_call']:.4f} ms a call, "
          f"{times['urd_seed_alone']:.4f} alone; the {CP_TENANTS} windows "
          f"in turn {times['urd_seed_row_1024']:.3f} ms")

    # the Table-3 window
    prev, nxt = prev_next_occurrence(
        msr_trace(TABLE3[0], ACCESSES, seed=3).addrs.to(dev))
    p32, n32 = links32(prev, nxt)
    held("urd_scan Table-3 window", urd_scan(p32, n32), prev, nxt)
    times["urd_table3_call"] = cuda_ms(lambda: urd_scan(p32, n32), reps)
    times["urd_table3_alone"] = graph_ms(lambda: urd_scan(p32, n32), reps)
    print(f"urd_scan, Table-3 window ({TABLE3[0]}, {ACCESSES} accesses): "
          f"{times['urd_table3_call']:.4f} ms a call, "
          f"{times['urd_table3_alone']:.4f} alone")

    # the 16-tenant window-0 tape
    traces = [msr_trace(p, ACCESSES, seed=i) for i, p in enumerate(MSR_16)]
    addrs = torch.cat([t.addrs for t in traces]).to(dev)
    lens = torch.tensor([len(t) for t in traces], device=dev)
    tid = torch.repeat_interleave(torch.arange(len(traces), device=dev),
                                  lens)
    prev, nxt, _, _ = segment_links(addrs, tid, torch.cumsum(lens, 0)[tid])
    p32, n32 = links32(prev, nxt)
    ones = torch.ones_like(p32)
    m = int(p32.shape[0])
    held("urd_scan 16-tenant tape", urd_scan(p32, n32), prev, nxt)
    held("cache_sim_scan 16-tenant tape", cache_sim_scan(p32, n32, ones),
         prev, nxt)
    times["urd_tape_call"] = cuda_ms(lambda: urd_scan(p32, n32), reps)
    times["urd_tape_alone"] = graph_ms(lambda: urd_scan(p32, n32), reps)
    times["cache_sim_tape_call"] = cuda_ms(
        lambda: cache_sim_scan(p32, n32, ones), reps)
    times["cache_sim_tape_alone"] = graph_ms(
        lambda: cache_sim_scan(p32, n32, ones), reps)
    cap1 = torch.full_like(p32, ETICA_CAP1 // len(traces))
    captot = torch.full_like(p32, (ETICA_CAP1 + ETICA_CAP2) // len(traces))
    sd = stack_distances_tree(prev, nxt)
    l1, un = cache_sim_levels_scan(p32, n32, ones, cap1, captot)
    torch.cuda.synchronize()
    assert torch.equal(l1.bool(), (sd >= 0) & (sd < cap1)), "levels l1"
    assert torch.equal(un.bool(), (sd >= 0) & (sd < captot)), "levels union"
    times["levels_tape_call"] = cuda_ms(
        lambda: cache_sim_levels_scan(p32, n32, ones, cap1, captot), reps)
    print(f"16-tenant window-0 tape ({m} accesses): urd_scan "
          f"{times['urd_tape_call']:.4f} ms a call, "
          f"{times['urd_tape_alone']:.4f} alone; cache_sim_scan "
          f"{times['cache_sim_tape_call']:.4f} a call, "
          f"{times['cache_sim_tape_alone']:.4f} alone; "
          f"cache_sim_levels_scan (caps {ETICA_CAP1 // len(traces)} / "
          f"{(ETICA_CAP1 + ETICA_CAP2) // len(traces)}) "
          f"{times['levels_tape_call']:.4f} a call")
    del seed_links, every, prev, nxt, p32, n32, ones, sd, l1, un

    # the guard tapes and the window-0 sampled tape
    path = pathlib.Path(args.tapes) if args.tapes else None
    if path is not None and path.exists():
        tapes = torch.load(path, map_location=dev)
        print(f"tapes read from {path}")
    else:
        tapes = make_tapes(dev)
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(tapes, path)
            print(f"tapes written to {path}")
    for name in ("pressure", "256-tenant"):
        nl, ol = tapes[name]
        torch.cuda.synchronize()
        assert torch.equal(live_count_scan(nl, ol),
                           live_counts_delta(nl, ol)), name
        key = f"live_{name.split('-')[0]}"
        times[f"{key}_call"] = cuda_ms(lambda: live_count_scan(nl, ol), reps)
        times[f"{key}_alone"] = graph_ms(lambda: live_count_scan(nl, ol),
                                         reps)
        print(f"live_count_scan, {name} guard tape ({nl.shape[0]} rows): "
              f"{times[f'{key}_call']:.4f} ms a call, "
              f"{times[f'{key}_alone']:.4f} alone")
    seg = tapes["segments"]
    for a, w in seg:
        assert torch.equal(cache_sim_segments_scan(*a, w),
                           cache_sim_segments_tree(*a, w)), w
        times[f"segments_w{w}_call"] = cuda_ms(
            lambda: cache_sim_segments_scan(*a, w), reps)
        times[f"segments_w{w}_alone"] = graph_ms(
            lambda: cache_sim_segments_scan(*a, w), reps)
        print(f"cache_sim_segments_scan, width {w} ({a[0].shape[0]} "
              f"entries): {times[f'segments_w{w}_call']:.4f} ms a call, "
              f"{times[f'segments_w{w}_alone']:.4f} alone")
    times["segments_call"] = cuda_ms(
        lambda: [cache_sim_segments_scan(*a, w) for a, w in seg], reps)
    times["segments_alone"] = graph_ms(
        lambda: [cache_sim_segments_scan(*a, w) for a, w in seg], reps)
    print(f"cache_sim_segments_scan, the window-0 sampled tape's "
          f"{len(seg)} launches ({sum(a[0].shape[0] for a, _ in seg)} "
          f"entries): {times['segments_call']:.4f} ms a call, "
          f"{times['segments_alone']:.4f} alone")
    print(json.dumps({"card": card, "src": args.src, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
