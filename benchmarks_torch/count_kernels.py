#!/usr/bin/env python3
"""Time the interval-count kernels and the RO token replays at the shapes
their paths give them.

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
* ``ro_token_replay_scan`` at the 256-tenant path's window-1 call and
  ``ro_token_replay_levels_scan`` at the pressure path's window-2 call
  and the ETICA path's window-1 call (``make_manager("etica",
  ETICA_CAP1, MSR_16, capacity2=ETICA_CAP2, t_fast2=T_FAST2)``), the
  arguments each path's ``simulate_many`` gave the kernel; "alone" is
  a CUDA graph of the launch that ``kernel.prepare_launch`` stages (the
  one the wrapper makes), without the wrapper's host work.  Each is held
  to its plain version (the host loops) first, and printed beside its
  bound (``chip_smoke.ro_bound_ms``) and, from the call's own outputs,
  the share of the longest block's steps that evict or demote.  On a
  tree whose ``ro_replay.cu`` reads ``RO_REPLAY_STEPWISE``, the
  single-level call is also timed alone with the source built that way
  (the walk step by step, without its group-at-once path).

The guard tapes and the RO calls come from running those managers on the
card for two windows (the pressure path three); ``--tapes FILE`` keeps
them (with the sampled tape) in FILE, made
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
import functools
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (ACCESSES, CP_ACCESSES, CP_SEED,  # noqa: E402
                        CP_TENANTS, ETICA_CAP1, ETICA_CAP2, MSR_16,
                        PRESSURE_CAP1, PRESSURE_CAP2, SHARDS_CAPACITY,
                        SHARDS_NAMES, TABLE3, T_FAST2, Recorder, RoCalls,
                        card_line, cuda_ms, graph_ms, make_windows,
                        ro_bound_ms, ro_kernel_args, ro_work, run_windows,
                        sampled_tape)

RO_LEVELS = "ro_token_replay_levels_scan"


def recorded(dev, windows, names, capacity, **kw):
    """Drive a manager over ``windows`` on the card.  Returns (nxt, occ)
    int32 of its first ``ro_live_counts`` call (its first RO guard tape)
    and every RO replay call's kernel arguments, by kernel, in order."""
    import repro_torch.core.batch_sim as bs
    with Recorder(bs, "ro_live_counts") as rec, RoCalls(bs) as ro:
        run_windows(dev, windows, names, capacity, **kw)
    nxt, occ = rec.args
    calls = {k: [ro_kernel_args(a) for a in v.values()]
             for k, v in ro.calls.items()}
    return ((nxt.to(torch.int32).contiguous(),
             occ.to(torch.int32).contiguous()), calls)


def make_tapes(dev) -> dict:
    """The guard tapes, the window-0 sampled tape and the RO calls, on
    the card."""
    tapes = {}
    tapes["pressure"], ro_pr = recorded(
        dev, make_windows(MSR_16, 3), MSR_16, PRESSURE_CAP1,
        scheme="etica", capacity2=PRESSURE_CAP2, t_fast2=T_FAST2,
        w_threshold=0.0)
    _, ro_et = recorded(dev, make_windows(MSR_16, 2), MSR_16, ETICA_CAP1,
                        scheme="etica", capacity2=ETICA_CAP2,
                        t_fast2=T_FAST2)
    swindows = make_windows([nm.split("#")[0] for nm in SHARDS_NAMES], 2)
    _, _, args = sampled_tape(swindows[0], dev)
    tapes["segments"] = [(tuple(a), w) for a, w in args]
    tapes["256-tenant"], ro_256 = recorded(dev, swindows, SHARDS_NAMES,
                                           SHARDS_CAPACITY)
    tapes["ro"] = {
        "256-tenant window 1": ("ro_token_replay_scan",
                                ro_256["ro_token_replay_scan"][0]),
        "pressure window 2": (RO_LEVELS, ro_pr[RO_LEVELS][1]),
        "ETICA window 1": (RO_LEVELS, ro_et[RO_LEVELS][0])}
    return tapes


def ro_prepare(ro):
    """``ro.prepare_launch``; a tree from before it (the same C interface)
    gets this checkout's, launching that tree's own library."""
    if hasattr(ro, "prepare_launch"):
        return ro.prepare_launch
    spec = importlib.util.spec_from_file_location(
        "_ro_kernel_here", ROOT / "src/repro_torch/kernels/ro_replay/kernel.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return functools.partial(here.prepare_launch, lib=ro._lib())


def ro_stepwise_library(ro):
    """The tree's ``ro_replay.cu`` built with ``RO_REPLAY_STEPWISE``
    defined (a one-line source under the build directory that includes
    it), or None when the source does not read that name."""
    from repro_torch.kernels import BUILD_DIR
    src = pathlib.Path(ro.SOURCES[0])
    if "RO_REPLAY_STEPWISE" not in src.read_text():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    wrap = BUILD_DIR / "ro_replay_stepwise.cu"
    wrap.write_text(f'#define RO_REPLAY_STEPWISE 1\n#include "{src}"\n')
    return ro.library("ro_replay_stepwise", [wrap])


def ro_acts(a, got, levels: bool) -> str:
    """The longest block's stepped rows (at or past ``l2_end``) and how
    many of them evict (a token dies before its natural end) or, with two
    levels, demote, from the call's outputs."""
    starts, ends = a[4], a[5]
    k = max(range(len(starts)), key=lambda i: ends[i] - starts[i])
    s, e = starts[k], ends[k]
    out = sum(ends[i] - starts[i] for i in range(k))
    n = e - s
    death = got[0][out:out + n].long()
    natural = a[2][s:e].long() - s
    evicted = int((death < natural).sum())
    stepped = n - (min(a[8][k], n) if levels else 0)
    text = (f"longest block: {stepped} rows stepped, {evicted} evict "
            f"({100 * evicted / max(stepped, 1):.1f} %)")
    if levels:
        dem = int(got[3][len(starts) + k])
        text += f", {dem} demote ({100 * dem / max(stepped, 1):.1f} %)"
    return text


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
    from repro_torch.kernels.ro_replay import kernel as ro
    from repro_torch.kernels.ro_replay import ref as ro_ref
    prepare = ro_prepare(ro)
    stepwise = ro_stepwise_library(ro)
    for label, (name, a) in tapes["ro"].items():
        levels = name == RO_LEVELS
        kern = getattr(ro, name)
        plain = (ro_ref.ro_token_replay_levels_blocks_ref if levels
                 else ro_ref.ro_token_replay_blocks_ref)
        got = kern(*a)
        want = plain(*(x.cpu() for x in a[:4]), *a[4:])
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
            label
        key = f"{name}_{label.split()[0]}"
        times[f"{key}_call"] = cuda_ms(lambda: kern(*a), reps)
        times[f"{key}_alone"] = graph_ms(prepare(name, *a)[0], reps)
        rows, longest = ro_work(a, levels)
        bnd, by, l1 = ro_bound_ms(a, levels)
        print(f"{name}, {label} ({len(a[4])} blocks, {rows} rows, longest "
              f"{longest}): {times[f'{key}_call']:.4f} ms a call, "
              f"{times[f'{key}_alone']:.4f} alone; bound {bnd:.4f} ms by "
              f"{by} (an L1 hit a row: {l1:.4f}); equal to the plain "
              f"version; {ro_acts(a, got, levels)}")
        if stepwise is not None and not levels:
            launch, outs = prepare(name, *a, lib=stepwise)
            launch()
            torch.cuda.synchronize()
            assert all(torch.equal(g.cpu(), w) for g, w in zip(outs, want)), \
                f"{label} step by step"
            times[f"{key}_stepwise_alone"] = graph_ms(launch, reps)
            print(f"  built step by step (RO_REPLAY_STEPWISE): "
                  f"{times[f'{key}_stepwise_alone']:.4f} ms alone; equal "
                  f"to the plain version")
    print(json.dumps({"card": card, "src": args.src, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
