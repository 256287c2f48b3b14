#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``, one
     ``nvcc`` per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card,
     exactly: ``cache_sim_scan`` vs the dense ``cache_sim_ref`` at tape
     lengths 1 .. 32768 (multi-tenant severed links, cold rows,
     ``occ = 1`` and ``occ = is_read``), and ``cache_sim_segments_scan``
     vs the dense ``cache_sim_segments_ref`` on padded multi-tenant
     tapes of widths 64 .. 8192 and 16384 (wider than one shared-memory
     stage), with ragged segments and an empty tenant;
  4. drive slice 1's path — ``make_manager("eci", 6000, ...)`` over 16
     tenants, three Δt windows of 65,536 accesses each — on the card with
     every kernel launch counter set to 0 just before and read just
     after; then run the same windows through the port on the CPU and
     require equal sizes, policies, feasibility, per-tenant counts,
     final LRU states, and latencies to rel 1e-12;
  5. drive the SHARDS path — ``make_manager("eci", 96000, ...)`` over 256
     tenants (the 16 MSR profiles x 16), two windows of 65,536 accesses
     per tenant, which the manager monitors sampled by itself (rate
     1/16) — the same way, counters zeroed just before and read just
     after, every window launching ``cache_sim_segments_scan``; then the
     same windows on the CPU (window 1 only while the run is inside its
     time budget; a cut is printed), compared as in phase 4, sample
     rates included;
  6. hold each kernel against its merge-tree route at the full tape of
     its path's window 0 (``cache_sim_scan``: the 16-tenant replay tape;
     ``cache_sim_segments_scan``: the 256-tenant sampled tape, one launch
     per padded width) and time both (CUDA events), beside the bound of
     the function it computes (the larger of its bytes at the memory
     rate and a tree count's operations at the 32-bit rate);
  7. print the kernels line, the card line and, last, the result line.

Exits non-zero, printing no result, when no card is visible or any
phase fails.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import pathlib
import platform
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
# non-tensor-core rate used for integer operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
WINDOWS, ACCESSES, REPS = 3, 65536, 20      # per tenant per window
MSR_16 = ["wdev_0", "web_1", "stg_1", "ts_0", "hm_1", "mds_0", "proj_0",
          "prxy_0", "rsrch_0", "src1_2", "prn_1", "src2_0", "web_0",
          "usr_0", "rsrch_2", "mds_1"]
# the SHARDS path: 256 tenants, the manager's own sampling threshold
SHARDS_NAMES = [f"{p}#{k}" for k in range(16) for p in MSR_16]
SHARDS_WINDOWS, SHARDS_CAPACITY = 2, 96000
# the CPU comparison of the SHARDS path runs window 1 only while the
# whole run stays inside this many seconds (10 of its 20 minutes)
CPU_BUDGET_S = 600.0
SEGMENT_LENS = {64: [64, 1, 33, 0, 64], 512: [512, 300, 257, 0],
                4096: [4096, 2049, 3000], 8192: [8192, 5000, 4097],
                16384: [16384, 9000]}   # 16384: wider than one stage
T_START = time.perf_counter()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def host_line() -> str:
    """The host's CPU model and the cores this process may use (the CPU
    run of the windows shares them)."""
    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    except OSError:
        pass
    return (f"host: {model or 'unknown CPU'}; os.cpu_count()="
            f"{os.cpu_count()}, usable cores="
            f"{len(os.sched_getaffinity(0))}, torch threads="
            f"{torch.get_num_threads()}")


def tape_links(n: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """A multi-tenant tape of n accesses: random tenant blocks over small
    address ranges, links severed per block (cold rows at each block's
    first touches), and a random read mask."""
    from repro_torch.core.batch_sim import segment_links
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(3, n - 1),
                              replace=False)) if n > 1 else np.zeros(0)
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    lens = np.diff(bounds)
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    tid = np.repeat(np.arange(lens.size), lens)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    prev, nxt_c, _, _ = segment_links(t(addrs), t(tid), t(bounds[1:])[t(tid)])
    reads = torch.as_tensor(rng.random(n) < 0.6, device=device)
    return prev, nxt_c, reads


def padded_group_links(gprev, gnxt, gocc, w, lo, hi):
    """Chunk-local int32 links of one width group of a padded tape."""
    gp = gprev[lo:hi]
    return (torch.where(gp >= 0, gp - lo, -1).to(torch.int32),
            (gnxt[lo:hi] - lo).to(torch.int32), gocc[lo:hi].contiguous())


def padded_tape(lens, seed: int, device):
    """A padded, self-aligned multi-tenant tape of random tenant windows:
    global links, occupancy, a read mask and the width groups."""
    from repro_torch.core.batch_sim import (padded_segment_layout,
                                            padded_tape_links,
                                            segment_links)
    from repro_torch.kernels.cache_sim.ops import width_groups_of
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    bounds = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]))
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    tid = torch.as_tensor(np.repeat(np.arange(lens.size), lens),
                          device=device)
    prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=device),
                                    tid, bounds.to(device)[1:][tid])
    lay = padded_segment_layout(bounds, device=device)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt, lay)
    reads = torch.zeros_like(gocc)
    reads[lay[1]] = torch.as_tensor(rng.random(int(lens.sum())) < 0.6,
                                    device=device).to(torch.int32)
    return gprev, gnxt, gocc, reads, width_groups_of(lay[4])


def _gen_trace(args):
    from repro_torch.data.traces import msr_trace
    name, n, seed = args
    t = msr_trace(name, n, seed=seed)
    return t.addrs.numpy(), t.is_read.numpy()


def make_windows(profiles: list[str], windows: int) -> list[list]:
    """Tenant i of window w runs ``msr_trace(profiles[i], ACCESSES,
    seed=1000*w+i)``; generated in worker processes, outside any timed
    region (the pool ends before this returns)."""
    from repro_torch.core.trace import Trace
    jobs = [(p, ACCESSES, 1000 * w + i) for w in range(windows)
            for i, p in enumerate(profiles)]
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    ctx = multiprocessing.get_context("spawn")   # the parent holds CUDA
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        arrays = list(ex.map(_gen_trace, jobs, chunksize=8))
    traces = [Trace(torch.from_numpy(a), torch.from_numpy(r), p)
              for (p, _, _), (a, r) in zip(jobs, arrays)]
    k = len(profiles)
    return [traces[w * k:(w + 1) * k] for w in range(windows)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run_windows(device, windows, names, capacity, profile=None,
                deadline=None):
    """Run the windows through the ECI manager; returns the manager, the
    per-window wall times, each window's curves, each window's
    cumulative per-tenant counts and each window's launches of the
    segments kernel.  With ``deadline`` (a ``time.perf_counter`` value),
    a window starts only if the last one would still end before it."""
    from repro_torch.core import make_manager
    from repro_torch.kernels.cache_sim.kernel import cache_sim_segments_scan
    mgr = make_manager("eci", capacity, names, c_min=50, initial_blocks=100,
                       engine="batch", t_fast=1.0, t_slow=20.0,
                       flush_cost=10.0, device=device, profile=profile)
    walls, curves, counts, seg = [], [], [], []
    for traces in windows:
        if deadline is not None and walls \
                and time.perf_counter() + walls[-1] > deadline:
            break
        before = cache_sim_segments_scan.launches
        t0 = time.perf_counter()
        mgr.run_window(traces)
        if mgr.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        seg.append(cache_sim_segments_scan.launches - before)
        curves.append([t.h_fn for t in mgr.tenants])
        counts.append([dataclasses.asdict(t.result) for t in mgr.tenants])
    return mgr, walls, curves, counts, seg


def near_breakpoint(part, curves, tol: float = 1e-3) -> bool:
    """True when some tenant's relaxed optimum lies within ``tol`` blocks
    of one of its breakpoints (a float32 tie of the snap)."""
    if part.relaxed is None:
        return False
    for c, h in zip(part.relaxed.tolist(), curves):
        e = h.edges.to(torch.float64).cpu()
        if float(torch.min(torch.abs(e - c))) < tol:
            return True
    return False


def compare_counts(w: int, got, want) -> None:
    """Per-tenant counts after window ``w`` (latency to rel 1e-12)."""
    for i, (rg, rc) in enumerate(zip(got, want)):
        lat_g, lat_c = rg.pop("total_latency"), rc.pop("total_latency")
        assert rg == rc, f"window {w}, tenant {i}: {rg} vs {rc}"
        assert abs(lat_g - lat_c) <= 1e-12 * abs(lat_c), \
            f"window {w}, tenant {i}: latency {lat_g} vs {lat_c}"


def compare_runs(gpu, gpu_curves, gpu_counts, cpu, cpu_curves,
                 cpu_counts) -> None:
    """Decisions and per-tenant results of the card run equal the CPU run
    (latency floats to rel 1e-12), window by window.

    A PGD tie (sizes differ, both runs infeasible, both relaxed optima
    within 1e-3 of a breakpoint) is reported, not hidden. Its window's
    policies, feasibility and replay counts are still compared, since
    they do not depend on the snap; the later windows replay different
    sizes and are not."""
    tie_at = None
    for w, (dg, dc) in enumerate(zip(gpu.history, cpu.history)):
        assert [p.value for p in dg.policies] == \
            [p.value for p in dc.policies], f"window {w}: policies differ"
        assert dg.feasible == dc.feasible, f"window {w}: feasibility"
        assert torch.equal(dg.sample_rates, dc.sample_rates), \
            f"window {w}: sample rates"
        compare_counts(w, gpu_counts[w], cpu_counts[w])
        if dg.sizes.tolist() != dc.sizes.tolist():
            if not (not dg.feasible
                    and near_breakpoint(dg.partition, gpu_curves[w])
                    and near_breakpoint(dc.partition, cpu_curves[w])):
                raise AssertionError(f"window {w}: sizes differ: card "
                                     f"{dg.sizes.tolist()} vs CPU "
                                     f"{dc.sizes.tolist()}")
            print(f"PGD TIE in window {w}: relaxed optimum within 1e-3 "
                  f"of a breakpoint on both devices; card sizes "
                  f"{dg.sizes.tolist()} guard {dg.guard} vs CPU "
                  f"{dc.sizes.tolist()} guard {dc.guard}; policies, "
                  f"feasibility and counts through window {w} equal; "
                  f"later windows are not compared")
            tie_at = w
            break
        assert dg.guard == dc.guard, f"window {w}: guard {dg.guard}"
        if dg.partition.relaxed is not None:
            same = torch.equal(dg.partition.relaxed, dc.partition.relaxed)
            print(f"window {w}: PGD relaxed optimum bit-identical card vs "
                  f"CPU: {same}")
        lat_g, lat_c = dg.partition.latency, dc.partition.latency
        assert abs(lat_g - lat_c) <= 1e-12 * abs(lat_c), \
            f"window {w}: partition latency {lat_g} vs {lat_c}"
    if tie_at is not None or len(cpu.history) < len(gpu.history):
        return              # later windows replayed other sizes, or cut
    for i, (tg, tc) in enumerate(zip(gpu.tenants, cpu.tenants)):
        (ag, fg), (ac, fc) = tg.cache.state_arrays(), tc.cache.state_arrays()
        assert torch.equal(ag.cpu(), ac) and torch.equal(fg.cpu(), fc), \
            f"tenant {i}: final LRU state differs"


def segments_work(groups) -> tuple[int, int]:
    """(padded entries, tree-count operations) of a padded tape: each
    width group of w costs (hi - lo) * ceil(log2 w) operations."""
    m = sum(hi - lo for _, lo, hi in groups)
    ops = sum((hi - lo) * max(1, math.ceil(math.log2(w)))
              for w, lo, hi in groups)
    return m, ops


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    o = ops / PEAK_OPS_PER_S * 1e3
    return max(b, o), ("operations" if o >= b else "bytes")


def drive(path: str, dev, windows, names, capacity, want_segments: bool):
    """One main path on the card, every launch counter 0 just before and
    read just after; then the same windows on the CPU, compared."""
    from repro_torch.core import StageProfile
    from repro_torch.kernels.cache_sim.kernel import (cache_sim_scan,
                                                      cache_sim_segments_scan)
    prof = StageProfile(dev)
    torch.cuda.reset_peak_memory_stats()
    cache_sim_scan.launches = 0
    cache_sim_segments_scan.launches = 0
    gpu, walls, gpu_curves, gpu_counts, seg = run_windows(
        dev, windows, names, capacity, profile=prof)
    launches = {"cache_sim_scan": cache_sim_scan.launches,
                "cache_sim_segments_scan": cache_sim_segments_scan.launches}
    peak = torch.cuda.max_memory_allocated()
    assert launches["cache_sim_scan"] > 0, \
        f"{path}: the main path launched no cache_sim_scan"
    if want_segments:
        assert all(k > 0 for k in seg), \
            f"{path}: a window launched no cache_sim_segments_scan: {seg}"
    for w, (wall, d) in enumerate(zip(walls, gpu.history)):
        rates = sorted(set(d.sample_rates.tolist()))
        print(f"{path} window {w}: {wall:.3f} s on the card, feasible="
              f"{d.feasible}, allocated={int(d.sizes.sum())}, sample rates "
              f"{rates}, segments launches {seg[w]}, policies "
              f"{dict(collections.Counter(p.value for p in d.policies))}")
    print(f"{path} stages (s, summed over windows): " + json.dumps(
        {k: round(v, 4) for k, v in prof.times.items()}))
    print(f"{path} peak device memory: {peak / 2**20:.1f} MiB; launches on "
          f"the path: {json.dumps(launches)}")
    s = gpu.summary()
    print(f"{path} guard violations observed: "
          f"{s['guard_violations_observed']} ("
          f"{'; '.join(v for d in gpu.history for v in d.guard) or 'none'})")
    assert np.isfinite(s["mean_latency"]) and s["accesses"] == \
        len(windows) * len(names) * ACCESSES, "summary"
    assert all(int(d.sizes.sum()) <= capacity for d in gpu.history), \
        "capacity"

    t0 = time.perf_counter()
    deadline = T_START + CPU_BUDGET_S if want_segments else None
    cpu, cpu_walls, cpu_curves, cpu_counts, _ = run_windows(
        "cpu", windows, names, capacity, deadline=deadline)
    print(f"{path} CPU run: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{x:.2f}' for x in cpu_walls)} s per window)")
    if len(cpu_walls) < len(windows):
        print(f"{path} CUT: the CPU comparison covers {len(cpu_walls)} of "
              f"{len(windows)} windows (time budget {CPU_BUDGET_S:.0f} s); "
              f"final LRU states are not compared")
    compare_runs(gpu, gpu_curves, gpu_counts, cpu, cpu_curves, cpu_counts)
    print(f"check: {path} card run == CPU run (sizes, policies, "
          f"feasibility, sample rates, guard reports, per-tenant counts, "
          f"LRU states; latencies to rel 1e-12)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.batch_sim import (padded_segment_layout,
                                            padded_tape_links, segment_links)
    from repro_torch.core.monitor import shards_subtape
    from repro_torch.core.reuse_distance import auto_sample_rate
    from repro_torch.kernels import build_library
    from repro_torch.kernels.cache_sim.kernel import (SEGMENTS_SOURCES,
                                                      SOURCES,
                                                      cache_sim_scan,
                                                      cache_sim_segments_scan)
    from repro_torch.kernels.cache_sim.ops import width_groups_of
    from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
                                                   cache_sim_segments_ref,
                                                   cache_sim_segments_tree,
                                                   stack_distances_tree)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(host_line())

    # ----------------------------------------- 2. build, one nvcc a source
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        builds = {name: ex.submit(build_library, name, srcs)
                  for name, srcs in (("cache_sim", SOURCES),
                                     ("cache_sim_segments",
                                      SEGMENTS_SOURCES))}
        built = {name: f.result() for name, f in builds.items()}
    print(f"build: {', '.join(lib.name for lib, _ in built.values())} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ------------------------------------- 3. kernels vs plain, small tapes
    max_err = {"cache_sim_scan": 0, "cache_sim_segments_scan": 0}
    for n in (1, 255, 256, 257, 4097, 32768):
        prev, nxt, reads = tape_links(n, seed=n, device=dev)
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        for tag, occ in (("occ=1", torch.ones_like(p32)),
                         ("occ=is_read", reads.to(torch.int32))):
            got = cache_sim_scan(p32, n32, occ)
            want = cache_sim_ref(p32, n32, occ)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            assert err == 0, f"cache_sim_scan n={n} {tag}: max err {err}"
            assert bool((got[prev < 0] == -1).all()), "cold rows must be -1"
            max_err["cache_sim_scan"] = max(max_err["cache_sim_scan"], err)
        print(f"check: cache_sim_scan == cache_sim_ref at n={n} "
              f"(occ=1, occ=is_read; {int((prev < 0).sum())} cold rows)")
    for w, lens in SEGMENT_LENS.items():
        gprev, gnxt, gocc, reads, groups = padded_tape(lens, w, dev)
        for gw, lo, hi in groups:
            p32, n32, occ1 = padded_group_links(gprev, gnxt, gocc, gw, lo, hi)
            for tag, occ in (("occ=1", occ1),
                             ("occ=is_read", reads[lo:hi].contiguous())):
                got = cache_sim_segments_scan(p32, n32, occ, gw)
                want = cache_sim_segments_ref(p32, n32, occ, gw)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64))
                          .abs().max())
                assert err == 0, \
                    f"cache_sim_segments_scan w={gw} {tag}: max err {err}"
                assert bool((got[p32 < 0] == -1).all()), \
                    "cold and pad rows must be -1"
                max_err["cache_sim_segments_scan"] = max(
                    max_err["cache_sim_segments_scan"], err)
        print(f"check: cache_sim_segments_scan == cache_sim_segments_ref on "
              f"segments {lens} (widths {[g[0] for g in groups]}; occ=1, "
              f"occ=is_read)")

    # --------------------------------------------- 4. slice 1's main path
    t0 = time.perf_counter()
    windows = make_windows(MSR_16, WINDOWS)
    print(f"traces: {WINDOWS} windows x {len(MSR_16)} tenants x "
          f"{ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    launches16 = drive("16-tenant", dev, windows, MSR_16, 6000,
                       want_segments=False)

    # ------------------------------------------------ 5. the SHARDS path
    t0 = time.perf_counter()
    swindows = make_windows([nm.split("#")[0] for nm in SHARDS_NAMES],
                            SHARDS_WINDOWS)
    print(f"traces: {SHARDS_WINDOWS} windows x {len(SHARDS_NAMES)} tenants "
          f"x {ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    launches256 = drive("256-tenant", dev, swindows, SHARDS_NAMES,
                        SHARDS_CAPACITY, want_segments=True)

    # ------------- 6a. full window tape: cache_sim_scan vs its merge tree
    tr0 = windows[0]
    addrs = torch.cat([t.addrs for t in tr0]).to(dev)
    lens = torch.tensor([len(t) for t in tr0], device=dev)
    tid = torch.repeat_interleave(torch.arange(len(tr0), device=dev), lens)
    prev, nxt_c, _, _ = segment_links(addrs, tid,
                                      torch.cumsum(lens, 0)[tid])
    p32, n32 = prev.to(torch.int32), nxt_c.to(torch.int32)
    ones = torch.ones_like(p32)
    got = cache_sim_scan(p32, n32, ones).to(torch.int64)
    want = stack_distances_tree(prev, nxt_c)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    assert err == 0, f"full tape: kernel vs merge tree max err {err}"
    m = int(prev.shape[0])
    hot = prev >= 0
    pos = torch.arange(m, device=dev)
    compares = int((pos[hot] - prev[hot] - 1).sum())    # this kernel's work
    ms = cuda_ms(lambda: cache_sim_scan(p32, n32, ones), REPS)
    plain_ms = cuda_ms(lambda: stack_distances_tree(prev, nxt_c), REPS // 4)
    # the function's floor: read prev, nxt, occ and write SD once; a
    # Fenwick-tree count needs n * ceil(log2 n) operations
    bnd, bnd_by = bound_ms(16 * m, m * math.ceil(math.log2(max(m, 2))))
    print(f"full tape: {m} accesses; cache_sim_scan {ms:.3f} ms "
          f"({compares} compares of its own), merge-tree route "
          f"{plain_ms:.3f} ms, bound {bnd:.6f} ms by {bnd_by}; kernel / "
          f"bound = {ms / bnd:.1f}")
    rows = [{
        "name": "cache_sim_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:63",
        "launches": launches16["cache_sim_scan"],
        "max_abs_err": max(max_err["cache_sim_scan"], err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": None}]

    # ---- 6b. full sampled tape: cache_sim_segments_scan vs its tree
    str0 = swindows[0]
    rates = [auto_sample_rate(len(t)) for t in str0]
    addrs_s, _, kept = shards_subtape(str0, rates, 0,
                                      list(range(len(str0))), dev)
    tid_s = torch.repeat_interleave(torch.arange(len(str0), device=dev),
                                    kept)
    sub_bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(kept, 0)])
    prev, nxt_c, _, _ = segment_links(addrs_s, tid_s,
                                      sub_bounds[1:][tid_s])
    lay = padded_segment_layout(sub_bounds.cpu(), device=dev)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt_c, lay)
    groups = width_groups_of(lay[4])
    args = [(padded_group_links(gprev, gnxt, gocc, w, lo, hi), w)
            for w, lo, hi in groups]
    err = 0
    for (a, w) in args:
        got = cache_sim_segments_scan(*a, w).to(torch.int64)
        want = cache_sim_segments_tree(*a, w).to(torch.int64)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
    assert err == 0, f"sampled tape: kernel vs merge tree max err {err}"
    m, ops = segments_work(groups)
    seg_ms = cuda_ms(lambda: [cache_sim_segments_scan(*a, w)
                              for a, w in args], REPS)
    seg_plain = cuda_ms(lambda: [cache_sim_segments_tree(*a, w)
                                 for a, w in args], REPS // 4)
    bnd, bnd_by = bound_ms(16 * m, ops)
    print(f"sampled tape (window 0): {int(kept.sum())} kept of "
          f"{sum(len(t) for t in str0)} accesses, padded to {m} in "
          f"{len(groups)} width groups {[(w, hi - lo) for w, lo, hi in groups]}"
          f"; cache_sim_segments_scan {seg_ms:.3f} ms for the "
          f"{len(groups)} launches, merge-sort tree {seg_plain:.3f} ms, "
          f"bound {bnd:.6f} ms by {bnd_by}; kernel / bound = "
          f"{seg_ms / bnd:.1f}")
    rows.append({
        "name": "cache_sim_segments_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/"
                  "cache_sim_segments.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:136",
        "launches": launches256["cache_sim_segments_scan"],
        "max_abs_err": max(max_err["cache_sim_segments_scan"], err),
        "ms": seg_ms, "plain_ms": seg_plain, "bound_ms": bnd,
        "bound_by": bnd_by, "library_ms": None})
    print(f"cache_sim_scan launches on the 256-tenant path: "
          f"{launches256['cache_sim_scan']}; total run "
          f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
