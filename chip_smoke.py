#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
  3. hold each kernel against its plain PyTorch version on the card,
     exactly: ``cache_sim_scan`` vs the dense ``cache_sim_ref`` at tape
     lengths 1 .. 32768 (multi-tenant severed links, cold rows,
     ``occ = 1`` and ``occ = is_read``);
  4. drive the main path — ``make_manager("eci", ...)`` over 16 tenants,
     three Δt windows of 65,536 accesses each — on the card with every
     kernel launch counter set to 0 just before and read just after;
     then run the same windows through the port on the CPU and require
     equal sizes, policies, feasibility, per-tenant counts, final LRU
     states, and latencies to rel 1e-12;
  5. hold the kernel against the merge-tree route at the full window
     tape and time both (CUDA events), beside the bound of the function
     it computes (the larger of its bytes at the memory rate and a
     Fenwick-tree count's n * ceil(log2 n) operations at the 32-bit rate);
  6. print the kernels line, the card line and, last, the result line.

Exits non-zero, printing no result, when no card is visible or any
phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
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


def run_windows(device, windows, names, profile=None):
    """Run the windows through the ECI manager; returns the manager, the
    per-window wall times, each window's curves and each window's
    cumulative per-tenant counts."""
    from repro_torch.core import make_manager
    mgr = make_manager("eci", 6000, names, c_min=50, initial_blocks=100,
                       engine="batch", t_fast=1.0, t_slow=20.0,
                       flush_cost=10.0, device=device, profile=profile)
    walls, curves, counts = [], [], []
    for traces in windows:
        t0 = time.perf_counter()
        mgr.run_window(traces)
        if mgr.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        curves.append([t.h_fn for t in mgr.tenants])
        counts.append([dataclasses.asdict(t.result) for t in mgr.tenants])
    return mgr, walls, curves, counts


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
    if tie_at is not None:
        return
    for i, (tg, tc) in enumerate(zip(gpu.tenants, cpu.tenants)):
        (ag, fg), (ac, fc) = tg.cache.state_arrays(), tc.cache.state_arrays()
        assert torch.equal(ag.cpu(), ac) and torch.equal(fg.cpu(), fc), \
            f"tenant {i}: final LRU state differs"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import StageProfile
    from repro_torch.core.batch_sim import segment_links
    from repro_torch.data.traces import msr_trace
    from repro_torch.kernels import build_library
    from repro_torch.kernels.cache_sim.kernel import SOURCES, cache_sim_scan
    from repro_torch.kernels.cache_sim.ref import (cache_sim_ref,
                                                   stack_distances_tree)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(host_line())

    # -------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib, log = build_library("cache_sim", SOURCES)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ------------------------------------- 3. kernel vs plain, small tapes
    max_err = 0
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
            max_err = max(max_err, err)
        print(f"check: cache_sim_scan == cache_sim_ref at n={n} "
              f"(occ=1, occ=is_read; {int((prev < 0).sum())} cold rows)")

    # ----------------------------------------------------- 4. main path
    t0 = time.perf_counter()
    windows = [[msr_trace(nm, ACCESSES, seed=1000 * w + i)
                for i, nm in enumerate(MSR_16)]
               for w in range(WINDOWS)]
    print(f"traces: {WINDOWS} windows x {len(MSR_16)} tenants x "
          f"{ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    prof = StageProfile(dev)
    torch.cuda.reset_peak_memory_stats()
    cache_sim_scan.launches = 0
    gpu, walls, gpu_curves, gpu_counts = run_windows(dev, windows, MSR_16,
                                                     profile=prof)
    launches = cache_sim_scan.launches
    peak = torch.cuda.max_memory_allocated()
    assert launches > 0, "the main path launched no cache_sim_scan"
    for w, (wall, d) in enumerate(zip(walls, gpu.history)):
        print(f"window {w}: {wall:.3f} s on the card, feasible={d.feasible},"
              f" allocated={int(d.sizes.sum())}, policies="
              f"{''.join(p.value[0] for p in d.policies)}")
    print("stages (s, summed over windows): " + json.dumps(
        {k: round(v, 4) for k, v in prof.times.items()}))
    print(f"peak device memory: {peak / 2**20:.1f} MiB; cache_sim_scan "
          f"launches on the main path: {launches}")
    s = gpu.summary()
    # the reference's guard also flags PGD snaps below a c_min floor; the
    # card must flag exactly what the CPU run flags (compared below)
    print(f"guard violations observed: {s['guard_violations_observed']} "
          f"({'; '.join(v for d in gpu.history for v in d.guard) or 'none'})")
    assert np.isfinite(s["mean_latency"]) and s["accesses"] == \
        WINDOWS * len(MSR_16) * ACCESSES, "summary"
    assert all(int(d.sizes.sum()) <= 6000 for d in gpu.history), "capacity"

    t0 = time.perf_counter()
    cpu, cpu_walls, cpu_curves, cpu_counts = run_windows("cpu", windows,
                                                         MSR_16)
    print(f"CPU run of the same windows: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{x:.2f}' for x in cpu_walls)} s per window)")
    compare_runs(gpu, gpu_curves, gpu_counts, cpu, cpu_curves, cpu_counts)
    print("check: card run == CPU run (sizes, policies, feasibility, guard "
          "reports, per-tenant counts, LRU states; latencies to rel 1e-12)")

    # ----------------------- 5. full window tape: kernel vs merge tree
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
    max_err = max(max_err, err)
    m = int(prev.shape[0])
    hot = prev >= 0
    pos = torch.arange(m, device=dev)
    compares = int((pos[hot] - prev[hot] - 1).sum())    # this kernel's work
    ms = cuda_ms(lambda: cache_sim_scan(p32, n32, ones), REPS)
    plain_ms = cuda_ms(lambda: stack_distances_tree(prev, nxt_c), REPS // 4)
    # the function's floor: read prev, nxt, occ and write SD once; a
    # Fenwick-tree count needs n * ceil(log2 n) operations
    bytes_s = 16 * m / PEAK_BYTES_PER_S * 1e3
    ops_s = m * math.ceil(math.log2(max(m, 2))) / PEAK_OPS_PER_S * 1e3
    print(f"full tape: {m} accesses; kernel {ms:.3f} ms ({compares} "
          f"compares of its own), merge-tree route {plain_ms:.3f} ms, "
          f"bound max({bytes_s:.6f} ms bytes, {ops_s:.6f} ms operations); "
          f"kernel / bound = {ms / max(bytes_s, ops_s):.1f}")
    kernels = {"kernels": [{
        "name": "cache_sim_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:63",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_s, ops_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
