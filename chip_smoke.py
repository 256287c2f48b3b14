#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build the eight CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
     one ``nvcc`` per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card,
     exactly: ``cache_sim_scan`` vs the dense ``cache_sim_ref`` at tape
     lengths 1 .. 32768 (multi-tenant severed links, cold rows,
     ``occ = 1`` and ``occ = is_read``); ``cache_sim_segments_scan`` vs
     the dense ``cache_sim_segments_ref`` on padded multi-tenant tapes of
     widths 64 .. 8192 and 16384 (wider than one shared-memory stage);
     ``cache_sim_levels_scan`` vs ``cache_sim_levels_ref`` and
     ``live_count_scan`` vs ``live_counts_ref`` and ``live_counts_delta``
     at n = 1 .. 65,536 (ragged tenant blocks; cap1 = 0, cap1 = captot
     and varying rows; rows with nxt = -1, j and n); ``urd_scan`` vs the
     dense ``urd_scan_ref`` at n = 1 .. 65,536 (ragged tenant blocks,
     severed links, cold rows); ``flash_attention`` vs the dense
     ``attention_ref`` at the kernel's ``ref.SWEEP`` (tests/test_kernels.py's
     sweep plus head dim 112, GQA 16/8, ragged ``Sq != Skv``,
     ``window=96`` and ``Dv != D``), float32 (2e-5) and bfloat16 (2e-2);
     ``mamba2_ssd`` vs the sequential ``mamba2_ssd_ref`` at
     tests/test_kernels.py's sweep and vs the chunked form at its
     ``ref.SWEEP`` (zamba2's chunk 256 with B/C shared by 112 heads
     included; 3e-6 of the largest output); ``paged_attention`` vs
     ``paged_attention_ref`` at its ``ref.SWEEP`` (tests/test_kernels.py's
     sweep plus qwen3's 16/8 heads of 128 at page 8, 16 and 32; random
     tables, lengths 1, mid-page and on a page edge), float32 (2e-5) and
     bfloat16 (2e-2);
  4. drive slice 1's path — ``make_manager("eci", 6000, ...)`` over 16
     tenants, three Δt windows of 65,536 accesses each — on the card with
     every kernel launch counter set to 0 just before each window and
     read just after; then run the same windows through the port on the
     CPU and require equal sizes, policies, feasibility, per-tenant
     counts, final LRU states, summaries, and latencies to rel 1e-12;
  5. drive the SHARDS path — ``make_manager("eci", 96000, ...)`` over 256
     tenants (the 16 MSR profiles x 16), two windows of 65,536 accesses
     per tenant, which the manager monitors sampled by itself (rate
     1/16) — the same way, every window launching
     ``cache_sim_segments_scan``; then the same windows on the CPU
     (window 1 only while the run is inside its time budget; a cut is
     printed), compared as in phase 4, sample rates included;
  6. drive the ETICA path — ``make_manager("etica", 6000, ..., capacity2=
     24000, t_fast2=4.0)``, slice 1's windows — the same way, compared
     with the CPU level by level (sizes2, policies2, L2 counts, both
     levels' states, ``ro_fallback_windows``); before each window the
     tenants' two levels are cloned and the window replayed on the
     clones through ``simulate_many(return_window_rd=False)`` on the card
     (the ``cache_sim_levels_scan`` route, its launches counted there),
     with ``return_window_rd=True`` (``cache_sim_scan``) and on the CPU,
     all three equal; window 0 is also run through ``engine="lru"`` on
     the host;
  7. drive the pressure path — the same deployment at capacity 1200 /
     3600 with ``w_threshold=0`` (every tenant RO after window 0), two
     windows — compared with the CPU; at least one tenant-window must
     take the two-level token replay and none the interpreter;
  8. the Table-3 Analyzer: ``reuse_distances_accel`` (``urd_scan``) on
     the card for the four Table-3 workloads, ``msr_trace(name, 65536,
     seed=3)``, kinds ``urd`` and ``trd``, equal to
     ``reuse_distances_fast`` and the Fenwick ``reuse_distances`` on the
     CPU;
  9. the thousand-tenant control plane of
     ``benchmarks/bench_monitor_scale.py`` at 1024 tenants
     (``synthetic_mix(1024, 8000, seed=7)``, ``c_min=50``, capacity
     ``max(1024*50 + 1, int(0.35 * sum URD))``): the seed row (a
     per-tenant ``reuse_distances_accel`` loop, 1024 ``urd_scan``
     launches, and the fast greedy walk) and the fused row (exact
     ``analyze_windows`` and the fast walk) on the card, the heap walk on
     the CPU; allocations, feasibility and hit ratios equal;
 10. the remaining schemes on slice 1's deployment: ``static`` and
     ``reuse_intensity`` (every window launching ``live_count_scan``)
     driven as in phase 4, and ``GlobalLRUManager`` on the card against
     the CPU (counts, summaries, the shared LRU state);
 11. ``benchmarks/bench_scenarios.py``'s settings (capacity 8192,
     ``c_min=256``, seed 0): ``scan_flood`` isolation for ``eci`` and
     ``static`` (with and without the aggressor) and ``churn`` with
     ``phase_detect=True, reconfig_interval=10**9``, on the card and the
     CPU: event logs, ``windows_analyzed``, decisions and per-tenant
     latencies equal;
 12. the model layer, zamba2-7b at full width (``model_phase``): bf16
     from seed 0, ``prefill`` on 4 prompts of 2048 tokens (81
     ``mamba2_ssd`` and 13 ``flash_attention`` launches, counted), then 4
     requests of 1024 prompt tokens teacher-forced through
     ``decode_step`` and 32 greedy tokens (no launch; the prompt was
     1024 tokens until the serving phase took its time); the same prefill
     through the plain versions on the card, and in fp32 through both:
     the fp32 last logits held to the kernels' run, the bf16 ones' greedy
     tokens where bf16 cannot flip them; the kernels held to their plain
     versions at the captured bf16 prefill inputs; at reduced depth in fp32
     (3 layers, one group and a one-layer tail), prefill against
     teacher-forced decode over 512 tokens and the card against the CPU;
     each kernel timed at its full-width prefill shape beside its plain
     version, its bound and, for attention,
     ``scaled_dot_product_attention``;
 13. the serving path (``serving_phase``): qwen3-0.6b at full width in
     bf16 from seed 0 over a 14 GiB pool of 8192 16-token pages, the ECI
     manager partitioning 4096 of them between a "chat" tenant (a shared
     1536-token system prompt + 512 unique tokens) and a "batchjob"
     tenant (2048 unique tokens), 16 requests each, 32 new tokens, through
     ``MultiTenantEngine.run``: 896 ``flash_attention`` launches in
     prefill and 868 ``paged_attention`` launches in 31 decode steps
     (counted), no page-0 fallback; the same traffic through the plain
     versions on the card and in fp32 through both: summaries, pool
     stats, quotas, policies and decisions exactly equal, fp32 tokens
     equal and last logits within 1e-4 of max |logit|, bf16 tokens held
     where the fp32 top token leads by more than bf16 moves the logits;
     the kernel at the captured decode inputs element by element, timed
     beside ``paged_attention_ref``, ``_merge_self`` and its bound; 2
     layers at full width in fp32, the card against the CPU;
 14. time each kernel of the earlier slices at a full tape of its path
     (CUDA events) beside its plain version and the bound of the function
     it computes (the larger of its bytes at the memory rate and a tree
     count's operations at the 32-bit rate), holding it against the plain
     version there too; ``urd_scan`` at a 65,536-row Table-3 window and at
     the 1,048,576-row 16-tenant tape that times ``cache_sim_scan``;
 15. print the kernels line, the card line and, last, the result line.

Exits non-zero, printing no result, when no card is visible or any
phase fails.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import gc
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
# the ETICA path (benchmarks/bench_etica_two_level.py:31-33: L2 four times
# L1, t_fast2 = 4.0) and its all-RO pressure mix (PRESSURE_CAP1 / CAP1 =
# 0.2, PRESSURE_CAP2 / PRESSURE_CAP1 = 3)
ETICA_CAP1, ETICA_CAP2, T_FAST2 = 6000, 24000, 4.0
PRESSURE_CAP1, PRESSURE_CAP2, PRESSURE_WINDOWS = 1200, 3600, 3
# the CPU comparison of the SHARDS path runs window 1 only while the
# whole run stays inside this many seconds (10 of its 20 minutes)
CPU_BUDGET_S = 600.0
# the Table-3 Analyzer workloads (benchmarks/bench_monitor_scale.py:85)
TABLE3 = ("prxy_0", "prn_1", "hm_1", "web_1")
# the thousand-tenant control plane (bench_monitor_scale.py's 1024 point)
CP_TENANTS, CP_ACCESSES, CP_SEED, CP_C_MIN = 1024, 8000, 7, 50
# benchmarks/bench_scenarios.py's CAPACITY and C_MIN
SC_CAPACITY, SC_C_MIN = 8192, 256
SEGMENT_LENS = {64: [64, 1, 33, 0, 64], 512: [512, 300, 257, 0],
                4096: [4096, 2049, 3000], 8192: [8192, 5000, 4097],
                16384: [16384, 9000]}   # 16384: wider than one stage
# the model layer: zamba2-7b at full width in bf16 from seed 0; prefill
# of PREFILL_SHAPE prompts (a multiple of the 256-token SSM chunk), then
# DECODE_ROWS requests of DECODE_PROMPT tokens teacher-forced through
# decode_step and DECODE_NEW greedy tokens
MODEL_ARCH, MODEL_SEED = "zamba2_7b", 0
PREFILL_SHAPE = (4, 2048)
# DECODE_PROMPT was 1024 until the serving phase took its time
DECODE_ROWS, DECODE_PROMPT, DECODE_NEW = 4, 128, 32
# the reduced-depth fp32 config (full width): one hybrid group and a
# one-layer tail; prompts of two chunks
REDUCED = dict(n_layers=3, attn_every=2, dtype="float32")
REDUCED_PROMPT, REDUCED_DECODE = 512, 4
# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores, and
# fp32 outside them (the SSD kernel's arithmetic)
PEAK_BF16_PER_S = 989e12
PEAK_F32_PER_S = 67e12
# the serving path: qwen3-0.6b at full width in bf16 from seed 0 over a
# 14 GiB pool of 16-token pages; the manager partitions 4096 of its pages
# between two tenants after bench_serving_cache.py's: "chat" (a shared
# 1536-token system prompt + 512 unique tokens) and "batchjob" (2048
# unique tokens), 16 requests each, submitted in turn; every fourth prompt
# of each ends mid-page (CHAT_SHORT / BATCH_SHORT tokens short)
SERVE_ARCH, SERVE_SEED, SERVE_PAGE, SERVE_POOL = "qwen3_0_6b", 0, 16, 8192
SERVE_CAPACITY, SERVE_C_MIN, SERVE_INITIAL = 4096, 64, 2048
SERVE_WINDOW, SERVE_MAX_PAGES = 1024, 136
SERVE_PER_TENANT, SYS_PROMPT, CHAT_UNIQUE, BATCH_PROMPT = 16, 1536, 512, 2048
CHAT_SHORT, BATCH_SHORT, SERVE_NEW = 7, 9, 32
# the reduced-depth card-vs-CPU check: 2 layers at full width in fp32,
# 4 requests a tenant of a quarter the lengths, 8 new tokens, a 1024-page
# pool of which the manager partitions 256 (c_min 8, 128 each at first),
# rebalancing every 64 events
SERVE_REDUCED_LAYERS, SERVE_REDUCED_SCALE, SERVE_REDUCED_NEW = 2, 4, 8
SERVE_REDUCED = dict(n_pages=1024, capacity=256, c_min=8, initial=128,
                     window=64)
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


KERNEL_NAMES = ("cache_sim_scan", "cache_sim_segments_scan",
                "cache_sim_levels_scan", "live_count_scan", "urd_scan",
                "mamba2_ssd", "flash_attention", "paged_attention")
STAGES = ("tape", "ro_replay", "count", "replay", "monitor", "pgd")


def kernel_wrappers() -> dict:
    """name -> the launching wrapper (its ``launches`` is the count)."""
    from repro_torch.kernels.cache_sim import kernel as cache_sim
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mamba2_ssd import kernel as ssd
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.urd_scan import kernel as urd
    home = {"urd_scan": urd, "mamba2_ssd": ssd, "flash_attention": fa,
            "paged_attention": pa}
    return {name: getattr(home.get(name, cache_sim), name)
            for name in KERNEL_NAMES}


def zero_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def states_of(mgr) -> list:
    """Both levels' LRU states (addrs, dirty) of every tenant, on the
    host."""
    return [tuple(x.cpu() for x in t.cache.state_arrays())
            + tuple(x.cpu() for x in t.cache2.state_arrays())
            for t in mgr.tenants]


def run_windows(device, windows, names, capacity, profile=None,
                deadline=None, scheme="eci", before_window=None,
                engine="batch", **kw):
    """Run the windows through ``make_manager(scheme, ...)``; returns the
    manager and per-window records: wall time, curves, cumulative
    per-tenant counts, kernel launches, stage times and peak device
    memory, and both levels' LRU states after the window.  The launch
    counters are set to 0 just before each ``run_window`` and read just
    after.  ``before_window(mgr, w, traces)`` runs first in each window
    (its own launches are not counted).  With ``deadline`` (a
    ``time.perf_counter`` value), a window starts only if the last one
    would still end before it."""
    from repro_torch.core import make_manager
    mgr = make_manager(scheme, capacity, names, c_min=50, initial_blocks=100,
                       engine=engine, t_fast=1.0, t_slow=20.0,
                       flush_cost=10.0, device=device, profile=profile, **kw)
    rec = collections.defaultdict(list)
    cuda = mgr.device.type == "cuda"
    for w, traces in enumerate(windows):
        if deadline is not None and rec["walls"] \
                and time.perf_counter() + rec["walls"][-1] > deadline:
            break
        if before_window is not None:
            before_window(mgr, w, traces)
        st0 = dict(profile.times) if profile is not None else {}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        mgr.run_window(traces)
        if cuda:
            torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rec["launches"].append(read_counts())
        rec["peak"].append(torch.cuda.max_memory_allocated() if cuda else 0)
        rec["stages"].append({k: profile.times.get(k, 0.0) - st0.get(k, 0.0)
                              for k in STAGES} if profile is not None
                             else {})
        rec["curves"].append([t.h_fn for t in mgr.tenants])
        rec["counts"].append([dataclasses.asdict(t.result)
                              for t in mgr.tenants])
        rec["states"].append(states_of(mgr))
    return mgr, rec


def near_breakpoint(part, curves, tol: float = 1e-3) -> bool:
    """True when some tenant's relaxed optimum lies within ``tol`` blocks
    of one of its breakpoints (a float32 tie of the snap)."""
    if part is None or part.relaxed is None:
        return False
    for c, h in zip(part.relaxed.tolist(), curves):
        e = h.edges.to(torch.float64).cpu()
        if float(torch.min(torch.abs(e - c))) < tol:
            return True
    return False


def compare_counts(w: int, got, want, rel: float = 1e-12) -> None:
    """Per-tenant counts after window ``w`` (latency to ``rel``)."""
    for i, (rg, rc) in enumerate(zip(got, want)):
        rg, rc = dict(rg), dict(rc)
        lat_g, lat_c = rg.pop("total_latency"), rc.pop("total_latency")
        assert rg == rc, f"window {w}, tenant {i}: {rg} vs {rc}"
        assert abs(lat_g - lat_c) <= rel * abs(lat_c), \
            f"window {w}, tenant {i}: latency {lat_g} vs {lat_c}"


def compare_states(what: str, got, want) -> None:
    for i, (sg, sc) in enumerate(zip(got, want)):
        assert all(torch.equal(a, b) for a, b in zip(sg, sc)), \
            f"{what}, tenant {i}: final LRU state differs"


def pgd_tie(dg, dc, curves) -> str | None:
    """Which stage's sizes differ at a PGD tie ("L1" or "L2"), or None
    when they are equal.  Raises unless the stage is infeasible on both
    devices and both relaxed optima lie within 1e-3 of a breakpoint (of
    the residual curves, for L2)."""
    if dg.sizes.tolist() != dc.sizes.tolist():
        stage, pg, pc, cg = "L1", dg.partition, dc.partition, curves
    elif dg.sizes2 is not None and \
            dg.sizes2.tolist() != dc.sizes2.tolist():
        stage, pg, pc = "L2", dg.partition2, dc.partition2
        cg = [h.shifted(int(s)) for h, s in zip(curves, dg.sizes.tolist())]
    else:
        return None
    if not (not pg.feasible and not pc.feasible
            and near_breakpoint(pg, cg) and near_breakpoint(pc, cg)):
        raise AssertionError(f"{stage} sizes differ: card "
                             f"{(dg.sizes if stage == 'L1' else dg.sizes2).tolist()}"
                             f" vs CPU "
                             f"{(dc.sizes if stage == 'L1' else dc.sizes2).tolist()}")
    return stage


def compare_runs(gpu, grec, cpu, crec) -> None:
    """Decisions and per-tenant results of the card run equal the CPU run
    (latency floats to rel 1e-12), window by window.

    A PGD tie (in either stage: sizes differ, both runs infeasible there,
    both relaxed optima within 1e-3 of a breakpoint) is reported, not
    hidden. Its window's policies, feasibility and replay counts are
    still compared, since they do not depend on the snap; the later
    windows replay different sizes and are not."""
    tie_at = None
    for w, (dg, dc) in enumerate(zip(gpu.history, cpu.history)):
        assert [p.value for p in dg.policies] == \
            [p.value for p in dc.policies], f"window {w}: policies differ"
        assert [p.value for p in dg.policies2] == \
            [p.value for p in dc.policies2], f"window {w}: L2 policies"
        assert dg.feasible == dc.feasible, f"window {w}: feasibility"
        assert torch.equal(dg.sample_rates, dc.sample_rates), \
            f"window {w}: sample rates"
        compare_counts(w, grec["counts"][w], crec["counts"][w])
        stage = pgd_tie(dg, dc, grec["curves"][w])
        if stage is not None:
            print(f"PGD TIE in window {w} ({stage}): relaxed optimum within "
                  f"1e-3 of a breakpoint on both devices; card sizes "
                  f"{dg.sizes.tolist()} / {dg.sizes2.tolist()} guard "
                  f"{dg.guard} vs CPU {dc.sizes.tolist()} / "
                  f"{dc.sizes2.tolist()} guard {dc.guard}; policies, "
                  f"feasibility and counts through window {w} equal; "
                  f"later windows are not compared")
            tie_at = w
            break
        assert dg.guard == dc.guard, f"window {w}: guard {dg.guard}"
        compare_states(f"window {w}", grec["states"][w], crec["states"][w])
        for tag, pg, pc in (("L1", dg.partition, dc.partition),
                            ("L2", dg.partition2, dc.partition2)):
            if pg is None:
                continue
            if pg.relaxed is not None:
                same = torch.equal(pg.relaxed, pc.relaxed)
                print(f"window {w}: {tag} PGD relaxed optimum "
                      f"bit-identical card vs CPU: {same}")
            assert abs(pg.latency - pc.latency) <= 1e-12 * abs(pc.latency), \
                f"window {w}: {tag} partition latency {pg.latency} vs " \
                f"{pc.latency}"
    if tie_at is None and len(cpu.history) == len(gpu.history):
        sg, sc = gpu.summary(), cpu.summary()
        for k, v in sc.items():
            assert (sg[k] == v if isinstance(v, int)
                    else abs(sg[k] - v) <= 1e-12 * abs(v)), \
                f"summary {k}: {sg[k]} vs {v}"


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


def drive(path: str, dev, windows, names, capacity, want=(), scheme="eci",
          before_window=None, cpu_budget=False, **kw):
    """One main path on the card, every launch counter 0 just before each
    window and read just after (``want``: kernels every window must
    launch); then the same windows on the CPU, compared.  Returns the
    path's launches, the card manager and its records."""
    from repro_torch.core import StageProfile
    prof = StageProfile(dev)
    gpu, grec = run_windows(dev, windows, names, capacity, profile=prof,
                            scheme=scheme, before_window=before_window, **kw)
    launches = {k: sum(x[k] for x in grec["launches"]) for k in KERNEL_NAMES}
    assert launches["cache_sim_scan"] > 0, \
        f"{path}: the main path launched no cache_sim_scan"
    for k in want:
        per = [x[k] for x in grec["launches"]]
        assert all(x > 0 for x in per), f"{path}: a window launched no {k}: {per}"
    for w, d in enumerate(gpu.history):
        rates = sorted(set(d.sample_rates.tolist()))
        print(f"{path} window {w}: {grec['walls'][w]:.3f} s on the card, "
              f"peak device memory {grec['peak'][w] / 2**20:.1f} MiB, "
              f"feasible={d.feasible}, allocated={int(d.sizes.sum())}"
              f"+{int(d.sizes2.sum())}, sample rates {rates}, policies "
              f"{dict(collections.Counter(p.value for p in d.policies))}"
              f"/{dict(collections.Counter(p.value for p in d.policies2))}")
        print(f"{path} window {w} stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in grec["stages"][w].items()})
            + " launches: " + json.dumps(grec["launches"][w]))
    print(f"{path} peak device memory: {max(grec['peak']) / 2**20:.1f} MiB; "
          f"launches on the path: {json.dumps(launches)}")
    s = gpu.summary()
    print(f"{path} guard violations observed: "
          f"{s['guard_violations_observed']} ("
          f"{'; '.join(v for d in gpu.history for v in d.guard) or 'none'})"
          f"; ro_fallback_windows {s['ro_fallback_windows']}")
    assert np.isfinite(s["mean_latency"]) and s["accesses"] == \
        len(windows) * len(names) * ACCESSES, "summary"
    assert all(int(d.sizes.sum()) <= capacity for d in gpu.history), \
        "capacity"
    if "capacity2" in kw:
        assert all(int(d.sizes2.sum()) <= kw["capacity2"]
                   for d in gpu.history), "capacity2"

    t0 = time.perf_counter()
    deadline = T_START + CPU_BUDGET_S if cpu_budget else None
    cpu, crec = run_windows("cpu", windows, names, capacity,
                            deadline=deadline, scheme=scheme, **kw)
    print(f"{path} CPU run: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{x:.2f}' for x in crec['walls'])} s per window)")
    if len(crec["walls"]) < len(windows):
        print(f"{path} CUT: the CPU comparison covers {len(crec['walls'])} "
              f"of {len(windows)} windows (time budget {CPU_BUDGET_S:.0f} "
              f"s)")
    compare_runs(gpu, grec, cpu, crec)
    print(f"check: {path} card run == CPU run (sizes, policies, "
          f"feasibility, sample rates, guard reports, per-tenant counts, "
          f"LRU states, summary; latencies to rel 1e-12)")
    return launches, (gpu, grec), (cpu, crec)


class Recorder:
    """Wraps a module function: counts its calls and keeps the first
    call's positional and keyword arguments (the wrapped function still
    runs)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls, self.args, self.kwargs = 0, None, None
        self.by_device = collections.Counter()

    def __enter__(self):
        def wrapped(*a, **k):
            self.calls += 1
            self.by_device[a[0].device.type] += 1
            if self.args is None:
                self.args, self.kwargs = a, k
            return self.fn(*a, **k)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class RouteReplays:
    """Before each ETICA window: replay the window on clones of every
    tenant's two levels through ``simulate_many`` three ways — on the
    card with ``return_window_rd=False`` (``cache_sim_levels_scan``:
    counters 0 just before, read just after), on the card with
    ``return_window_rd=True`` (``cache_sim_scan``) and on the CPU — and
    require equal results and final states.  Keeps the levels kernel's
    launches and the last window's kernel inputs."""

    def __init__(self, dev):
        self.dev = dev
        self.launches = collections.Counter()
        self.args = None
        self.walls = []

    def _clones(self, mgr, device):
        from repro_torch.core import LRUCache
        out = ([], [])
        for t in mgr.tenants:
            for lv, c in enumerate((t.cache, t.cache2)):
                cl = LRUCache(c.capacity, device)
                a, d = c.state_arrays()
                cl.set_state_arrays(a.to(device).clone(), d.to(device).clone())
                out[lv].append(cl)
        return out

    def __call__(self, mgr, w, traces):
        import repro_torch.core.batch_sim as bs
        from repro_torch.core import simulate_many
        kw = dict(policies=[t.policy for t in mgr.tenants],
                  policies2=[t.policy2 for t in mgr.tenants],
                  t_fast=mgr.t_fast, t_slow=mgr.t_slow,
                  t_write_bypass=mgr.t_write_bypass, t_fast2=mgr.t_fast2,
                  flush_cost=mgr.flush_cost)
        runs = []
        for device, window_rd, counted in (
                (self.dev, False, True), (self.dev, True, False),
                (torch.device("cpu"), False, False)):
            c1, c2 = self._clones(mgr, device)
            if counted:
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                with Recorder(bs, "residency_levels") as rec:
                    res = simulate_many(traces, caches=c1, caches2=c2,
                                        return_window_rd=False,
                                        device=device, **kw)
                torch.cuda.synchronize()
                self.walls.append(time.perf_counter() - t0)
                got = read_counts()
                assert got["cache_sim_levels_scan"] == 1, got
                self.launches.update(got)
                self.args = rec.args
            else:
                res = simulate_many(traces, caches=c1, caches2=c2,
                                    return_window_rd=window_rd,
                                    device=device, **kw)
                res = res[0] if window_rd else res
            runs.append((res, [tuple(x.cpu() for x in c.state_arrays())
                               for c in c1 + c2]))
        (r0, s0), (r1, s1), (r2, s2) = runs
        assert r0 == r1 == r2, f"window {w}: residency routes differ"
        for a, b, c in zip(s0, s1, s2):
            assert all(torch.equal(x, y) and torch.equal(x, z)
                       for x, y, z in zip(a, b, c)), \
                f"window {w}: final states of the routes differ"
        print(f"check: ETICA window {w} replayed on clones: "
              f"cache_sim_levels_scan route == cache_sim_scan route == CPU "
              f"(results, both levels' states); levels route "
              f"{self.walls[-1]:.3f} s")


def _same_results(what: str, got, want, rel: float = 1e-12) -> None:
    """Per-tenant ``SimResult``s: counts exactly, latency to ``rel``."""
    assert len(got) == len(want), f"{what}: tenant counts differ"
    compare_counts(what, [dataclasses.asdict(r) for r in got],
                   [dataclasses.asdict(r) for r in want], rel)


def table3_phase(dev) -> collections.Counter:
    """Phase 8: the per-tenant Analyzer on the Table-3 workloads."""
    from repro_torch.core import reuse_distances, reuse_distances_fast
    from repro_torch.data.traces import msr_trace
    from repro_torch.kernels.urd_scan.ops import reuse_distances_accel
    launches = collections.Counter()
    for name in TABLE3:
        tr = msr_trace(name, ACCESSES, seed=3)
        for kind in ("urd", "trd"):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            got = reuse_distances_accel(tr, kind, device=dev)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            counts = read_counts()
            launches.update(counts)
            assert counts["urd_scan"] == 1, counts
            t0 = time.perf_counter()
            fast = reuse_distances_fast(tr, kind)
            t_fast = time.perf_counter() - t0
            t0 = time.perf_counter()
            fen = reuse_distances(tr, kind)
            t_fen = time.perf_counter() - t0
            assert torch.equal(got.distances.cpu(), fen.distances), \
                f"{name} {kind}: card vs Fenwick"
            assert torch.equal(fast.distances, fen.distances), \
                f"{name} {kind}: merge tree vs Fenwick"
            print(f"Table 3 {name} {kind}: {int((fen.distances >= 0).sum())}"
                  f" samples, max {int(fen.distances.max())}; "
                  f"reuse_distances_accel on the card {t_card:.4f} s, "
                  f"reuse_distances_fast on the CPU {t_fast:.4f} s, Fenwick "
                  f"on the CPU {t_fen:.4f} s; all equal")
    print(f"check: Table-3 Analyzer on the card == reuse_distances_fast == "
          f"Fenwick (4 workloads x urd/trd, {ACCESSES} accesses); launches "
          f"{json.dumps(dict(launches))}")
    return launches


def control_plane_phase(dev) -> collections.Counter:
    """Phase 9: the 1024-tenant control plane, seed and fused rows on the
    card, the heap walk on the CPU."""
    from repro_torch.core import (Trace, analyze_windows,
                                  build_hit_ratio_function, greedy_allocate,
                                  urd_cache_blocks, write_ratio)
    from repro_torch.core.mrc import BatchedHitRatioFunctions
    from repro_torch.data.traces import synthetic_mix
    from repro_torch.kernels.urd_scan.ops import reuse_distances_accel
    t0 = time.perf_counter()
    traces = synthetic_mix(CP_TENANTS, CP_ACCESSES, seed=CP_SEED)
    dtr = [Trace(t.addrs.to(dev), t.is_read.to(dev), t.name) for t in traces]
    torch.cuda.synchronize()
    urd_total = int(analyze_windows(dtr, "urd", device=dev)
                    .curves.max_useful_sizes.sum())
    capacity = max(CP_TENANTS * CP_C_MIN + 1, int(0.35 * urd_total))
    print(f"control plane: {CP_TENANTS} tenants x {CP_ACCESSES} accesses "
          f"({CP_TENANTS * CP_ACCESSES} in all), sum URD {urd_total}, "
          f"capacity {capacity}; traces made and moved to the card, "
          f"capacity found, in {time.perf_counter() - t0:.1f} s")
    rows = {}
    for row in ("seed", "fused"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        if row == "seed":
            hs = []
            for tr in dtr:
                rd = reuse_distances_accel(tr, "urd", device=dev)
                hs.append(build_hit_ratio_function(rd))
                urd_cache_blocks(rd)
                write_ratio(tr)
            curves = BatchedHitRatioFunctions.from_curves(hs)
        else:
            curves = analyze_windows(dtr, "urd", device=dev).curves
        part = greedy_allocate(curves, capacity, 1.0, 20.0, c_min=CP_C_MIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        rows[row] = (curves, part, counts)
        print(f"control plane {row} row on the card: {wall:.3f} s, peak "
              f"device memory {peak:.1f} MiB, launches {json.dumps(counts)}")
    assert rows["seed"][2]["urd_scan"] == CP_TENANTS, rows["seed"][2]
    assert rows["fused"][2]["cache_sim_scan"] >= 1, rows["fused"][2]
    host = rows["fused"][0].to("cpu")
    t0 = time.perf_counter()
    heap = greedy_allocate(host, capacity, 1.0, 20.0, c_min=CP_C_MIN,
                           method="heap")
    print(f"control plane heap walk on the CPU: "
          f"{time.perf_counter() - t0:.3f} s over {host.edges.numel()} "
          f"breakpoints")
    sc, sf = rows["seed"][0].to("cpu"), host
    assert all(torch.equal(getattr(sc, f), getattr(sf, f)) for f in
               ("edges", "heights", "offsets", "n_accesses")), \
        "seed curves differ from the fused curves"
    for row in ("seed", "fused"):
        part = rows[row][1]
        assert part.sizes.tolist() == heap.sizes.tolist(), f"{row} sizes"
        assert part.feasible == heap.feasible, f"{row} feasibility"
        assert torch.equal(part.hit_ratios, heap.hit_ratios), \
            f"{row} hit ratios"
        assert abs(part.latency - heap.latency) <= 1e-12 * abs(heap.latency)
    print(f"check: control plane seed row == fused row == heap walk "
          f"(curves bit for bit, allocations {int(heap.sizes.sum())} blocks"
          f", feasible={heap.feasible}, hit ratios bit for bit)")
    return rows["seed"][2]


def global_lru_phase(dev, windows) -> None:
    """Phase 10, last part: one shared LRU on the card and on the CPU."""
    from repro_torch.core import GlobalLRUManager
    runs = []
    for device in (dev, torch.device("cpu")):
        mgr = GlobalLRUManager(6000, MSR_16, t_fast=1.0, t_slow=20.0,
                               device=device)
        walls = []
        for traces in windows:
            t0 = time.perf_counter()
            mgr.run_window(traces)
            walls.append(time.perf_counter() - t0)
        runs.append(mgr)
        print(f"global LRU on {device.type}: "
              f"{', '.join(f'{x:.2f}' for x in walls)} s per window; "
              f"state on {mgr.cache.state_arrays()[0].device}")
    g, c = runs
    assert g.cache.state_arrays()[0].device.type == "cuda"
    _same_results("global LRU", g.results, c.results)
    compare_states("global LRU", [tuple(x.cpu() for x in
                                        g.cache.state_arrays())],
                   [c.cache.state_arrays()])
    sg, sc = g.summary(), c.summary()
    assert all(abs(sg[k] - v) <= 1e-12 * abs(v) for k, v in sc.items()), \
        f"global LRU summary {sg} vs {sc}"
    print(f"check: global LRU card == CPU (counts, summary "
          f"{json.dumps({k: sg[k] for k in ('read_hit_ratio', 'mean_latency')})}"
          f", shared LRU state)")


def _scenario_log(mgr) -> list:
    return [(e.window, e.tenant, e.reason, e.score) for e in mgr.events]


def scenarios_phase(dev) -> collections.Counter:
    """Phase 11: bench_scenarios' isolation and churn, card vs CPU."""
    from repro_torch.core import make_manager
    from repro_torch.data.scenarios import (churn, per_tenant_latency,
                                            replay_scenario, scan_flood)

    def factory(scheme, device, **kw):
        return lambda names: make_manager(
            scheme, SC_CAPACITY, names, c_min=SC_C_MIN,
            initial_blocks=SC_C_MIN, t_fast=1.0, t_slow=20.0,
            flush_cost=10.0, device=device, **kw)

    launches = collections.Counter()

    def both(tag, run, scheme, exclude=frozenset(), **kw):
        out, counts = [], {}
        for device in (dev, torch.device("cpu")):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            mgr, imap = replay_scenario(run, factory(scheme, device, **kw),
                                        exclude=exclude)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if device.type == "cuda":
                counts = read_counts()
                launches.update(counts)
            out.append((mgr, imap, wall))
        (g, gi, gw), (c, ci, cw) = out
        assert _scenario_log(g) == _scenario_log(c), f"{tag}: events"
        assert gi == ci
        assert (g.windows_analyzed, g.windows_run) == \
            (c.windows_analyzed, c.windows_run), f"{tag}: windows"
        for w, (dg, dc) in enumerate(zip(g.history, c.history)):
            assert dg.sizes.tolist() == dc.sizes.tolist(), f"{tag} {w}"
            assert dg.policies == dc.policies, f"{tag} {w}: policies"
            assert dg.guard == dc.guard, f"{tag} {w}: guard"
        assert len(g.history) == len(c.history)
        _same_results(tag, [t.result for t in g.tenants],
                      [t.result for t in c.tenants])
        lg, lc = per_tenant_latency(g, gi), per_tenant_latency(c, ci)
        assert lg.keys() == lc.keys() and all(
            abs(lg[k] - lc[k]) <= 1e-12 * abs(lc[k]) for k in lc), tag
        print(f"scenario {tag}: card {gw:.2f} s, CPU {cw:.2f} s; "
              f"{g.windows_analyzed} of {g.windows_run} windows analyzed, "
              f"{len(g.events)} events; launches {json.dumps(counts)}")
        return lg

    flood = scan_flood(seed=0)
    for scheme in ("eci", "static"):
        full = both(f"scan_flood {scheme}", flood, scheme)
        solo = both(f"scan_flood {scheme} without the aggressor", flood,
                    scheme, exclude={flood.aggressor})
        degr = {v: (full[v] - solo[v]) / max(solo[v], 1e-12)
                for v in sorted(solo) if v != flood.aggressor}
        print(f"scan_flood {scheme} isolation: max per-victim degradation "
              f"{max(degr.values())!r} ({json.dumps(degr)})")
    run = churn(seed=0)
    both("churn", run, "eci", phase_detect=True, reconfig_interval=10**9)
    print(f"check: scenarios card == CPU (event logs, windows analyzed, "
          f"decisions, per-tenant counts and latencies); launches "
          f"{json.dumps(dict(launches))}")
    assert launches["cache_sim_scan"] > 0
    return launches


def check_close(max_err: dict, name: str, what: str, got, want,
                tol: float, scale: float = 1.0) -> float:
    """Float kernels: |got - want| <= tol * scale everywhere; records the
    largest absolute difference."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    assert got.shape == want.shape and err <= tol * scale, \
        f"{name} {what}: max err {err} > {tol} x {scale}"
    max_err[name] = max(max_err[name], err)
    return err


def model_kernel_checks(dev, max_err: dict) -> None:
    """Phase 3 for the model layer's kernels: ``flash_attention`` against
    the dense ``attention_ref`` (f32 2e-5, bf16 2e-2) and ``mamba2_ssd``
    against the sequential ``mamba2_ssd_ref`` and the chunked form (3e-6
    of the largest output), at the sweeps of tests/test_kernels.py and
    the extra cases."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import SWEEP as ATTN_SWEEP
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
    from repro_torch.kernels.mamba2_ssd.ref import SWEEP as SSD_SWEEP
    from repro_torch.kernels.mamba2_ssd.ref import (SEQUENTIAL_CASES,
                                                    mamba2_ssd_chunked,
                                                    mamba2_ssd_ref,
                                                    seg_from_dA)
    gen = torch.Generator(device=dev).manual_seed(0)
    for case in ATTN_SWEEP:
        b, hq, hkv, sq, skv, d, dv, causal, window = case
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
            k = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
            v = torch.randn((b, hkv, skv, dv), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            check_close(max_err, "flash_attention", f"{case} {dtype}",
                        flash_attention(q, k, v, causal=causal,
                                        window=window),
                        attention_ref(q, k, v, causal=causal, window=window),
                        tol)
    print(f"check: flash_attention == attention_ref at {len(ATTN_SWEEP)} "
          f"shapes (tests/test_kernels.py's sweep, D 112, GQA 16/8, ragged, "
          f"window 96, Dv != D) in float32 and bfloat16 (2e-5 / 2e-2); "
          f"max err {max_err['flash_attention']:.3g}")
    for i, (bh, s, p, n, chunk, groups) in enumerate(SSD_SWEEP):
        x = torch.randn((bh, s, p), generator=gen, device=dev) * 0.5
        B = torch.randn((groups, s, n), generator=gen, device=dev) * 0.5
        C = torch.randn((groups, s, n), generator=gen, device=dev) * 0.5
        dA = -torch.rand((bh, s), generator=gen, device=dev) * 0.5
        seg = seg_from_dA(dA, chunk)
        got = mamba2_ssd(x, B, C, seg, chunk=chunk)
        # every case against the chunked form (the same sums in another
        # order), the reference sweep's also against the sequential one
        wants = [("mamba2_ssd_chunked", mamba2_ssd_chunked(x, B, C, seg,
                                                           chunk=chunk))]
        if i < SEQUENTIAL_CASES:
            wants.append(("mamba2_ssd_ref", mamba2_ssd_ref(x, B, C, dA)))
        for plain, want in wants:
            scale = float(want.abs().max())
            err = check_close(max_err, "mamba2_ssd", f"BH={bh} S={s} vs "
                              f"{plain}", got, want, 3e-6, scale)
            print(f"check: mamba2_ssd == {plain} at BH={bh} S={s} P={p} "
                  f"N={n} chunk={chunk}, B/C shared by {bh // groups} rows: "
                  f"max err {err:.3g} ({err / scale:.3g} of max |y|; bound "
                  f"3e-6)")


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    return tree.numel()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rel(got, want) -> float:
    """max |got - want| over max |want| (logits)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def attention_work(q, k, v, causal: bool, window: int) -> tuple[int, int]:
    """(bytes, FLOPs) flash attention needs at these inputs: q, k, v read
    and the output written once; 2 (D + Dv) FLOPs per (query, seen key)
    pair, counted from this run's masks."""
    b, hq, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    seen = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        seen &= kp <= qp
    if window > 0:
        seen &= kp > qp - window
    pairs = int(seen.sum()) * b * hq
    nbytes = (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) \
        * q.element_size()
    return nbytes, 2 * (d + dv) * pairs


def ssd_work(x_dt, B, chunk: int) -> tuple[int, int]:
    """(bytes, FLOPs) the SSD scan needs: x, B, C, seg read and y written
    once (fp32); per row and chunk Q(Q+1)/2 * P multiply-adds for the
    causal intra product and 2 Q N P for the inter term and the state,
    per group and chunk Q(Q+1)/2 * N for the shared scores."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    nbytes = 4 * (2 * bh * s * p + 2 * g * s * n + bh * s)
    macs = bh * nc * (pairs * p + 2 * chunk * n * p) + g * nc * pairs * n
    return nbytes, 2 * macs


def model_phase(dev, max_err: dict) -> list[dict]:
    """Phase 12: zamba2-7b at full width on the card.

    (a) bf16 from seed 0: ``prefill`` on 4 prompts of 2048 tokens (one
    warm-up call, then the counted one: 81 ``mamba2_ssd`` and 13
    ``flash_attention`` launches), then 4 requests of 1024 prompt tokens
    teacher-forced through ``decode_step`` and 32 greedy tokens (no
    launch); (b) the same prefill through the plain versions on the card
    (no launch), and the same model in fp32 (the bf16 parameters are its
    rounding) through both: the fp32 last logits held to 1e-4 of max
    |logit|; in bf16 the kernels' greedy tokens held to the plain run's
    in every row where the fp32 top token leads by more than bf16 itself
    moves the logits, and the distance printed beside the plain bf16
    run's own from fp32; (c) the reduced-depth fp32 config (full width,
    one group and a one-layer tail): prefill's last logits against
    teacher-forced decode's at the last prompt token on 1 x 512 tokens,
    and prefill plus 4 decode steps against the port's own CPU run; (d)
    each kernel timed at its full-width shape (CUDA events) beside its
    plain version, the library call where one exists, and its bound.
    Returns the kernels' rows."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.mamba2_ssd.ops as ssd_ops
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         blockwise_attention)
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MODEL_ARCH)
    n_groups, g, rem = M.hybrid_groups(cfg)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=MODEL_SEED, device=dev)
    torch.cuda.synchronize()
    print(f"model: {cfg.name} at full width ({cfg.n_layers} Mamba-2 layers, "
          f"d {cfg.d_model}, d_inner {cfg.ssm_d_inner}, {cfg.ssm_n_heads} "
          f"SSM heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}; shared attention+SwiGLU block of {cfg.n_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, after every {g} "
          f"layers: {n_groups} times, {rem}-layer tail); n_params() "
          f"{cfg.n_params():,}, {_leaf_count(params):,} in the tree "
          f"(norms, conv and SSM scalars included), {cfg.dtype} from seed "
          f"{MODEL_SEED} in {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------- (a) the main path, bf16
    rng = np.random.default_rng(MODEL_SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, PREFILL_SHAPE),
                              device=dev)
    want_ssd, want_fa = cfg.n_layers, n_groups
    with Recorder(fa_ops, "flash_attention") as fa_rec, \
            Recorder(ssd_ops, "mamba2_ssd") as ssd_rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, prompts)                      # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = M.prefill(params, cfg, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_launches = read_counts()
    pre_peak = torch.cuda.max_memory_allocated()
    assert pre_launches["mamba2_ssd"] == want_ssd and \
        pre_launches["flash_attention"] == want_fa, \
        f"prefill launches {pre_launches}, predicted {want_ssd} / {want_fa}"
    assert sum(pre_launches.values()) == want_ssd + want_fa
    assert logits.shape == (PREFILL_SHAPE[0], cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    ntok = PREFILL_SHAPE[0] * PREFILL_SHAPE[1]
    print(f"prefill {PREFILL_SHAPE[0]} x {PREFILL_SHAPE[1]} bf16: "
          f"{prefill_s * 1e3:.1f} ms ({ntok / prefill_s:.0f} tokens/s; "
          f"warm-up call {warm_s * 1e3:.1f} ms); peak device memory "
          f"{pre_peak / 2**30:.2f} GiB; launches {json.dumps(pre_launches)} "
          f"== predicted (mamba2_ssd {want_ssd}, flash_attention {want_fa})")

    cache = M.init_decode_cache(cfg, DECODE_ROWS, DECODE_PROMPT + DECODE_NEW,
                                device=dev)
    req = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (DECODE_ROWS, DECODE_PROMPT)),
                          device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for t in range(DECODE_PROMPT):
        out, cache = M.decode_step(params, cfg, req[:, t], cache)
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    tok, new = out.argmax(-1), []
    t0 = time.perf_counter()
    for _ in range(DECODE_NEW):
        new.append(tok)
        out, cache = M.decode_step(params, cfg, tok, cache)
        tok = out.argmax(-1)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    dec_launches = read_counts()
    dec_peak = torch.cuda.max_memory_allocated()
    new = torch.stack(new, 1)
    assert not any(dec_launches.values()), f"decode launched {dec_launches}"
    assert bool(torch.isfinite(out[:, :cfg.vocab_size]).all())
    assert bool((out[:, cfg.vocab_size:] == -1e30).all())
    assert cache["len"].tolist() == [DECODE_PROMPT + DECODE_NEW] * DECODE_ROWS
    assert bool(((new >= 0) & (new < cfg.vocab_size)).all())
    steps = DECODE_PROMPT + DECODE_NEW
    print(f"decode: {DECODE_ROWS} requests x ({DECODE_PROMPT} teacher-forced "
          f"+ {DECODE_NEW} greedy) bf16: {forced_s / DECODE_PROMPT * 1e3:.2f} "
          f"ms a teacher-forced step, {greedy_s / DECODE_NEW * 1e3:.2f} ms a "
          f"greedy step ({DECODE_ROWS * steps / (forced_s + greedy_s):.1f} "
          f"tokens/s over {steps} steps of {DECODE_ROWS} rows); peak device "
          f"memory {dec_peak / 2**30:.2f} GiB; launches "
          f"{json.dumps(dec_launches)} (none predicted); first request's "
          f"greedy tokens {new[0, :8].tolist()}...")

    # ---------------- (b) the same prefill through the plain versions
    def plain_prefill(prm):
        """``prefill`` with the plain versions in the kernels' places
        (swapped here only; the port has no switch): no launch."""
        saved = (attention.prefill_attention, ssd_ops.mamba2_ssd)
        attention.prefill_attention, ssd_ops.mamba2_ssd = \
            blockwise_attention, mamba2_ssd_chunked
        try:
            zero_counts()
            out = M.prefill(prm, cfg, prompts)
            torch.cuda.synchronize()
            assert not any(read_counts().values()), "the plain run launched"
        finally:
            attention.prefill_attention, ssd_ops.mamba2_ssd = saved
        return out

    t0 = time.perf_counter()
    plain_logits = plain_prefill(params)
    plain_s = time.perf_counter() - t0
    del params, cache
    # the same model in fp32: the bf16 parameters are these rounded (one
    # generator, the same draws), so the fp32 runs show what bf16 itself
    # moves and hold the kernels to the plain versions without it
    params32 = M.init_params(dataclasses.replace(cfg, dtype="float32"),
                             seed=MODEL_SEED, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    logits32 = M.prefill(params32, cfg, prompts)
    torch.cuda.synchronize()
    k32_s = time.perf_counter() - t0
    got = read_counts()
    assert (got["mamba2_ssd"], got["flash_attention"]) == (want_ssd, want_fa)
    plain32 = plain_prefill(params32)
    del params32
    rel32 = _rel(logits32, plain32)
    noise = _rel(plain_logits, plain32)
    rel = _rel(logits, plain_logits)

    nv = cfg.vocab_size

    def greedy(a) -> list[int]:
        return a[:, :nv].argmax(-1).tolist()

    top2 = plain32[:, :nv].topk(2, dim=-1).values
    lead = ((top2[:, 0] - top2[:, 1]) / plain32[:, :nv].abs().max()).tolist()
    # fp32: only the order of the sums differs (about 1e-6 relative an
    # operation, TF32 off), so a wrong kernel stands out by orders of
    # magnitude above 1e-4 of max |logit|
    assert rel32 <= 1e-4, f"fp32 kernels vs plain prefill: {rel32}"
    assert greedy(logits32) == greedy(plain32)
    # bf16: the kernels' arithmetic is held above (fp32) and their bf16
    # loads and stores at the captured inputs in (d); here each row's
    # greedy token must be the plain bf16 run's.  The distance in max
    # |logit| is a reading: bf16 rounding alone moves the plain run about
    # as far from fp32
    assert greedy(logits) == greedy(plain_logits), \
        f"bf16 greedy tokens: kernels {greedy(logits)}, plain " \
        f"{greedy(plain_logits)} (fp32 top-1 leads {lead})"
    print(f"check: full-width prefill {PREFILL_SHAPE[0]} x "
          f"{PREFILL_SHAPE[1]}, kernels vs plain versions on the card: fp32 "
          f"last logits within {rel32:.3g} of max |logit| (tolerance 1e-4: "
          f"summation order only), same greedy tokens; bf16: same greedy "
          f"tokens {greedy(logits)} (plain fp32 {greedy(plain32)}; fp32 "
          f"top-1 leads its runner-up by "
          f"{', '.join(f'{x:.3g}' for x in lead)} of max |logit|), last "
          f"logits {rel:.3g} of max |logit| apart (a reading: the plain "
          f"bf16 run lies {noise:.3g} from the plain fp32 run); plain bf16 "
          f"prefill {plain_s * 1e3:.1f} ms, fp32 kernels prefill "
          f"{k32_s * 1e3:.1f} ms")
    rows_in = ((fa_rec.args, fa_rec.kwargs),
               (ssd_rec.args, ssd_rec.kwargs))
    del plain_logits, logits32, plain32

    # --------------------- (c) reduced depth, fp32, full width
    rcfg = dataclasses.replace(cfg, **REDUCED)
    rp = M.init_params(rcfg, seed=MODEL_SEED, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, REDUCED_PROMPT)), device=dev)
    zero_counts()
    pre = M.prefill(rp, rcfg, toks)
    got = read_counts()
    assert (got["mamba2_ssd"], got["flash_attention"]) == (3, 1), got
    rc = M.init_decode_cache(rcfg, 1, REDUCED_PROMPT, device=dev)
    for t in range(REDUCED_PROMPT):
        out, rc = M.decode_step(rp, rcfg, toks[:, t], rc)
    v = rcfg.vocab_size
    rel = _rel(out[:, :v], pre[:, :v])
    assert rel <= 2e-4, f"prefill vs decode (fp32): {rel}"
    print(f"check: reduced depth ({rcfg.n_layers} layers, attn_every "
          f"{rcfg.attn_every}) fp32 at full width: prefill's last logits vs "
          f"teacher-forced decode's at token {REDUCED_PROMPT}: within "
          f"{rel:.3g} of max |logit| (tolerance 2e-4, the reference's "
          f"prefill/decode bound, tests/test_models.py:78)")
    t0 = time.perf_counter()
    cp = _to(rp, "cpu")
    cpu_pre = M.prefill(cp, rcfg, toks.cpu())
    rel_pre = _rel(pre.cpu(), cpu_pre)
    gc = M.init_decode_cache(rcfg, 1, REDUCED_DECODE, device=dev)
    cc = M.init_decode_cache(rcfg, 1, REDUCED_DECODE, device="cpu")
    rel_dec = 0.0
    for t in range(REDUCED_DECODE):
        lg, gc = M.decode_step(rp, rcfg, toks[:, t], gc)
        lc, cc = M.decode_step(cp, rcfg, toks[:, t].cpu(), cc)
        rel_dec = max(rel_dec, _rel(lg[:, :v].cpu(), lc[:, :v]))
    # fp32 on both sides (TF32 off; the conv is a sum of shifted products,
    # no cuDNN): only the order of the sums differs, about 1e-6 relative
    assert rel_pre <= 1e-4 and rel_dec <= 1e-4, (rel_pre, rel_dec)
    print(f"check: reduced-depth fp32 card vs CPU ({time.perf_counter() - t0:.1f}"
          f" s on the host): prefill 1 x {REDUCED_PROMPT} last logits within "
          f"{rel_pre:.3g}, {REDUCED_DECODE} decode steps within {rel_dec:.3g} "
          f"of max |logit| (tolerance 1e-4)")
    del rp, cp, rc, gc, cc

    # -------------------- (d) the kernels at their full-width shapes
    rows = []
    # the model hands the wrapper [B, H, S, D] views: copy them once, so
    # that the times below are the kernel's alone
    q, k, v = (t.contiguous() for t in rows_in[0][0])
    fa_kw = dict(causal=cfg.causal, window=cfg.window)
    got = flash_attention(q, k, v, **fa_kw)
    want = attention_ref(q, k, v, **fa_kw)
    want32, diff = want.float(), (got.float() - want.float()).abs()
    top, typical = float(want32.abs().max()), float(want32.abs().mean())
    # both round an fp32 result to bf16: one bf16 step (2^-7 of a value)
    # each way apart at most, plus the fp32 summation order (about 1e-6
    # of max |out|); held element by element to two steps of the value
    # plus 1e-4 of max |out|
    limit = 2.0 ** -6 * want32.abs() + 1e-4 * top
    worst = float((diff / limit).max())
    err = float(diff.max())
    assert got.shape == want.shape and worst <= 1.0, \
        f"flash_attention at the captured inputs: {worst} of its limit"
    max_err["flash_attention"] = max(max_err["flash_attention"], err)
    print(f"check: flash_attention == attention_ref at the captured bf16 "
          f"prefill inputs {list(q.shape)}: max err {err:.3g} (max |out| "
          f"{top:.3g}, mean |out| {typical:.3g}); the worst element at "
          f"{worst:.3g} of its limit 2^-6 |out| + 1e-4 max |out|")
    ms = cuda_ms(lambda: flash_attention(q, k, v, **fa_kw), REPS)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **fa_kw), REPS // 4)
    blk_ms = cuda_ms(lambda: blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **fa_kw),
        REPS // 4)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), REPS)
    nbytes, flops = attention_work(q, k, v, **fa_kw)
    bnd, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                  (flops / PEAK_BF16_PER_S * 1e3, "operations"))
    print(f"flash_attention at {list(q.shape)} {q.dtype} (captured prefill "
          f"inputs): {ms:.3f} ms, attention_ref {plain_ms:.3f} ms, "
          f"blockwise_attention {blk_ms:.3f} ms, scaled_dot_product_attention "
          f"{lib_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB: "
          f"bound {bnd:.4f} ms by {by}; kernel / bound = {ms / bnd:.1f}")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
        "launches": pre_launches["flash_attention"],
        "max_abs_err": max_err["flash_attention"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib_ms})
    (x_dt, B, C, seg), kw = rows_in[1]
    chunk = kw["chunk"]
    want = mamba2_ssd_chunked(x_dt, B, C, seg, chunk=chunk)
    check_close(max_err, "mamba2_ssd", "full-width prefill inputs",
                mamba2_ssd(x_dt, B, C, seg, chunk=chunk), want, 3e-6,
                float(want.abs().max()))
    ms = cuda_ms(lambda: mamba2_ssd(x_dt, B, C, seg, chunk=chunk), REPS)
    plain_ms = cuda_ms(lambda: mamba2_ssd_chunked(x_dt, B, C, seg,
                                                  chunk=chunk), REPS // 4)
    nbytes, flops = ssd_work(x_dt, B, chunk)
    bnd, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                  (flops / PEAK_F32_PER_S * 1e3, "operations"))
    print(f"mamba2_ssd at x_dt {list(x_dt.shape)}, B/C {list(B.shape)}, "
          f"chunk {chunk} (captured layer-0 prefill inputs): {ms:.3f} ms, "
          f"mamba2_ssd_chunked {plain_ms:.3f} ms; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB: bound {bnd:.4f} ms by {by}; kernel / "
          f"bound = {ms / bnd:.1f}")
    rows.append({
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:68",
        "launches": pre_launches["mamba2_ssd"],
        "max_abs_err": max_err["mamba2_ssd"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None})
    return rows


PAGED_NAMES = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")


def paged_kernel_checks(dev, max_err: dict) -> None:
    """Phase 3 for the serving kernel: ``paged_attention`` against
    ``paged_attention_ref`` at the kernel's ``ref.SWEEP`` (tests/
    test_kernels.py's three shapes, then qwen3-0.6b's heads at page 8, 16
    and 32; random tables, lengths mid-page, on a page edge and at 1),
    float32 (2e-5) and bfloat16 (2e-2)."""
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ref import (SWEEP,
                                                         paged_attention_ref,
                                                         sweep_arrays)
    for i, case in enumerate(SWEEP):
        a = sweep_arrays(case, seed=i)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            args = [torch.from_numpy(a[n]).to(dev) for n in PAGED_NAMES]
            args[:3] = [t.to(dtype) for t in args[:3]]
            check_close(max_err, "paged_attention", f"{case} {dtype}",
                        paged_attention(*args), paged_attention_ref(*args),
                        tol)
    print(f"check: paged_attention == paged_attention_ref at {len(SWEEP)} "
          f"shapes (tests/test_kernels.py's sweep, qwen3's 16/8 heads of 128 "
          f"at page 8, 16, 32; lengths 1, mid-page, page edge) in float32 "
          f"and bfloat16 (2e-5 / 2e-2); max err "
          f"{max_err['paged_attention']:.3g}")


def serve_traffic(vocab: int, scale: int = 1,
                  per_tenant: int = SERVE_PER_TENANT) -> list:
    """(tenant, prompt) in submission order: chat and batchjob in turn;
    every fourth prompt of each tenant ends mid-page.  ``scale`` divides
    the lengths (the reduced-depth check)."""
    rng = np.random.default_rng(SERVE_SEED)
    sys_prompt = rng.integers(0, vocab, SYS_PROMPT // scale).astype(np.int32)
    out = []
    for i in range(2 * per_tenant):
        short = (i // 2) % 4 == 3
        if i % 2 == 0:
            n = CHAT_UNIQUE // scale - (CHAT_SHORT if short else 0)
            tail = rng.integers(0, vocab, n).astype(np.int32)
            out.append((0, np.concatenate([sys_prompt, tail])))
        else:
            n = BATCH_PROMPT // scale - (BATCH_SHORT if short else 0)
            out.append((1, rng.integers(0, vocab, n).astype(np.int32)))
    return out


class Tap:
    """Wraps ``serve.engine``'s ``prefill_with_kv`` and ``_decode_step``
    (both still run) and keeps, per call, each row's fp32 logits over the
    vocabulary: the prefill ones whole, the decode ones as greedy token and
    top-1 lead over the runner-up in max |logit| (the last call's whole)."""

    def __init__(self, engine_mod, vocab: int):
        self.mod, self.vocab = engine_mod, vocab
        self.prefill, self.leads, self.last = [], [], None

    @staticmethod
    def lead(lg):
        top = lg.topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]) / lg.abs().amax(dim=-1)

    def __enter__(self):
        self.saved = (self.mod.prefill_with_kv, self.mod._decode_step)
        pre, dec = self.saved

        def prefill_with_kv(*a, **k):
            out = pre(*a, **k)
            self.prefill.append(out[0][:, :self.vocab])
            return out

        def decode_step(*a, **k):
            out = dec(*a, **k)
            self.last = out[0][:, :self.vocab]
            self.leads.append(self.lead(self.last))
            return out
        self.mod.prefill_with_kv, self.mod._decode_step = \
            prefill_with_kv, decode_step
        return self

    def __exit__(self, *exc):
        self.mod.prefill_with_kv, self.mod._decode_step = self.saved

    def request_leads(self) -> list[list[float]]:
        """Per request (rid order), its fp32 top-1 lead at every token:
        the prefill's, then each decode step's (all requests decode in
        lockstep, row i being rid i)."""
        pre = torch.cat(self.prefill)
        steps = torch.stack([self.lead(pre)] + self.leads, 1)
        return steps.cpu().tolist()


def free_cards() -> None:
    """Release a finished engine's pool: the engine, its pool and the
    wrappers around their methods hold one another, so only the cycle
    collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_engine(cfg, params, dev, n_pages, capacity, c_min, initial,
                 window):
    """The deployment: pool, manager, tiered cache and engine; the pool's
    ``allocate`` counts the engine's page-0 fallbacks (an unmanaged,
    tenant -2, allocation that returns None)."""
    from repro_torch.cache import BlockPool, TieredKVCache
    from repro_torch.core import ECICacheManager
    from repro_torch.serve.engine import MultiTenantEngine
    pool = BlockPool(n_pages, SERVE_PAGE, cfg.n_layers, cfg.n_kv_heads,
                     cfg.head_dim, dtype=getattr(torch, cfg.dtype),
                     device=dev)
    mgr = ECICacheManager(capacity, ["chat", "batchjob"], c_min=c_min,
                          initial_blocks=initial, device=dev)
    tiered = TieredKVCache(pool, mgr, window_events=window)
    eng = MultiTenantEngine(cfg, params, tiered, page_size=SERVE_PAGE,
                            max_pages_per_seq=SERVE_MAX_PAGES)
    eng.fallbacks = 0
    alloc = pool.allocate

    def allocate(tenant, *a, **k):
        pid, evicted = alloc(tenant, *a, **k)
        eng.fallbacks += tenant == -2 and pid is None
        return pid, evicted
    pool.allocate = allocate
    return eng


def serve_run(eng, traffic, new_tokens: int) -> dict:
    """Submit the traffic and run the engine to the end, timing each
    prefill and decode step (host clock between synchronizes).  Returns
    what the runs are compared on and the times."""
    from repro_torch.serve.engine import Request
    times = {"prefill": [], "decode": []}
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))

    def timed(name, fn):
        def run(*a):
            sync()
            t0 = time.perf_counter()
            fn(*a)
            sync()
            times[name].append(time.perf_counter() - t0)
        return run
    eng._prefill_one = timed("prefill", eng._prefill_one)
    eng._decode_batch = timed("decode", eng._decode_batch)
    for tenant, prompt in traffic:
        eng.submit(Request(tenant=tenant, prompt=prompt,
                           max_new_tokens=new_tokens))
    sync()
    t0 = time.perf_counter()
    eng.run(4 * new_tokens)
    sync()
    wall = time.perf_counter() - t0
    tiered, mgr = eng.tiered, eng.tiered.manager
    summary = dict(tiered.summary())
    rebalance_s = summary.pop("rebalance_seconds")
    assert len(eng.completed) == len(traffic) and not eng.waiting
    return {
        "tokens": [r.generated for r in sorted(eng.completed,
                                               key=lambda r: r.rid)],
        "summary": summary, "pool_stats": dict(eng.pool.stats),
        "decisions": [(d.sizes.tolist(), [p.value for p in d.policies],
                       bool(d.feasible), d.sizes2.tolist(),
                       [p.value for p in d.policies2], d.guard)
                      for d in mgr.history],
        "fallbacks": eng.fallbacks, "wall": wall, "times": times,
        "rebalance_s": rebalance_s, "rebalances": len(mgr.history),
        "prompt_tokens": sum(len(p) for _, p in traffic),
        "pages_written": len(eng.pool.meta),
        "pages_unmanaged": sum(m.tenant < 0
                               for m in eng.pool.meta.values())}


def compare_serving(what: str, got: dict, want: dict) -> None:
    """Summaries (without ``rebalance_seconds``), pool stats, quotas,
    policies and decisions exactly equal: the page keys depend on the
    prompts, rids and lengths only, never on generated tokens."""
    for key in ("summary", "pool_stats", "decisions"):
        assert got[key] == want[key], f"{what}: {key} differ"


def held_tokens(kern: dict, plain: dict, ref32: dict, leads32: list,
                noise: float) -> tuple[int, int]:
    """The model phase's bf16 rule along each request's tokens: while
    the bf16 kernels run, the bf16 plain run and the fp32 plain run have
    the same history (so their logits are at the same inputs), a token
    whose fp32 top-1 lead exceeds ``noise`` (what bf16 moves the logits)
    must be the same in both bf16 runs.  Returns (tokens held, near ties
    let go)."""
    held = ties = 0
    for k, p, f, lead in zip(kern["tokens"], plain["tokens"],
                             ref32["tokens"], leads32):
        for t in range(len(p)):
            if k[:t] != p[:t] or p[:t] != f[:t]:
                break
            if lead[t] > noise:
                assert k[t] == p[t], \
                    f"bf16 token {t}: kernels {k[t]}, plain {p[t]} (fp32 " \
                    f"lead {lead[t]:.3g} > {noise:.3g})"
                held += 1
            else:
                ties += 1
    return held, ties


def serving_phase(dev, max_err: dict) -> dict:
    """Phase 13: the multi-tenant serving path, qwen3-0.6b at full width.

    (a) bf16 from seed 0 over the 14 GiB pool: the two tenants' 32
    requests through ``MultiTenantEngine.run`` (counters 0 just before,
    read just after): 32 x 28 ``flash_attention`` launches in prefill and
    31 decode steps x 28 ``paged_attention``; no page-0 fallback; prefill
    and decode times, peak memory, the rebalances and the tiered summary.
    (b) ``paged_attention`` at the captured layer-0 decode inputs against
    ``paged_attention_ref`` element by element (two bf16 steps plus 1e-4
    of max |out|), timed beside the plain version, ``_merge_self``, the
    gather + ``scaled_dot_product_attention`` reading and its bound.  (c)
    the same traffic through the plain versions on the card (neither
    kernel launched): summaries, pool stats, quotas, policies and
    decisions exactly equal; then the model in fp32 through both (tokens
    equal, last logits within 1e-4 of max |logit|) and the bf16 tokens
    held by the model phase's rule.  (d) 2 layers at full width in fp32,
    reduced traffic: the card against the port's CPU engine, exactly,
    logits within 1e-5.  Returns the kernel's row."""
    import torch.nn.functional as F

    import repro_torch.models.attention as attention
    import repro_torch.serve.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SERVE_ARCH)
    L, V = cfg.n_layers, cfg.vocab_size
    full = dict(n_pages=SERVE_POOL, capacity=SERVE_CAPACITY,
                c_min=SERVE_C_MIN, initial=SERVE_INITIAL,
                window=SERVE_WINDOW)
    traffic = serve_traffic(V)
    n_req = len(traffic)
    page_bytes = L * SERVE_PAGE * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} at full width ({L} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, qk-norm, d_ff {cfg.d_ff}, vocab {V}); "
          f"n_params() {cfg.n_params():,}, {cfg.dtype} from seed "
          f"{SERVE_SEED} in {time.perf_counter() - t0:.1f} s; pool "
          f"{SERVE_POOL} pages of {SERVE_PAGE} tokens ({page_bytes / 2**20:.2f}"
          f" MiB a page, {SERVE_POOL * page_bytes / 2**30:.2f} GiB); manager "
          f"capacity {SERVE_CAPACITY}, c_min {SERVE_C_MIN}, initial "
          f"{SERVE_INITIAL}, window {SERVE_WINDOW} events; {n_req} requests "
          f"(prompt lengths {sorted({len(p) for _, p in traffic})}), "
          f"{SERVE_NEW} new tokens each")

    # ------------------------------------ (a) the main path, bf16
    want_fa, want_pa = n_req * L, (SERVE_NEW - 1) * L
    eng = serve_engine(cfg, params, dev, **full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Tap(engine_mod, V) as tap, \
            Recorder(engine_mod, "paged_attention") as pa_rec, \
            Recorder(engine_mod, "_merge_self") as merge_rec:
        zero_counts()
        run = serve_run(eng, traffic, SERVE_NEW)
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches["flash_attention"] == want_fa and \
        launches["paged_attention"] == want_pa, \
        f"serving launches {launches}, predicted flash_attention " \
        f"{want_fa}, paged_attention {want_pa}"
    assert run["fallbacks"] == 0, f"{run['fallbacks']} page-0 fallbacks"
    assert all(len(t) == SERVE_NEW and all(0 <= x < V for x in t)
               for t in run["tokens"])
    assert bool(torch.isfinite(tap.last).all())
    pre, dec = run["times"]["prefill"], run["times"]["decode"]
    step_ms = float(np.median(dec)) * 1e3
    s = run["summary"]
    print(f"serving bf16 (kernels): {run['wall']:.2f} s; prefill "
          f"{sum(pre) * 1e3:.1f} ms for {n_req} requests (median "
          f"{np.median(pre) * 1e3:.2f} ms a request, "
          f"{run['prompt_tokens'] / sum(pre):.0f} tokens/s); decode "
          f"{len(dec)} steps at B {n_req}: median {step_ms:.2f} ms a step "
          f"(min {min(dec) * 1e3:.2f}, max {max(dec) * 1e3:.2f}; "
          f"{n_req / np.median(dec):.0f} tokens/s); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)} "
          f"(flash_attention {want_fa}, paged_attention {want_pa} "
          f"predicted); page-0 fallbacks 0")
    print(f"serving tiered summary: hbm_hit_ratio {s['hbm_hit_ratio']:.4f}, "
          f"hbm_writes {s['hbm_writes']}, bypassed_writes "
          f"{s['bypassed_writes']}, promotions {s['promotions']}, "
          f"resident_pages {s['resident_pages']}, quotas {s['quotas']}, "
          f"policies {s['policies']}; pool stats {run['pool_stats']}; "
          f"{run['rebalances']} rebalances in {run['rebalance_s']:.3f} s "
          f"({run['rebalance_s'] / max(run['rebalances'], 1) * 1e3:.1f} ms "
          f"each)")
    print(f"serving pool fill: {run['pages_written']} of {SERVE_POOL} pages "
          f"written ({run['pages_written'] / SERVE_POOL:.1%}; the rest is "
          f"allocated and never touched), {s['resident_pages']} under the "
          f"manager (capacity {SERVE_CAPACITY}), {run['pages_unmanaged']} "
          f"staged unmanaged (tenant -2, outside every quota); "
          f"{run['pool_stats']['evicted']} evictions")

    # ------------- (b) the kernel at the captured layer-0 decode inputs
    q, kp, vp, tables, lens = pa_rec.args
    got = paged_attention(q, kp, vp, tables, lens)
    want = paged_attention_ref(q, kp, vp, tables, lens)
    want32, diff = want.float(), (got.float() - want.float()).abs()
    top, typical = float(want32.abs().max()), float(want32.abs().mean())
    worst = float((diff / (2.0 ** -6 * want32.abs() + 1e-4 * top)).max())
    err = float(diff.max())
    assert got.shape == want.shape and worst <= 1.0, \
        f"paged_attention at the captured inputs: {worst} of its limit"
    max_err["paged_attention"] = max(max_err["paged_attention"], err)
    print(f"check: paged_attention == paged_attention_ref at the captured "
          f"bf16 decode inputs (q {list(q.shape)}, pages {list(kp.shape)}, "
          f"tables {list(tables.shape)}, lengths {lens.min().item()}.."
          f"{lens.max().item()}): max err {err:.3g} (max |out| {top:.3g}, "
          f"mean |out| {typical:.3g}); the worst element at {worst:.3g} of "
          f"its limit 2^-6 |out| + 1e-4 max |out|")
    ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, lens), REPS)
    plain_ms = cuda_ms(lambda: paged_attention_ref(q, kp, vp, tables, lens),
                       REPS // 4)
    margs = merge_rec.args
    merge_ms = cuda_ms(lambda: engine_mod._merge_self(*margs), REPS // 4)
    b, hq, d = q.shape
    seq = torch.arange(tables.shape[1] * SERVE_PAGE, device=q.device)
    mask = (seq[None, :] < lens[:, None])[:, None, None, :]

    def gather_sdpa():
        k = gather_pages(kp, tables).transpose(1, 2)
        v = gather_pages(vp, tables).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask, enable_gqa=True)
    lib_err = float((gather_sdpa()[:, :, 0].float() - want32).abs().max())
    lib_ms = cuda_ms(gather_sdpa, REPS)
    seen = int(lens.clamp(max=tables.shape[1] * SERVE_PAGE).sum())
    esize = q.element_size()
    nbytes = (seen * cfg.n_kv_heads * d * 2 * esize + 2 * q.numel() * esize
              + 4 * (tables.numel() + lens.numel()))
    flops = 4 * hq * d * seen
    bnd, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                  (flops / PEAK_BF16_PER_S * 1e3, "operations"))
    print(f"paged_attention at the decode shape (B {b}, {seen} positions "
          f"seen): {ms:.4f} ms, paged_attention_ref {plain_ms:.3f} ms, "
          f"_merge_self {merge_ms:.3f} ms; a reading: gather + "
          f"scaled_dot_product_attention (two calls) {lib_ms:.3f} ms (max "
          f"diff {lib_err:.3g}); {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP: bound {bnd:.4f} ms by {by}; kernel / bound = "
          f"{ms / bnd:.1f}; of a {step_ms:.2f} ms decode step, {L} kernel "
          f"launches are {L * ms / step_ms:.1%} and {L} _merge_self "
          f"{L * merge_ms / step_ms:.1%}")
    row = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/paged_attention/csrc/"
                     "paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:76",
           "launches": launches["paged_attention"], "max_abs_err": None,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "library_ms": None}
    del eng, q, kp, vp, tables, lens, margs, got, want, want32, diff, mask
    pa_rec.args = merge_rec.args = None
    free_cards()

    # ---- (c) the plain versions on the card; the model in fp32 as well
    def plain(prm, c):
        """The same traffic with ``paged_attention_ref`` and
        ``blockwise_attention`` in the kernels' places (swapped here only;
        the port has no switch): no launch of either kernel."""
        saved = (engine_mod.paged_attention, attention.prefill_attention)
        engine_mod.paged_attention = paged_attention_ref
        attention.prefill_attention = blockwise_attention
        try:
            with Tap(engine_mod, V) as t:
                zero_counts()
                out = serve_run(serve_engine(c, prm, dev, **full), traffic,
                                SERVE_NEW)
                got = read_counts()
            # the manager's monitor still counts on cache_sim_scan
            assert got["flash_attention"] == got["paged_attention"] == 0, \
                f"the plain run launched {got}"
        finally:
            engine_mod.paged_attention, attention.prefill_attention = saved
        free_cards()
        return out, t

    plain16, ptap16 = plain(params, cfg)
    compare_serving("bf16 plain vs kernels", plain16, run)
    del params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init_params(cfg32, seed=SERVE_SEED, device=dev)
    with Tap(engine_mod, V) as ktap32:
        kern32 = serve_run(serve_engine(cfg32, params32, dev, **full),
                           traffic, SERVE_NEW)
    free_cards()
    plain32, ptap32 = plain(params32, cfg32)
    del params32
    compare_serving("fp32 kernels vs bf16 kernels", kern32, run)
    compare_serving("fp32 plain vs fp32 kernels", plain32, kern32)
    rel32 = _rel(ktap32.last, ptap32.last)
    assert kern32["tokens"] == plain32["tokens"], "fp32 tokens differ"
    # fp32: only the order of the sums differs (TF32 off)
    assert rel32 <= 1e-4, f"fp32 kernels vs plain last logits: {rel32}"
    noise = _rel(torch.cat(ptap16.prefill), torch.cat(ptap32.prefill))
    held, ties = held_tokens(run, plain16, plain32,
                             ptap32.request_leads(), noise)
    same16 = sum(a == b for a, b in zip(run["tokens"], plain16["tokens"]))
    print(f"check: serving, kernels vs plain versions on the card over all "
          f"{n_req} requests (fp32 run: all {n_req} too): summaries, pool "
          f"stats, quotas, policies and decisions equal in bf16 and fp32; "
          f"fp32 tokens equal, last logits within {rel32:.3g} of max |logit| "
          f"(tolerance 1e-4); bf16: {held} tokens held, {ties} near ties "
          f"let go (fp32 lead <= {noise:.3g} of max |logit|, what bf16 moves "
          f"the prefill logits), {same16} of {n_req} requests' tokens "
          f"identical; bf16 plain {plain16['wall']:.2f} s, fp32 kernels "
          f"{kern32['wall']:.2f} s, fp32 plain {plain32['wall']:.2f} s")

    # ------------- (d) reduced depth, full width, fp32: card vs CPU
    rcfg = dataclasses.replace(cfg, n_layers=SERVE_REDUCED_LAYERS,
                               dtype="float32")
    rp = M.init_params(rcfg, seed=SERVE_SEED, device=dev)
    small = serve_traffic(V, scale=SERVE_REDUCED_SCALE,
                          per_tenant=SERVE_PER_TENANT // SERVE_REDUCED_SCALE)
    out = {}
    for where, prm in ((dev, rp), (torch.device("cpu"), _to(rp, "cpu"))):
        t0 = time.perf_counter()
        with Tap(engine_mod, V) as t:
            zero_counts()
            r = serve_run(serve_engine(rcfg, prm, where, **SERVE_REDUCED),
                          small, SERVE_REDUCED_NEW)
            got = read_counts()
        out[where.type] = (r, t, got, time.perf_counter() - t0)
    (g, gt, glaunch, gs), (c, ct, _, cs) = out[dev.type], out["cpu"]
    assert (glaunch["flash_attention"], glaunch["paged_attention"]) == (
        len(small) * SERVE_REDUCED_LAYERS,
        (SERVE_REDUCED_NEW - 1) * SERVE_REDUCED_LAYERS), glaunch
    compare_serving("reduced depth card vs CPU", g, c)
    assert g["tokens"] == c["tokens"], "reduced depth: tokens differ"
    assert g["rebalances"] >= 2, g["rebalances"]
    rel_pre = _rel(torch.cat(gt.prefill).cpu(), torch.cat(ct.prefill))
    rel_dec = _rel(gt.last.cpu(), ct.last)
    # fp32 on both sides, TF32 off: only the order of the sums differs
    assert rel_pre <= 1e-5 and rel_dec <= 1e-5, (rel_pre, rel_dec)
    print(f"check: reduced depth ({SERVE_REDUCED_LAYERS} layers, full width, "
          f"fp32; {len(small)} requests of {sorted({len(p) for _, p in small})}"
          f" tokens, {SERVE_REDUCED_NEW} new each; {g['rebalances']} "
          f"rebalances) card ({gs:.1f} s) vs CPU ({cs:.1f} s): tokens, "
          f"summaries, pool stats and decisions equal; prefill logits within "
          f"{rel_pre:.3g}, last decode logits within {rel_dec:.3g} of max "
          f"|logit| (tolerance 1e-5)")
    row["max_abs_err"] = max_err["paged_attention"]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.batch_sim as bs
    from repro_torch.core.batch_sim import (padded_segment_layout,
                                            padded_tape_links, segment_links)
    from repro_torch.core.monitor import shards_subtape
    from repro_torch.core.reuse_distance import auto_sample_rate
    from repro_torch.kernels import build_library
    from repro_torch.core.trace import prev_next_occurrence
    from repro_torch.data.traces import msr_trace
    from repro_torch.kernels.cache_sim.kernel import (LIBRARIES,
                                                      cache_sim_levels_scan,
                                                      cache_sim_scan,
                                                      cache_sim_segments_scan,
                                                      live_count_scan)
    from repro_torch.kernels.cache_sim.ops import width_groups_of
    from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                                   cache_sim_ref,
                                                   cache_sim_segments_ref,
                                                   cache_sim_segments_tree,
                                                   live_counts_delta,
                                                   live_counts_ref,
                                                   stack_distances_tree)
    from repro_torch.kernels.flash_attention.kernel import \
        LIBRARIES as FA_LIBRARIES
    from repro_torch.kernels.mamba2_ssd.kernel import \
        LIBRARIES as SSD_LIBRARIES
    from repro_torch.kernels.paged_attention.kernel import \
        LIBRARIES as PA_LIBRARIES
    from repro_torch.kernels.urd_scan.kernel import LIBRARIES as URD_LIBRARIES
    from repro_torch.kernels.urd_scan.kernel import urd_scan
    from repro_torch.kernels.urd_scan.ref import urd_scan_ref

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(host_line())

    # ----------------------------------------- 2. build, one nvcc a source
    t0 = time.perf_counter()
    libraries = (LIBRARIES + URD_LIBRARIES + SSD_LIBRARIES + FA_LIBRARIES
                 + PA_LIBRARIES)
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as ex:
        builds = {name: ex.submit(build_library, name, srcs)
                  for name, srcs in libraries}
        built = {name: f.result() for name, f in builds.items()}
    print(f"build: {', '.join(lib.name for lib, _ in built.values())} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ------------------------------------- 3. kernels vs plain, small tapes
    max_err = dict.fromkeys(KERNEL_NAMES, 0)

    def check(name: str, what: str, got, want) -> None:
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        assert err == 0, f"{name} {what}: max err {err}"
        max_err[name] = max(max_err[name], err)

    for n in (1, 255, 256, 257, 4097, 32768):
        prev, nxt, reads = tape_links(n, seed=n, device=dev)
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        for tag, occ in (("occ=1", torch.ones_like(p32)),
                         ("occ=is_read", reads.to(torch.int32))):
            got = cache_sim_scan(p32, n32, occ)
            check("cache_sim_scan", f"n={n} {tag}", got,
                  cache_sim_ref(p32, n32, occ))
            assert bool((got[prev < 0] == -1).all()), "cold rows must be -1"
        print(f"check: cache_sim_scan == cache_sim_ref at n={n} "
              f"(occ=1, occ=is_read; {int((prev < 0).sum())} cold rows)")
    for w, lens in SEGMENT_LENS.items():
        gprev, gnxt, gocc, reads, groups = padded_tape(lens, w, dev)
        for gw, lo, hi in groups:
            p32, n32, occ1 = padded_group_links(gprev, gnxt, gocc, gw, lo, hi)
            for tag, occ in (("occ=1", occ1),
                             ("occ=is_read", reads[lo:hi].contiguous())):
                got = cache_sim_segments_scan(p32, n32, occ, gw)
                check("cache_sim_segments_scan", f"w={gw} {tag}", got,
                      cache_sim_segments_ref(p32, n32, occ, gw))
                assert bool((got[p32 < 0] == -1).all()), \
                    "cold and pad rows must be -1"
        print(f"check: cache_sim_segments_scan == cache_sim_segments_ref on "
              f"segments {lens} (widths {[g[0] for g in groups]}; occ=1, "
              f"occ=is_read)")
    for n in (1, 255, 4097, 65536):
        prev, nxt, reads = tape_links(n, seed=n + 7, device=dev)
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        rng = np.random.default_rng(n)
        c1 = rng.integers(0, 64, n)
        ct = c1 + rng.integers(0, 64, n)
        c1[: n // 4] = 0                                 # cap1 = 0
        ct[n // 4: n // 2] = c1[n // 4: n // 2]          # cap1 = captot
        cap1 = torch.as_tensor(c1, dtype=torch.int32, device=dev)
        captot = torch.as_tensor(ct, dtype=torch.int32, device=dev)
        for tag, occ in (("occ=1", torch.ones_like(p32)),
                         ("occ=is_read", reads.to(torch.int32))):
            got = cache_sim_levels_scan(p32, n32, occ, cap1, captot)
            want = cache_sim_levels_ref(p32, n32, occ, cap1, captot)
            check("cache_sim_levels_scan", f"n={n} {tag} l1", got[0],
                  want[0])
            check("cache_sim_levels_scan", f"n={n} {tag} union", got[1],
                  want[1])
        # live counts: the tape's links plus rows with nxt = -1, nxt = j
        # and nxt = n, which never / always stay live
        pick = torch.as_tensor(rng.integers(0, 5, n), device=dev)
        pos = torch.arange(n, device=dev)
        nl = torch.where(pick == 0, -1, torch.where(
            pick == 1, pos, torch.where(pick == 2, n, nxt))).to(torch.int32)
        for tag, occ in (("occ=is_read", reads.to(torch.int32)),
                         ("occ=1", torch.ones_like(nl))):
            got = live_count_scan(nl, occ)
            check("live_count_scan", f"n={n} {tag} vs dense", got,
                  live_counts_ref(nl, occ))
            check("live_count_scan", f"n={n} {tag} vs delta", got,
                  live_counts_delta(nl, occ))
        print(f"check: cache_sim_levels_scan == cache_sim_levels_ref and "
              f"live_count_scan == live_counts_ref == live_counts_delta at "
              f"n={n} (cap1 = 0, cap1 = captot and varying rows; occ=1, "
              f"occ=is_read; nxt = -1, j, n rows)")
    for n in (1, 255, 4097, 32768, 65536):
        prev, nxt, _ = tape_links(n, seed=n + 11, device=dev)
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        got = urd_scan(p32, n32)
        check("urd_scan", f"n={n}", got, urd_scan_ref(p32, n32))
        assert bool((got[prev < 0] == -1).all()), "cold rows must be -1"
        print(f"check: urd_scan == urd_scan_ref at n={n} (ragged tenant "
              f"blocks, severed links; {int((prev < 0).sum())} cold rows)")
    model_kernel_checks(dev, max_err)
    paged_kernel_checks(dev, max_err)
    print(f"phase seconds: build and kernel checks done at "
          f"{time.perf_counter() - T_START:.1f} s")

    # --------------------------------------------- 4. slice 1's main path
    t0 = time.perf_counter()
    windows = make_windows(MSR_16, WINDOWS)
    print(f"traces: {WINDOWS} windows x {len(MSR_16)} tenants x "
          f"{ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    launches16, _, _ = drive("16-tenant", dev, windows, MSR_16, 6000)

    # ------------------------------------------------ 5. the SHARDS path
    t0 = time.perf_counter()
    swindows = make_windows([nm.split("#")[0] for nm in SHARDS_NAMES],
                            SHARDS_WINDOWS)
    print(f"traces: {SHARDS_WINDOWS} windows x {len(SHARDS_NAMES)} tenants "
          f"x {ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    launches256, _, _ = drive("256-tenant", dev, swindows, SHARDS_NAMES,
                              SHARDS_CAPACITY,
                              want=("cache_sim_segments_scan",),
                              cpu_budget=True)

    # ------------------------- 6. the ETICA path, with its residency routes
    routes = RouteReplays(dev)
    launches_et, _, (cpu_et, crec_et) = drive(
        "ETICA", dev, windows, MSR_16, ETICA_CAP1, scheme="etica",
        before_window=routes, capacity2=ETICA_CAP2, t_fast2=T_FAST2)
    print(f"ETICA residency routes: cache_sim_levels_scan launches "
          f"{routes.launches['cache_sim_levels_scan']} over "
          f"{len(routes.walls)} windows (counters 0 just before each "
          f"replay, read just after); live_count_scan launches there "
          f"{routes.launches['live_count_scan']}")
    assert routes.launches["cache_sim_levels_scan"] == WINDOWS
    t0 = time.perf_counter()
    lru, lrec = run_windows("cpu", windows[:1], MSR_16, ETICA_CAP1,
                            scheme="etica", engine="lru",
                            capacity2=ETICA_CAP2, t_fast2=T_FAST2)
    dl, dc = lru.history[0], cpu_et.history[0]
    assert dl.sizes.tolist() == dc.sizes.tolist() and \
        dl.sizes2.tolist() == dc.sizes2.tolist(), "lru engine: sizes"
    assert dl.policies == dc.policies and dl.policies2 == dc.policies2
    compare_counts(0, lrec["counts"][0], crec_et["counts"][0], rel=1e-9)
    compare_states("lru engine, window 0", lrec["states"][0],
                   crec_et["states"][0])
    print(f"check: ETICA window 0 through engine=\"lru\" on the host "
          f"({time.perf_counter() - t0:.1f} s) == the batch engine (sizes, "
          f"policies per level, counts, both levels' states; the "
          f"interpreter's per-access latency sums to rel 1e-9)")

    # --------------------------------------- 7. the ETICA pressure path
    with Recorder(bs, "_ro_token_replay_levels") as tok, \
            Recorder(bs, "ro_live_counts") as live_rec:
        launches_pr, (gpu_pr, _), _ = drive(
            "pressure", dev, windows[:PRESSURE_WINDOWS], MSR_16,
            PRESSURE_CAP1, scheme="etica", capacity2=PRESSURE_CAP2,
            t_fast2=T_FAST2, w_threshold=0.0)
    print(f"pressure: tenant-windows through _ro_token_replay_levels on "
          f"the card: {tok.by_device['cuda']} (CPU run: "
          f"{tok.by_device['cpu']}); live_count_scan launches on the card "
          f"path (L and U2): {launches_pr['live_count_scan']}; "
          f"ro_fallback_windows {gpu_pr.summary()['ro_fallback_windows']}")
    assert tok.by_device["cuda"] >= 1, \
        "no tenant-window took the two-level token replay"
    assert gpu_pr.summary()["ro_fallback_windows"] == 0
    assert launches_pr["live_count_scan"] > 0
    assert all(t.policy.value == "ro" for t in gpu_pr.tenants)
    for name, launches in (("16-tenant", launches16),
                           ("256-tenant", launches256),
                           ("ETICA", launches_et)):
        print(f"live_count_scan launches on the {name} path: "
              f"{launches['live_count_scan']}")
    print(f"phase seconds: slices 1-3 paths done at "
          f"{time.perf_counter() - T_START:.1f} s")

    # --------------------------------- 8. the Table-3 Analyzer (urd_scan)
    t0 = time.perf_counter()
    launches_t3 = table3_phase(dev)
    print(f"phase seconds: Table-3 Analyzer {time.perf_counter() - t0:.1f} s")

    # ------------------------- 9. the thousand-tenant control plane
    t0 = time.perf_counter()
    launches_cp = control_plane_phase(dev)
    print(f"phase seconds: control plane {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 10. the remaining schemes
    t0 = time.perf_counter()
    drive("static", dev, windows, MSR_16, 6000, scheme="static")
    launches_ri, (gpu_ri, _), _ = drive(
        "reuse_intensity", dev, windows, MSR_16, 6000,
        want=("live_count_scan",), scheme="reuse_intensity")
    assert all(t.policy.value == "ro" for t in gpu_ri.tenants)
    print(f"reuse_intensity: live_count_scan launches "
          f"{launches_ri['live_count_scan']} in {WINDOWS} windows")
    global_lru_phase(dev, windows)
    print(f"phase seconds: schemes {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 11. the scenarios
    t0 = time.perf_counter()
    launches_sc = scenarios_phase(dev)
    print(f"phase seconds: scenarios {time.perf_counter() - t0:.1f} s")

    # ------------------------------------ 12. the model layer, zamba2-7b
    t0 = time.perf_counter()
    model_rows = model_phase(dev, max_err)
    print(f"phase seconds: model layer {time.perf_counter() - t0:.1f} s")

    # ---------------------------- 13. the serving path, qwen3-0.6b
    t0 = time.perf_counter()
    serve_row = serving_phase(dev, max_err)
    print(f"phase seconds: serving {time.perf_counter() - t0:.1f} s")

    # ------------- 14a. full window tape: cache_sim_scan vs its merge tree
    tr0 = windows[0]
    addrs = torch.cat([t.addrs for t in tr0]).to(dev)
    lens = torch.tensor([len(t) for t in tr0], device=dev)
    tid = torch.repeat_interleave(torch.arange(len(tr0), device=dev), lens)
    prev, nxt_c, _, _ = segment_links(addrs, tid,
                                      torch.cumsum(lens, 0)[tid])
    p32, n32 = prev.to(torch.int32), nxt_c.to(torch.int32)
    ones = torch.ones_like(p32)
    got = cache_sim_scan(p32, n32, ones)
    check("cache_sim_scan", "full tape vs merge tree", got,
          stack_distances_tree(prev, nxt_c))
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
        "max_abs_err": max_err["cache_sim_scan"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": None}]

    # ---- 14b. urd_scan at the same 16-tenant tape and at a Table-3 window
    got = urd_scan(p32, n32)
    check("urd_scan", "full tape vs merge tree", got,
          stack_distances_tree(prev, nxt_c))
    urd_ms = cuda_ms(lambda: urd_scan(p32, n32), REPS)
    urd_plain = cuda_ms(lambda: stack_distances_tree(prev, nxt_c), REPS // 4)
    m = int(prev.shape[0])
    # the function's floor: read prev and nxt and write RD once (12 n
    # bytes); a Fenwick-tree count's n * ceil(log2 n) operations
    urd_bnd, urd_by = bound_ms(12 * m, m * math.ceil(math.log2(max(m, 2))))
    print(f"full tape: {m} accesses; urd_scan {urd_ms:.3f} ms, merge-tree "
          f"route {urd_plain:.3f} ms, bound {urd_bnd:.6f} ms by {urd_by}; "
          f"kernel / bound = {urd_ms / urd_bnd:.1f}")
    t3 = msr_trace(TABLE3[0], ACCESSES, seed=3)
    prev3, nxt3 = prev_next_occurrence(t3.addrs.to(dev))
    p3, n3 = prev3.to(torch.int32), nxt3.to(torch.int32)
    check("urd_scan", "Table-3 window vs merge tree", urd_scan(p3, n3),
          stack_distances_tree(prev3, nxt3))
    t3_ms = cuda_ms(lambda: urd_scan(p3, n3), REPS)
    t3_plain = cuda_ms(lambda: stack_distances_tree(prev3, nxt3), REPS // 4)
    m3 = int(prev3.shape[0])
    t3_bnd, t3_by = bound_ms(12 * m3, m3 * math.ceil(math.log2(m3)))
    print(f"Table-3 window ({TABLE3[0]}): {m3} accesses; urd_scan "
          f"{t3_ms:.4f} ms, merge-tree route {t3_plain:.3f} ms, bound "
          f"{t3_bnd:.6f} ms by {t3_by}; kernel / bound = "
          f"{t3_ms / t3_bnd:.1f}")
    urd_row = {
        "name": "urd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/urd_scan/csrc/urd_scan.cu",
        "replaces": "src/repro/kernels/urd_scan/kernel.py:62",
        "launches": launches_t3["urd_scan"] + launches_cp["urd_scan"],
        "max_abs_err": max_err["urd_scan"],
        "ms": urd_ms, "plain_ms": urd_plain, "bound_ms": urd_bnd,
        "bound_by": urd_by, "library_ms": None}
    print(f"urd_scan launches on its paths: Table-3 Analyzer "
          f"{launches_t3['urd_scan']}, control-plane seed row "
          f"{launches_cp['urd_scan']}; on the scenario path "
          f"{launches_sc['urd_scan']}")

    # ---- 14c. full sampled tape: cache_sim_segments_scan vs its tree
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
    for (a, w) in args:
        check("cache_sim_segments_scan", f"sampled tape w={w} vs tree",
              cache_sim_segments_scan(*a, w), cache_sim_segments_tree(*a, w))
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
        "max_abs_err": max_err["cache_sim_segments_scan"],
        "ms": seg_ms, "plain_ms": seg_plain, "bound_ms": bnd,
        "bound_by": bnd_by, "library_ms": None})
    del swindows, args, gprev, gnxt, gocc

    # ---- 14d. the last ETICA window's tape: cache_sim_levels_scan vs the
    # merge tree's distances compared with the two thresholds
    prev, nxt_c, cap1_of, captot_of = routes.args[:4]
    p32, n32 = prev.to(torch.int32), nxt_c.to(torch.int32)
    c132, ct32 = cap1_of.to(torch.int32), captot_of.to(torch.int32)
    ones = torch.ones_like(p32)

    def levels_plain():
        sd = stack_distances_tree(prev, nxt_c)
        return ((sd >= 0) & (sd < cap1_of), (sd >= 0) & (sd < captot_of))

    got = cache_sim_levels_scan(p32, n32, ones, c132, ct32)
    want = levels_plain()
    for g, wnt, tag in zip(got, want, ("l1", "union")):
        check("cache_sim_levels_scan", f"ETICA tape {tag} vs merge tree",
              g, wnt)
    m = int(prev.shape[0])
    hot = prev >= 0
    lv_ms = cuda_ms(lambda: cache_sim_levels_scan(p32, n32, ones, c132,
                                                  ct32), REPS)
    lv_plain = cuda_ms(levels_plain, REPS // 4)
    # the function's floor: read prev, nxt, occ, cap1, captot and write
    # both masks once (28 n bytes); a Fenwick count's n * ceil(log2 n)
    bnd, bnd_by = bound_ms(28 * m, m * math.ceil(math.log2(max(m, 2))))
    print(f"ETICA tape (window {WINDOWS - 1}, warm prefixes included): {m} "
          f"accesses, {int(hot.sum())} hot; cache_sim_levels_scan "
          f"{lv_ms:.3f} ms, merge tree + compares {lv_plain:.3f} ms, bound "
          f"{bnd:.6f} ms by {bnd_by}; kernel / bound = {lv_ms / bnd:.1f}")
    rows.append({
        "name": "cache_sim_levels_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/"
                  "cache_sim_levels.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:294",
        "launches": routes.launches["cache_sim_levels_scan"],
        "max_abs_err": max_err["cache_sim_levels_scan"],
        "ms": lv_ms, "plain_ms": lv_plain, "bound_ms": bnd,
        "bound_by": bnd_by, "library_ms": None})

    # ---- 14e. the pressure path's first guard tape: live_count_scan vs
    # the O(n) delta form
    nxt_l, occ_l = live_rec.args
    n32 = nxt_l.to(torch.int32).contiguous()
    o32 = occ_l.to(torch.int32).contiguous()
    check("live_count_scan", "pressure tape vs delta",
          live_count_scan(n32, o32), live_counts_delta(nxt_l, occ_l))
    m = int(n32.shape[0])
    lc_ms = cuda_ms(lambda: live_count_scan(n32, o32), REPS)
    lc_plain = cuda_ms(lambda: live_counts_delta(nxt_l, occ_l), REPS)
    # the function's floor: nxt and occ read, L written once (12 n
    # bytes); a prefix sum's n additions
    bnd, bnd_by = bound_ms(12 * m, m)
    print(f"pressure guard tape: {m} accesses; live_count_scan "
          f"{lc_ms:.3f} ms, delta form {lc_plain:.3f} ms, bound "
          f"{bnd:.6f} ms by {bnd_by}; kernel / bound = {lc_ms / bnd:.1f}")
    live_total = sum(x["live_count_scan"] for x in
                     (launches16, launches256, launches_et, launches_pr,
                      launches_ri))
    rows.append({
        "name": "live_count_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/live_count.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:220",
        "launches": live_total,
        "max_abs_err": max_err["live_count_scan"],
        "ms": lc_ms, "plain_ms": lc_plain, "bound_ms": bnd,
        "bound_by": bnd_by, "library_ms": None})
    rows.append(urd_row)
    rows.extend(model_rows)
    rows.append(serve_row)
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
