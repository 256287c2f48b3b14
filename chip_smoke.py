#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build the ten CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
     one ``nvcc`` per source, all started together (``cache_sim_scan``,
     ``cache_sim_levels_scan`` and ``urd_scan`` include the shared tiled
     count ``cache_sim/csrc/tiled_count.cuh``, hashed with them);
  3. hold each kernel against its plain PyTorch version on the card,
     exactly: ``cache_sim_scan`` vs the dense ``cache_sim_ref`` at tape
     lengths 1 .. 32768 (multi-tenant severed links, cold rows,
     ``occ = 1`` and ``occ = is_read``; tile edges at 255, 256, 257);
     ``cache_sim_segments_scan`` vs
     the dense ``cache_sim_segments_ref`` on padded multi-tenant tapes of
     widths 64 .. 16384 (the widest block held in shared memory), and vs
     its block-local tiled decomposition ``cache_sim_segments_tiled_ref``
     on width groups of 64, 640, 4096, 16383, 16384, 16385 and 32768
     (either side of the shared-memory / global boundary) with links that
     cross a block and prev at or past the row;
     ``cache_sim_levels_scan`` vs ``cache_sim_levels_ref`` and
     ``live_count_scan`` vs ``live_counts_ref`` and ``live_counts_delta``
     at n = 1 .. 65,536 (ragged tenant blocks; cap1 = 0, cap1 = captot
     and varying rows; rows with nxt = -1, j and n), and vs
     ``live_counts_onepass_ref`` at a tile +- 1 .. 2^20 rows with 1,500
     deaths on one word and deaths anywhere; both kernels the same bits
     from call to call, and for two tapes in turn; ``urd_scan`` vs the
     dense ``urd_scan_ref`` at n = 1 .. 65,536 (ragged tenant blocks,
     severed links, cold rows); ``urd_scan`` and ``cache_sim_levels_scan``
     vs the dense definitions and the tiled decompositions
     (``cache_sim_tiled_ref`` with occ = 1, ``cache_sim_levels_tiled_ref``)
     at n = 1, 255, 256, 257, 4097 and 65,536 on tapes with intervals
     that start and end on tile edges and, at 65,536, cross more than 16
     whole tiles, links severed per tenant, and capacities of every kind
     (cap1 > captot, cap1 = 0, captot = 0); ``flash_attention`` vs the dense
     ``attention_ref`` at the kernel's ``ref.SWEEP`` (tests/test_kernels.py's
     sweep plus head dim 112, GQA 16/8, ragged ``Sq != Skv``,
     ``window=96`` and ``Dv != D``), float32 (2e-5) and bfloat16 (2e-2);
     ``mamba2_ssd`` vs the sequential ``mamba2_ssd_ref`` at
     tests/test_kernels.py's sweep and vs the chunked form at its
     ``ref.SWEEP`` (zamba2's chunk 256 with B/C shared by 112 heads
     included; 3e-6 of the largest output), and each of its three passes
     (``chunk_state``, ``state_pass``, ``chunk_scan``) vs its plain
     version there; ``paged_attention`` vs
     ``paged_attention_ref`` at its ``ref.SWEEP`` (tests/test_kernels.py's
     sweep plus qwen3's 16/8 heads of 128 at page 8, 16 and 32; random
     tables, lengths 1, mid-page and on a page edge) and ``ref.LONG_ROWS``
     (B 1 and 4, about 2048 positions, a row of length 0 that must be 0),
     float32 (2e-5) and bfloat16 (2e-2), and equal bit for bit from
     call to call (the splits merge in a fixed order);
     ``ro_token_replay_scan`` and ``ro_token_replay_levels_scan`` vs
     their plain versions (the host loops over the blocks) on pressured
     multi-block tapes (one-row blocks, capacity 0, warm-L2 rows below
     ``l2_end``, a clean L2) and on the edge tapes of their ring design
     (``ref.EDGE_CASES``: blocks of 65,536 and 66,175 rows at capacities
     in the thousands, victim pointers thousands of rows behind t,
     warm-L2 prefixes ending either side of a ring tile's edge, 170
     blocks, a read-hit chain across a whole block), exactly, the same
     bits call to call;
  4. drive slice 1's path — ``make_manager("eci", 6000, ...)`` over 16
     tenants, three Δt windows of 65,536 accesses each — on the card with
     every kernel launch counter set to 0 just before each window and
     read just after; then run the same windows through the port on the
     CPU and require equal sizes, policies, feasibility, per-tenant
     counts, final LRU states, summaries, and latencies to rel 1e-12; in
     every path of phases 4-7 and 10 the RO replay kernels launch once
     per kind in each window whose CPU replay took that kind's host token
     loop (and never otherwise), every call of theirs on the path is held
     to its plain version on the same blocks and timed, and each window's
     ``ro_replay`` stage is printed beside PERF.md section 5's; then the
     same windows through ``pipeline="device"`` on the card, decisions,
     event logs, per-tenant counts and LRU states equal to the host
     pipeline's run; then through ``pipeline="sharded"`` on 8 logical
     shards of the card (the script's stand-in for ``control_plane_mesh``;
     every shard launching ``cache_sim_segments_scan``), all of it equal to
     the ``pipeline="device"`` run;
  5. drive the SHARDS path — ``make_manager("eci", 96000, ...)`` over 256
     tenants (the 16 MSR profiles x 16), two windows of 65,536 accesses
     per tenant, which the manager monitors sampled by itself (rate
     1/16) — the same way, every window launching
     ``cache_sim_segments_scan``; then the same windows on the CPU
     (window 1 only while the run is inside its time budget; a cut is
     printed), compared as in phase 4, sample rates included; then
     window 0 through ``pipeline="device"`` (the sampled branch), equal to
     the host pipeline's window 0;
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
     the CPU; allocations, feasibility and hit ratios equal; then
     ``DeviceWindowPipeline(transfer_sanitize=True)`` on the same window
     from the host (one sync a window): curves and hit ratios bit for bit
     and sizes equal to the fused row and the heap walk, latency to rel
     1e-12, timed beside the fused row, its ``cache_sim_segments_scan``
     launches counted; ``run_stream`` over windows of seeds 7, 8, an empty
     one and 9, equal to ``run``; ``greedy_allocate(method="device")`` on
     the fused curves against the heap walk; and the pipeline on the card
     against the CPU at ``synthetic_mix(32, 1000, seed=11)``, bit for bit;
     then ``DeviceWindowPipeline(mesh=)`` on 1, 2 and 8 logical shards of
     the card under ``transfer_sanitize=True``, timed in turns with the
     single-device pipeline: every output bit for bit with it (latency to
     rel 1e-12), sizes and hit ratios with the heap walk, one sync a
     window, ``cache_sim_segments_scan`` launched once a width group on
     every shard (counted); ``run_stream`` over the 8-shard mesh against
     the single-device pipeline's windows; and each mesh on the card
     against the same mesh on the CPU and the card's single-device
     pipeline at ``synthetic_mix(32, 1000, seed=11)``;
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
 11b. fault injection and the degradation ladder (``fault_phase``): (a)
     slice 1's deployment under ``pipeline="device"``,
     ``demote_cooldown=2`` and ``FaultPlan.standard(16, 8, seed=0)`` plus
     an in-rung device retry at window 2 and a dead device rung at window
     5 (where the standard plan's host spec also kills the host rung, so
     the window ends on the per-tenant rung), eight windows of 65,536
     accesses a tenant on the card (launches counted a window, as in
     phase 4), held to the same plan on the CPU under ``pipeline="host"``:
     decisions (sizes, policies, feasibility, quarantined, degraded, held,
     deferred), per-tenant counts, LRU states with their dirty bits,
     latencies to rel 1e-12, summaries and event logs equal apart from the
     card's one device step-down; the fingerprints (dirty loss, poisoned
     and straggler windows, the tier failure, both step-downs) positive,
     no violation actuated; each window's wall time, the per-tenant
     rung's window beside a device-rung window; (b)
     ``benchmarks/bench_faults.py``'s settings (capacity 8192, ``c_min``
     256, ``demote_cooldown`` 2, 4 tenants of 2,500 accesses, seed 0):
     the three ``FAULT_SCENARIOS`` through ``replay_scenario``, each with
     its fingerprint, ``FaultPlan.standard(4, 8)`` reconverging to the
     fault-free run within ``K = demote_cooldown + 2`` windows of the last
     fault, and the disabled plan bit-identical to no plan, each card
     equal to CPU in every decision and summary; (d) slice 1's deployment
     for 3 windows under ``pipeline="sharded"`` over the default mesh
     (every card) with a dead sharded rung at window 1, against the same
     plan under ``pipeline="device"`` on the card: decisions, latencies,
     per-tenant counts, LRU states, events and summaries equal but the
     one sharded step-down;
 12. the model layer, zamba2-7b at full width (``model_phase``): bf16
     from seed 0, ``prefill`` on 4 prompts of 2048 tokens (81
     ``mamba2_ssd`` and 13 ``flash_attention`` launches, counted), then 4
     requests of 64 prompt tokens teacher-forced through
     ``decode_step`` and 32 greedy tokens (no launch; the prompt was
     1024 tokens until the serving phase took its time, 128 until phases
     13b-d took theirs); the same prefill
     through the plain versions on the card, and in fp32 through both:
     the fp32 last logits held to the kernels' run, the bf16 ones' greedy
     tokens where bf16 cannot flip them; the kernels held to their plain
     versions at the captured bf16 prefill inputs; at reduced depth in fp32
     (3 layers, one group and a one-layer tail), prefill against
     teacher-forced decode over 512 tokens and the card against the CPU;
     each kernel timed at its full-width prefill shape beside its plain
     version, its bound and its time before the redesign; attention on
     the model's own ``[B, H, S, D]`` views, beside the layout copies
     those views save and ``scaled_dot_product_attention`` called for
     the same function (``is_causal`` as the config, ``enable_gqa`` where
     the KV heads are fewer, none when a window is set);
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
     the kernel at the captured decode inputs (the in-flight token folded
     in, as the engine calls it, and without) element by element, timed
     beside ``paged_attention_ref``, itself without the fold, the
     composition the fold replaced (the kernel, then ``regather_merge``:
     a regather of every page in fp32) and its bound, a call and the
     kernels alone (a CUDA graph of the calls), with its split count, and
     at the first 1 and 4 captured rows;
     ``flash_attention`` at the captured prefill inputs the same way as in
     phase 12, and its share of a request's prefill; 2 layers at full
     width in fp32, the card against the CPU, then the same with the pool
     crashing after the first step (``fail_tier(1)``; two steps with the
     tier down, ``recover_tier(1)``, then to the end): tokens,
     ``aborted_restarts``, summaries (the failure counters too) and
     decisions equal card and CPU, the aborted requests' second prefill
     counted in ``flash_attention``'s launches (phase 11b's part (c));
 13b. the MoE serving path (``moe_serving_phase``): qwen2-moe-a2.7b at
     full width in bf16 from seed 0 over a 24 GiB pool of 8192 16-token
     pages, phase 13's manager, tenants and traffic: 768 ``flash_attention``
     launches in prefill (24 a request) and 744 ``paged_attention``
     launches at a KV group of 1 in 31 decode steps (counted); the MoE
     FFN's share of a prefill request and of a decode step (CUDA events)
     and the routed choices dropped in prefill; both kernels at the
     captured inputs as in phase 13; the same traffic through the plain
     versions on the card and in fp32 through both (the fp32 runs over a
     pool of the pages the bf16 run took at once: 57 GB of fp32 weights
     leave no room for 8192 fp32 pages): summaries, pool stats, quotas,
     policies and decisions equal, fp32 tokens equal and last logits
     within 1e-4 of max |logit|, bf16 tokens held by phase 13's rule; 2
     layers at full width in fp32, 2 requests a tenant and 8 new tokens,
     card against CPU;
 13c. MLA, minicpm3-4b at full width and depth (``family_model_phase``):
     bf16 prefill 4 x 2048 (62 ``flash_attention`` launches on its
     ``<6, 1>`` instance, counted), 4 requests of 256 teacher-forced
     tokens and 32 greedy ones through the absorbed decode (no launch;
     cut from 1024 for the smoke's time);
     the same prefill through the plain versions and in fp32 through both
     (as phase 12); 2 layers in fp32: prefill against teacher-forced
     decode over 256 tokens (2e-4) and card against CPU (1e-4); the kernel
     at the captured shape held element by element, timed beside its
     plain versions, its bound, ``scaled_dot_product_attention`` under
     each fused backend alone and the padded ``<8, 2>`` path the instance
     replaced;
 13d. the encoder-decoder, seamless-m4t-large-v2, the same way: 4 x 1024
     encoder frames of seeded normal embeddings and 4 decoder prompts of
     256 tokens; 72 ``flash_attention`` launches a prefill (24 encoder,
     24 decoder self, 24 cross with Sq 256 over Skv 1024), each shape a
     row of its own; the decode's cross caches filled by
     ``cross_attention_kv`` from the encoder's output;
 16. training (``training_phase``, run after 13d): qwen3-0.6b at full
     width and depth in bf16 from seed 0, ``make_train_step`` over 15
     ``SyntheticLM`` batches of 8 x 2048 tokens (28 ``flash_attention``
     launches a step, counted; the loss at the last step below the
     first), the step's ms, tokens/s and peak memory, and the attention
     Function's share of a step by CUDA events; ``remat`` "full" and
     "dots" against "none" on the first step (56 launches); the first
     step's loss and gradients at 2 x 2048, kernels against plain
     versions, in fp32 (rel 1e-5, each leaf within 1e-4 of its largest
     |g|) and bf16 (2e-2, the gradient norm 5e-2); 2 layers in fp32 card
     against CPU (1e-4); the ``Trainer`` at 2 layers through a failure
     and a restart from its checkpoints; the SSD wrapper's gradient at
     zamba2-7b's layer shape (bit for bit against plain autograd); and
     ``flash_attention`` at the captured training inputs beside its
     plain-recompute backward, ``scaled_dot_product_attention`` forward
     + backward under each fused backend and the bound of forward +
     backward;
 17. distribution and launch (``distributed_phase``, run after 16; every
     mesh is logical shards of the one card): (a) the port's dry run,
     ``python -m repro_torch.launch.dryrun --all --both-meshes``, started
     on the host in 8 processes of its own (``--part``, no card, one
     thread each) beside (e)'s checkpoint save and restore, after every
     other timing of the phase: every
     cell of ``configs.all_cells()`` on the 16 x 16 and 2 x 16 x 16
     meshes on meta, one line a cell (roofline terms,
     bound, argument bytes a chip, HBM fit); (b) qwen3-0.6b's
     ``prefill_32k`` (batch cut 32 -> 2) and ``decode_32k`` (batch cut
     128 -> 8, the cache filled with seeded values, ``commit=False``)
     cells of ``launch.specs.build_cell`` run on the card as one chip:
     the cost reader's FLOPs on the card equal to meta's exactly, 28
     ``flash_attention`` launches in the prefill and none in the decode,
     time by CUDA events beside the roofline terms, and the kernel at
     the prefill's layer-0 inputs held to the fp32 plain version per
     head and 64-row query block (``long_hold``: at most twice the bf16
     plain version's error there + 2^-8 x the block's max |out|; a kernel
     that drops one 64-key tile in the last block, the diagonal one or
     the first, is shown to fail it), timed beside the bf16 plain
     version (3 warmed runs) and ``scaled_dot_product_attention``; (c) the split-KV decode of
     qwen3-0.6b and minicpm3-4b (MLA's absorbed merge) at full width, 4
     rows, a 128-token prompt teacher-forced, then 32 steps both ways:
     fp32 logits within 1e-5 of max |logit|, bf16 greedy tokens held by
     phase 12's rule, the deltas equal to what ``commit=True`` wrote
     (layer 0 bit for bit), the frozen cache untouched bit for bit, ms a
     step both ways; (d) ``pipeline_forward`` of qwen3-0.6b's 28 blocks
     as 2 stages on 4 x 2048 tokens in 4 microbatches (112
     ``flash_attention`` launches) against ``forward_hidden`` (fp32 1e-5
     of max |h|; bf16 2^-6 |h| + 1e-4 max |h|) and a 2-layer fp32 copy's
     gradients against the sequential ones (1e-4); (e) the sharded train
     step of qwen3-0.6b at full width and depth in fp32 on a 2 x 2
     (data, model) mesh, 2 x 2048 tokens, against the single-device step
     (loss rel 2e-4, params rtol 2e-3 atol 2e-4; 56 launches), which runs
     again under the cost reader with FLOPs and calls equal to meta's,
     then the
     placed state saved and restored onto 2 x 1 with ``shardings=``,
     every leaf bit for bit; its ``flash_attention`` row carries phase
     17's launches;
 14. time each kernel of the earlier slices at a full tape of its path
     (CUDA events) beside its plain version and the bound of the function
     it computes (the larger of its bytes at the memory rate and a tree
     count's operations at the 32-bit rate), holding it against the plain
     version there too; ``cache_sim_scan`` a call and alone, with its
     direct compares and tile searches beside the positions the previous
     design walked, and at the 256-tenant path's first tape (16.8 M rows)
     against the merge tree; ``urd_scan`` at one seed-row window
     (tenant 0 of the control plane's ``synthetic_mix``, 8,000 accesses; a
     call, alone, and the 1024 windows in turn), at a 65,536-row Table-3
     window and at the 1,048,576-row 16-tenant tape that times
     ``cache_sim_scan``, a call and alone; ``cache_sim_levels_scan`` at the
     last ETICA window's tape, a call and alone; ``cache_sim_segments_scan``
     at each width group of the 256-tenant window-0 sampled tape and its
     three launches, a call and alone, with the key words it stages; and
     ``live_count_scan`` at the pressure path's and the 256-tenant path's
     first guard tapes, a call and alone; the RO replay kernels' rows come
     from their largest calls on the paths (phases 4-7), with the bound
     the larger of their bytes and the longest block's stepped rows
     times the walk's dependent integer operation a step at the ALU's
     latency (``bound_l1_chain_ms`` keeps the earlier bound, one
     dependent L1 hit a row);
 15. print the kernels line (each row's ``fault_launches``: its launches
     in phase 11b and the pool crash; ``cache_sim_segments_scan``'s
     launches include the sharded runs of phases 4 and 9; one
     ``flash_attention`` row a shape of phases 12, 13 and 13b-d, one
     ``paged_attention`` row for phase 13 and one for 13b; phase 16's
     ``flash_attention`` row carries the training numbers, phase 17's its
     launches and the prefill_32k kernel's times), the card line and,
     last, the result line.

Exits non-zero, printing no result, when no card is visible or any
phase fails.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
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
                16384: [16384, 9000]}   # 16384: the widest block on chip
# the model layer: zamba2-7b at full width in bf16 from seed 0; prefill
# of PREFILL_SHAPE prompts (a multiple of the 256-token SSM chunk), then
# DECODE_ROWS requests of DECODE_PROMPT tokens teacher-forced through
# decode_step and DECODE_NEW greedy tokens
MODEL_ARCH, MODEL_SEED = "zamba2_7b", 0
PREFILL_SHAPE = (4, 2048)
# DECODE_PROMPT was 1024 until the serving phase took its time, 128 until
# the new families' phases (13b-d) took theirs
DECODE_ROWS, DECODE_PROMPT, DECODE_NEW = 4, 64, 32
# the reduced-depth fp32 config (full width): one hybrid group and a
# one-layer tail; prompts of two chunks
REDUCED = dict(n_layers=3, attn_every=2, dtype="float32")
REDUCED_PROMPT, REDUCED_DECODE = 512, 4
# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores, and
# fp32 outside them (the function the SSD kernel computes); TF32 on the
# tensor cores, which the SSD kernel's 3xTF32 takes three times
PEAK_BF16_PER_S = 989e12
PEAK_F32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
# the kernels' times before their redesign, printed beside the new ones
# and kept out of the kernels line, which carries this run's numbers only:
# flash_attention at zamba2-7b's prefill, mamba2_ssd at its layer,
# paged_attention at qwen3-0.6b's serving decode, cache_sim_scan and
# urd_scan at the 16-tenant window tape, urd_scan at the Table-3 window
# and cache_sim_levels_scan at the last ETICA window's tape (this script
# on NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6); cache_sim_scan's
# own time there after its redesign, which the shared tiled count keeps;
# and cache_sim_segments_scan at the 256-tenant window-0 sampled tape (its
# three launches) and live_count_scan at the pressure path's first guard
# tape (the same script and card, before their redesign)
PREV_MS = {"flash_attention": 6.387, "mamba2_ssd": 5.658,
           "paged_attention": 0.2815, "cache_sim_scan": 0.564,
           "urd_scan": 0.358, "urd_scan_table3": 0.0283,
           "cache_sim_levels_scan": 0.905, "cache_sim_scan_tiled": 0.2764,
           "cache_sim_segments_scan": 0.1328, "live_count_scan": 0.0345}
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
# the new families (ROADMAP §1 item 2): qwen2-moe-a2.7b served at full
# width through phase 13's deployment and traffic over a 24 GiB pool of
# 8192 pages (24 layers x 16 KV heads of 128: 3 MiB a page); its 2-layer
# fp32 card-vs-CPU copy serves MOE_REDUCED_PER_TENANT requests a tenant of
# the full lengths, MOE_REDUCED_NEW new tokens each (the CPU's dense expert
# dispatch costs about 177 GFLOP a layer for each 2048-token request)
MOE_ARCH = "qwen2_moe_a2_7b"
MOE_REDUCED_LAYERS, MOE_REDUCED_PER_TENANT, MOE_REDUCED_NEW = 2, 2, 8
# the fp32 runs of the MoE path may first route a request apart only
# where a token's k-th and (k+1)-th router logits lie within this share of
# its largest |logit|: a near tie that summation order can flip (the fp32
# kernels and plain versions put their last logits 1e-6 to 1e-5 of max
# |logit| apart; ten times that, while a wrong kernel moves them by 1e-2)
MOE_NEAR_TIE = 1e-4
# minicpm3-4b (MLA) and seamless-m4t-large-v2 (encoder-decoder) at full
# width and depth in bf16 from MODEL_SEED: minicpm3 prefills
# PREFILL_SHAPE, then decodes 4 prompts of MLA_DECODE_PROMPT tokens and
# FAMILY_DECODE_NEW greedy ones; seamless encodes ENC_ROWS x ENC_FRAMES
# seeded normal frames, prefills ENC_ROWS prompts of DEC_PROMPT tokens and
# decodes them; each also at FAMILY_REDUCED_LAYERS layers (and encoder
# layers) in fp32: prefill against teacher-forced decode over
# FAMILY_REDUCED_PROMPT tokens, card against CPU over FAMILY_REDUCED_DECODE
MLA_ARCH, ENCDEC_ARCH = "minicpm3_4b", "seamless_m4t_large_v2"
# MLA_DECODE_PROMPT cut from 1024: the absorbed decode runs eagerly at
# about 124 ms a step on the H100 (62 layers of small launches), 130 s for
# 1056 steps; after zamba2's teacher-forced decode was cut
MLA_DECODE_PROMPT, FAMILY_DECODE_NEW = 256, 32
ENC_ROWS, ENC_FRAMES, DEC_PROMPT = 4, 1024, 256
FAMILY_REDUCED_LAYERS, FAMILY_REDUCED_PROMPT = 2, 256
FAMILY_REDUCED_DECODE = 4
# training (ROADMAP §1 item 5): qwen3-0.6b at full width and depth in bf16
# from seed 0, AdamWConfig(**TRAIN_OPT) (tests/test_train.py:22-27), fed
# SyntheticLM(vocab, TRAIN_SHAPE[1], TRAIN_SHAPE[0], seed 0) for
# TRAIN_STEPS steps; the kernels against the plain versions on the first
# step's loss and gradients at TRAIN_HOLD_BATCH rows; a TRAIN_REDUCED
# layer copy in fp32 card against CPU on TRAIN_CPU_SHAPE tokens; the
# Trainer at TRAIN_REDUCED layers (bf16) on TRAINER_SHAPE batches, a
# failure at TRAINER_FAIL, a checkpoint every TRAINER_CKPT steps, for
# TRAINER_STEPS; the SSD wrapper's gradient at zamba2-7b's layer shape,
# batch 1 (SSD_GRAD_CASE: BH, S, P, N, chunk, groups of B/C)
TRAIN_ARCH, TRAIN_SEED, TRAIN_SHAPE, TRAIN_STEPS = "qwen3_0_6b", 0, \
    (8, 2048), 15
TRAIN_OPT = dict(lr_peak=1e-3, warmup_steps=5, total_steps=50)
TRAIN_HOLD_BATCH, TRAIN_REDUCED, TRAIN_CPU_SHAPE = 2, 2, (1, 256)
TRAINER_SHAPE, TRAINER_STEPS, TRAINER_CKPT, TRAINER_FAIL = (2, 256), 12, \
    3, 7
SSD_GRAD_CASE = (112, 2048, 64, 64, 256, 1)
# PERF.md section 5's ro_replay stage per window when the RO replays were
# host loops (this script on NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's
RO_REPLAY_BEFORE_S = {"16-tenant": (0.0, 0.368, 0.319),
                      "256-tenant": (0.0, 6.107),
                      "ETICA": (0.0, 0.526, 0.498),
                      "pressure": (0.0, 0.824, 0.597)}
# one dependent L1 hit on Hopper: about 33 cycles (published
# microbenchmarks of the H100's L1) at the H100 SXM's 1.98 GHz boost
# clock; the RO token replays' chain bound before their redesign was a
# block's rows times this (kept beside the new one as bound_l1_chain_ms)
L1_HIT_S = 33 / 1.98e9
# the dependent-issue latency of an integer ALU operation (IADD3, LEA,
# ISETP: 4 cycles on Volta and later, published microbenchmarks) at the
# same clock, and the integer operations of the RO walks that carry from
# one step to the next: the resident count's update alone, one IADD3 of
# the count, is_read and the sign of b - cand (the victim pointer b moves
# only at an eviction, so b - cand is off the chain; each level's count
# is a chain of its own; in the SASS of ro_replay_kernel<false>, from
# cuobjdump -sass, the group path chains one LEA.HI.SX32 a step, and the
# step-by-step path an IMAD.IADD and a LEA.HI.SX32 before its compare,
# which one IADD3 could do); the chain bound is the longest block's
# stepped rows (at or past l2_end) times their product
ALU_OP_S = 4 / 1.98e9
RO_CHAIN_OPS = 1
# the control plane through DeviceWindowPipeline.run_stream: these seeds,
# with an empty window third
CP_STREAM_SEEDS = (7, 8, None, 9)
# the card-against-CPU check of the device pipeline at a small size (the
# CPU counts each width group with the dense plain segments count)
DP_SMALL = (32, 1000, 11)
# the sharded window pipeline on logical shards of the one card: phase 9
# at each count, the 16-tenant manager (phase 4) at the last; phase 11b's
# short sharded run: SHARDED_FAULT_WINDOWS windows over the default mesh
# with a dead sharded rung at SHARDED_FAULT_WINDOW
SHARD_COUNTS = (1, 2, 8)
SHARDED_FAULT_WINDOWS, SHARDED_FAULT_WINDOW = 3, 1
# the fault phase: slice 1's deployment for FAULT_WINDOWS windows under
# FaultPlan.standard(16, FAULT_WINDOWS, seed=0) plus FAULT_DEVICE_SPECS
# (window, count) of device-rung launch failures: an in-rung retry, then a
# dead rung in the window whose host rung the standard plan kills; the
# WB demotion lasts FAULT_COOLDOWN analyzes past a recovery
FAULT_WINDOWS, FAULT_COOLDOWN = 8, 2
FAULT_DEVICE_SPECS = ((2, 1), (5, 99))
# benchmarks/bench_faults.py's CAPACITY, C_MIN, N_TENANTS, its _trace's
# accesses and the smoke seed
BF_CAPACITY, BF_C_MIN, BF_TENANTS, BF_ACCESSES, BF_SEED = 8192, 256, 4, \
    2500, 0
# the summary counters a fault run must leave positive (phase 11b)
FAULT_FINGERPRINTS = ("dirty_loss", "poisoned_windows", "straggler_windows",
                      "tier_failures", "device_stepdowns", "host_stepdowns")
# phase 17 (distributed and launch): the dry run of every cell on both
# production meshes, on meta in DRYRUN_PARTS host processes of their own
# (started just before (e)'s checkpoint save and restore, after every
# other timing of the phase; at most DRYRUN_TIMEOUT_S); two of
# build_cell's cells executed at full width as one chip, their batch cut
# (prefill_32k 32 -> DIST_PREFILL_BATCH, decode_32k 128 ->
# DIST_DECODE_BATCH, the decode cache filled with seeded values in place
# of a 32k prefill); the split-KV decode of DIST_ARCH and DIST_MLA_ARCH on
# SPLIT_ROWS rows, a SPLIT_PROMPT-token prompt teacher-forced with
# commit=True (cut from 256: eager steps of 60-200 ms made the four
# prompts 112 s), then SPLIT_STEPS steps both ways; pipeline_forward of
# DIST_ARCH's blocks as PIPE_STAGES stages on PIPE_SHAPE tokens in
# PIPE_MICRO microbatches, and its gradients at PIPE_GRAD_LAYERS layers on
# PIPE_GRAD_SHAPE; the sharded train step on a logical SHARD_MESH mesh at
# SHARD_SHAPE, restored onto SHARD_RESTORE_MESH
DIST_ARCH, DIST_MLA_ARCH, DIST_SEED = "qwen3_0_6b", "minicpm3_4b", 0
DRYRUN_TIMEOUT_S, DRYRUN_PARTS = 600, 8
DIST_PREFILL_BATCH, DIST_DECODE_BATCH = 2, 8
# (b)'s hold of flash_attention at S 32768 (long_hold): per head and
# LONG_HOLD_ROWS-row query block, max |kernel - fp32 plain| at most twice
# the bf16 plain version's there + LONG_HOLD_REL x the block's max |out|;
# a kernel with one LONG_DROP_KEYS-key tile (the kernel's kBN) dropped in
# the last block must fail it; the bf16 plain version timed over
# PLAIN_LONG_REPS warmed runs
LONG_HOLD_ROWS, LONG_HOLD_REL, LONG_DROP_KEYS = 64, 2.0 ** -8, 64
PLAIN_LONG_REPS = 3
SPLIT_ROWS, SPLIT_PROMPT, SPLIT_STEPS = 4, 128, 32
PIPE_SHAPE, PIPE_MICRO, PIPE_STAGES = (4, 2048), 4, 2
PIPE_GRAD_LAYERS, PIPE_GRAD_SHAPE = 2, (4, 512)
SHARD_MESH, SHARD_RESTORE_MESH, SHARD_SHAPE = (2, 2), (2, 1), (2, 2048)
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


def edge_tape(n: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """``tape_links``'s tenant blocks (links severed per block) plus, at
    every tile edge e of the tiled count, a fresh address touched at
    e - 1 and at a random later row of its block (an interval that starts
    on the edge, often crossing many whole tiles) and one touched at a
    random earlier row of e's block and at e (one that ends on it)."""
    from repro_torch.core.batch_sim import segment_links
    from repro_torch.kernels.cache_sim.kernel import TILE
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(3, n - 1),
                              replace=False)) if n > 1 else np.zeros(0)
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    lens = np.diff(bounds)
    addrs = np.concatenate([rng.integers(0, max(4, ln // 3), ln)
                            for ln in lens])
    block = np.repeat(np.arange(lens.size), lens)
    fresh = int(addrs.max()) + 1
    for e in range(TILE, n, TILE):
        end = bounds[block[e - 1] + 1]
        if e + 1 < end:
            addrs[e - 1] = addrs[rng.integers(e + 1, end)] = fresh
        start = bounds[block[e]]
        if start < e - 1:
            addrs[rng.integers(start, e - 1)] = addrs[e] = fresh + 1
        fresh += 2
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    prev, nxt, _, _ = segment_links(t(addrs), t(block),
                                    t(bounds[1:])[t(block)])
    reads = torch.as_tensor(rng.random(n) < 0.6, device=device)
    return prev, nxt, reads


def edge_caps(n: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """Per-row capacities of every kind, at random: cap1 = 0, captot = 0,
    cap1 > captot, cap1 = captot and cap1 < captot."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, max(8, n // 64), n)
    b = rng.integers(0, max(8, n // 64), n)
    kind = rng.integers(0, 5, n)
    cap1 = np.select([kind == 0, kind == 2, kind == 4],
                     [0, np.maximum(a, b), np.minimum(a, b)], a)
    captot = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                       [0, np.minimum(a, b), a, np.maximum(a, b)], b)
    return (torch.as_tensor(cap1, dtype=torch.int32, device=device),
            torch.as_tensor(captot, dtype=torch.int32, device=device))


def edge_rows(prev: torch.Tensor, tile: int) -> tuple[int, int, int]:
    """(hot rows whose interval starts on a tile edge, hot rows whose
    interval ends on one, most whole tiles an interval crosses)."""
    pos = torch.arange(prev.shape[0], device=prev.device)
    hot = prev >= 0
    lo, hi = prev[hot] + 1, pos[hot]
    whole = (hi // tile - (lo + tile - 1) // tile).clamp(min=0)
    return (int(((lo % tile == 0) & (lo < hi)).sum()),
            int(((hi % tile == 0) & (lo < hi)).sum()),
            int(whole.max()) if whole.numel() else 0)


def live_edge_tape(n: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """int32 nxt and occ for the live count's corners: ``tape_links``'s
    links plus rows with nxt = -1 and nxt = j (never live) and nxt >= n
    (live to the end), past 2,000 rows 1,500 rows before the middle dying
    at the middle word, and a twentieth of the rows dying anywhere on the
    tape."""
    _, nxt, reads = tape_links(n, seed, device)
    rng = np.random.default_rng(seed)
    pos = torch.arange(n, device=device)
    pick = torch.as_tensor(rng.integers(0, 5, n), device=device)
    nxt = torch.where(pick == 0, -1, torch.where(
        pick == 1, pos, torch.where(pick == 2, n, nxt)))
    if n > 2000:
        nxt[n // 2 - 1500:n // 2] = n // 2
    far = torch.as_tensor(rng.random(n) < 0.05, device=device)
    anywhere = torch.as_tensor(rng.integers(0, n + 2, n), device=device)
    return (torch.where(far, anywhere, nxt).to(torch.int32),
            reads.to(torch.int32))


def segment_group(w: int, lens, seed: int, device, cross: int = 0):
    """int32 prev, nxt, occ and a read mask of one width group: a segment
    of each length in ``lens`` at the start of its own w-block, links
    severed per segment with nxt clamped to its end, pad rows cold,
    non-occupying and linked to themselves; ``cross`` hot rows past the
    first block get a prev in an earlier block and as many a prev at or
    past the row.  Any w (the segments kernel takes any width that divides
    the length)."""
    rng = np.random.default_rng(seed)
    m = w * len(lens)
    prev = np.full(m, -1, np.int64)
    nxt = np.arange(m, dtype=np.int64)
    occ = np.zeros(m, np.int64)
    for b, ln in enumerate(lens):
        s, e = b * w, b * w + ln
        addrs = rng.integers(0, max(3, ln // 4), ln)
        order = np.argsort(addrs, kind="stable")
        same = addrs[order][1:] == addrs[order][:-1]
        prev[s + order[1:][same]] = s + order[:-1][same]
        nxt[s:e] = e
        nxt[s + order[:-1][same]] = s + order[1:][same]
        occ[s:e] = 1
    reads = occ * (rng.random(m) < 0.6)
    hot = np.flatnonzero((prev >= 0) & (np.arange(m) >= w))
    pick = rng.choice(hot, size=min(2 * cross, hot.size), replace=False)
    back, late = pick[:cross], pick[cross:]
    prev[back] = np.maximum(back - w - rng.integers(0, w, back.size), 0)
    prev[late] = late + rng.integers(0, 3, late.size)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    return t(prev), t(nxt), t(occ), t(reads)


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


def sampled_tape(traces, device):
    """The SHARDS-sampled padded tape of one window of the 256-tenant
    path, as its monitor lays it out: the kept accesses per tenant, the
    width groups and each group's chunk-local int32 links with its width
    (the arguments of one ``cache_sim_segments_scan`` launch each)."""
    from repro_torch.core.batch_sim import (padded_segment_layout,
                                            padded_tape_links,
                                            segment_links)
    from repro_torch.core.monitor import shards_subtape
    from repro_torch.core.reuse_distance import auto_sample_rate
    from repro_torch.kernels.cache_sim.ops import width_groups_of
    rates = [auto_sample_rate(len(t)) for t in traces]
    addrs, _, kept = shards_subtape(traces, rates, 0,
                                    list(range(len(traces))), device)
    tid = torch.repeat_interleave(torch.arange(len(traces), device=device),
                                  kept)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                        torch.cumsum(kept, 0)])
    prev, nxt, _, _ = segment_links(addrs, tid, bounds[1:][tid])
    lay = padded_segment_layout(bounds.cpu(), device=device)
    gprev, gnxt, gocc = padded_tape_links(prev, nxt, lay)
    groups = width_groups_of(lay[4])
    return kept, groups, [(padded_group_links(gprev, gnxt, gocc, w, lo, hi),
                           w) for w, lo, hi in groups]


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


def graph_ms(fn, reps: int) -> float:
    """The kernels alone: ``reps`` calls captured in one CUDA graph and
    replayed between two events, so the host's launch time is left out."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


KERNEL_NAMES = ("cache_sim_scan", "cache_sim_segments_scan",
                "cache_sim_levels_scan", "live_count_scan", "urd_scan",
                "mamba2_ssd", "flash_attention", "paged_attention",
                "ro_token_replay_scan", "ro_token_replay_levels_scan")
RO_KERNELS = ("ro_token_replay_scan", "ro_token_replay_levels_scan")
STAGES = ("tape", "ro_replay", "count", "replay", "monitor", "pgd")


def kernel_wrappers() -> dict:
    """name -> the launching wrapper (its ``launches`` is the count)."""
    from repro_torch.kernels.cache_sim import kernel as cache_sim
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mamba2_ssd import kernel as ssd
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ro_replay import kernel as ro
    from repro_torch.kernels.urd_scan import kernel as urd
    home = {"urd_scan": urd, "mamba2_ssd": ssd, "flash_attention": fa,
            "paged_attention": pa, "ro_token_replay_scan": ro,
            "ro_token_replay_levels_scan": ro}
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


# calls of the per-tenant host token loops (the CPU tape's RO replays),
# counted by wrappers main() installs on batch_sim's names
HOST_TOKENS = collections.Counter()


def count_host_tokens(bs) -> None:
    """Count the CPU tape's per-tenant RO replays (one and two levels)."""
    for name, key in (("_ro_token_replay", "one"),
                      ("_ro_token_replay_levels", "two")):
        fn = getattr(bs, name)

        def counted(*a, _fn=fn, _key=key, **k):
            HOST_TOKENS[_key] += 1
            return _fn(*a, **k)
        setattr(bs, name, counted)


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
        host0 = dict(HOST_TOKENS)
        t0 = time.perf_counter()
        mgr.run_window(traces)
        if cuda:
            torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t0)
        rec["launches"].append(read_counts())
        rec["host_tokens"].append(tuple(HOST_TOKENS[k] - host0.get(k, 0)
                                        for k in ("one", "two")))
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


def segments_staged(prev: torch.Tensor, w: int) -> int:
    """Key words the segments kernel stages into shared memory for one
    width group (chunk-local prev), as its plan_for cuts the group: past
    w = 256 a CTA takes R rows of one block (1024 up to w = 4096 and 512
    past it, a power of two below 2w) and stages from the tile of its
    lowest interval start (or its first row) to its last row; up to
    w = 256 every row once; past ``SEGMENTS_SMEM_WIDTH`` none (the global
    count)."""
    from repro_torch.kernels.cache_sim.kernel import SEGMENTS_SMEM_WIDTH
    m = int(prev.shape[0])
    if w <= 256 or w > SEGMENTS_SMEM_WIDTH:
        return m if w <= 256 else 0
    rows, most = 256, 1024 if w <= 4096 else 512
    while rows < most and rows < w:
        rows *= 2
    pos = torch.arange(m, device=prev.device)
    bs = pos - pos % w
    lo = torch.minimum(torch.maximum(prev.long() + 1, bs), pos)
    lo = torch.where(prev >= 0, lo, pos)
    cta = bs // w * -(-w // rows) + (pos - bs) // rows
    k = int(cta.max()) + 1
    big = torch.full((k,), m, dtype=torch.int64, device=prev.device)
    first = big.scatter_reduce(0, cta, lo, "amin")
    r0 = big.scatter_reduce(0, cta, pos, "amin")
    r1 = torch.zeros_like(big).scatter_reduce(0, cta, pos + 1, "amax")
    cbs = r0 - r0 % w
    start = torch.minimum(cbs + (first - cbs) // 256 * 256, r0)
    return int((r1 - start).sum())


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
    # the RO replay kernels: one launch per kind in each window whose CPU
    # replay took that kind's host token loop for some tenant
    for w, (one, two) in enumerate(crec["host_tokens"]):
        got = tuple(grec["launches"][w][k] for k in RO_KERNELS)
        assert got == (int(one > 0), int(two > 0)), \
            f"{path} window {w}: RO replay launches {got}, CPU host " \
            f"token loops {(one, two)}"
    before = RO_REPLAY_BEFORE_S.get(path)
    for w, st in enumerate(grec["stages"]):
        if "ro_replay" in st:
            print(f"{path} window {w}: ro_replay {st['ro_replay']:.4f} s on "
                  f"the card (PERF.md section 5, host loops: "
                  f"{before[w] if before else 'not measured'} s); "
                  f"RO replay launches "
                  f"{[grec['launches'][w][k] for k in RO_KERNELS]}, CPU "
                  f"tenants through the host loops "
                  f"{list(crec['host_tokens'][w]) if w < len(crec['host_tokens']) else 'not run'}")
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


class RoCalls:
    """Keeps every call's arguments of batch_sim's two RO replay entry
    points (``ro_token_replays``, ``ro_token_replays_levels``: the
    kernels' callers) while a path runs; the wrapped functions still
    run.  Calls with the same blocks on the same tape length (the ETICA
    route replays on clones) are kept once."""

    def __init__(self, bs):
        self.bs = bs
        self.calls = {"ro_token_replay_scan": {},
                      "ro_token_replay_levels_scan": {}}

    def __enter__(self):
        self.orig = {}
        for attr, kern in (("ro_token_replays", "ro_token_replay_scan"),
                           ("ro_token_replays_levels",
                            "ro_token_replay_levels_scan")):
            fn = getattr(self.bs, attr)
            self.orig[attr] = fn

            def wrapped(*a, _fn=fn, _kern=kern):
                key = (int(a[0].shape[0]),
                       *(tuple(int(x) for x in v) for v in a[4:]))
                self.calls[_kern].setdefault(key, a)
                return _fn(*a)
            setattr(self.bs, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.orig.items():
            setattr(self.bs, attr, fn)


def ro_tape(seed: int, dev, levels: bool, blocks: int = 6,
            n_max: int = 5000):
    """Pressured RO tenant blocks on one tape: few addresses, mostly
    reads, links severed at the blocks; a one-row block; capacity 0 on
    some single-level blocks; warm-L2 rows (l2_end) at the head of the
    two-level blocks, a clean L2 on every other one."""
    from repro_torch.core.batch_sim import segment_links
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(1, n_max, blocks)]
    lens[1] = 1
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    tid = torch.as_tensor(np.repeat(np.arange(blocks), lens), device=dev)
    addrs = np.concatenate([rng.integers(0, 40 + 20 * k, ln)
                            for k, ln in enumerate(lens)])
    prev, nxt, _, _ = segment_links(torch.as_tensor(addrs, device=dev), tid,
                                    torch.as_tensor(bounds[1:],
                                                    device=dev)[tid])
    m = int(bounds[-1])
    tape = (torch.as_tensor(rng.random(m) < 0.8, device=dev), prev, nxt,
            torch.as_tensor(rng.random(m) < 0.3, device=dev))
    c1 = [int(x) for x in rng.integers(1 if levels else 0, 24, blocks)]
    c2 = [int(x) for x in rng.integers(1, 24, blocks)]
    l2e = [min(int(x), ln) for x, ln in zip(rng.integers(0, 12, blocks),
                                           lens)]
    caps = ((c1, c2, l2e, [bool(k % 2) for k in range(blocks)]) if levels
            else (c1,))
    return tape, bounds[:-1].tolist(), bounds[1:].tolist(), caps


def ro_kernel_args(a):
    """A recorded ``ro_token_replays*`` call as the kernel's arguments."""
    rd, prev, nxt, force, *rest = a
    return (rd.contiguous(), prev.to(torch.int32).contiguous(),
            nxt.to(torch.int32).contiguous(), force.contiguous(), *rest)


def ro_check(name: str, what: str, args, check) -> float:
    """Hold one RO replay kernel call against its plain version (the
    host loops on CPU copies of the tape): every output equal.  Returns
    the plain version's seconds."""
    from repro_torch.kernels.ro_replay import kernel as ro, ref
    kern = getattr(ro, name)
    plain = (ref.ro_token_replay_blocks_ref
             if name == "ro_token_replay_scan"
             else ref.ro_token_replay_levels_blocks_ref)
    got = kern(*args)
    host = tuple(x.cpu() for x in args[:4]) + tuple(args[4:])
    t0 = time.perf_counter()
    want = plain(*host)
    t_plain = time.perf_counter() - t0
    for g, w_, part in zip(got, want, ("death", "dirty", "lvl", "counts")):
        check(name, f"{what} {part}", g.cpu(), w_)
    return t_plain


def ro_work(args, levels: bool) -> tuple[int, int]:
    """(rows replayed, the longest block's rows) of one call."""
    starts, ends = args[4], args[5]
    rows = [e - s for s, e in zip(starts, ends)]
    return sum(rows), max(rows, default=0)


def ro_bound_ms(args, levels: bool) -> tuple[float, str, float]:
    """The larger of the call's bytes at the memory rate (read is_read,
    prev, nxt, force and write death, dirty and, with two levels, lvl
    once a row: 15 or 16 bytes) and its longest chain of dependent steps:
    a block's rows at or past its ``l2_end`` (the warm-L2 rows below it
    take no step), ``RO_CHAIN_OPS`` integer operations a step at
    ``ALU_OP_S`` each (``bound_by`` "operations"); and, third, the bound
    before the redesign, the longest block's rows times one dependent L1
    hit."""
    rows, longest = ro_work(args, levels)
    starts, ends = args[4], args[5]
    stepped = [e - s - (min(args[8][k], e - s) if levels else 0)
               for k, (s, e) in enumerate(zip(starts, ends))]
    b = rows * (16 if levels else 15) / PEAK_BYTES_PER_S * 1e3
    chain = max(stepped, default=0) * RO_CHAIN_OPS * ALU_OP_S * 1e3
    return (max(b, chain), ("operations" if chain >= b else "bytes"),
            longest * L1_HIT_S * 1e3)


def ro_path_checks(path: str, calls: RoCalls, check, timed: dict) -> None:
    """Phase 4-7: every recorded RO replay call of a path held to its
    plain version on the card, exactly, and timed (the kernel by CUDA
    events, a call; its plain version once); the largest call of each
    kind is kept in ``timed`` for the kernels line."""
    for name, by_key in calls.calls.items():
        levels = name == "ro_token_replay_levels_scan"
        for i, a in enumerate(by_key.values()):
            args = ro_kernel_args(a)
            rows, longest = ro_work(args, levels)
            t_plain = ro_check(name, f"{path} call {i}", args, check)
            kern = kernel_wrappers()[name]
            ms = cuda_ms(lambda: kern(*args), 3)
            bnd, by, l1 = ro_bound_ms(args, levels)
            print(f"{path} {name} call {i}: {len(args[4])} pressured "
                  f"blocks, {rows} rows (longest {longest}); kernel "
                  f"{ms:.3f} ms a call, plain version (host loops) "
                  f"{t_plain * 1e3:.1f} ms, bound {bnd:.4f} ms by {by} "
                  f"(an L1 hit a row: {l1:.4f}); equal")
            if name not in timed or rows > timed[name]["rows"]:
                timed[name] = {"rows": rows, "ms": ms,
                               "plain_ms": t_plain * 1e3, "bound_ms": bnd,
                               "bound_by": by, "bound_l1_chain_ms": l1,
                               "path": path}


def device_pipeline_phase(dev, traces, capacity: int, fused, heap,
                          fused_wall: float) -> int:
    """Phase 9, second part: the 1024-tenant control plane through
    ``DeviceWindowPipeline`` under ``transfer_sanitize=True`` (one sync
    a window), against the fused row (curves, ``greedy_allocate(method=
    "fast")``) and the heap walk; ``run_stream`` over four windows
    against ``run``; ``greedy_allocate(method="device")`` on the fused
    curves against the heap.  Returns the segments kernel's launches."""
    from repro_torch.core import StageProfile, Trace, greedy_allocate
    from repro_torch.core.device_pipeline import DeviceWindowPipeline
    from repro_torch.data.traces import synthetic_mix
    curves, part = fused
    host = curves.to("cpu")
    pipe = DeviceWindowPipeline(capacity, c_min=CP_C_MIN,
                                transfer_sanitize=True, device=dev)
    walls = []
    for rep in range(2):                      # the first warms the caches
        prof = StageProfile(dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        dec = pipe.run(traces, profile=prof)
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
    assert prof.syncs_per_window == 1 and prof.windows == 1, prof.report()
    assert counts["cache_sim_segments_scan"] >= 1, counts
    for f in ("edges", "heights", "offsets", "n_accesses"):
        assert torch.equal(getattr(dec.curves, f), getattr(host, f)), f
    for want in (part, heap):
        assert dec.sizes.tolist() == want.sizes.tolist(), "sizes"
        assert torch.equal(dec.hit_ratios, want.hit_ratios), "hit ratios"
        assert dec.feasible == want.feasible
        assert abs(dec.latency - want.latency) <= 1e-12 * abs(want.latency)
    print(f"control plane DeviceWindowPipeline.run on the card "
          f"(transfer_sanitize=True, CPU traces): {walls[0]:.3f} s, then "
          f"{walls[1]:.3f} s (fused row: {fused_wall:.3f} s); stages "
          f"{json.dumps({k: round(v, 4) for k, v in prof.times.items()})}, "
          f"syncs a window {prof.syncs_per_window}; launches "
          f"{json.dumps(counts)}")
    print(f"check: DeviceWindowPipeline == fused row == heap walk (curves "
          f"and hit ratios bit for bit, sizes exact, latency to rel "
          f"1e-12), one sync a window under the sanitizer")
    empty = [Trace(torch.zeros(0, dtype=torch.int64),
                   torch.zeros(0, dtype=torch.bool))] * CP_TENANTS
    wins = [empty if sd is None else synthetic_mix(CP_TENANTS, CP_ACCESSES,
                                                   seed=sd)
            for sd in CP_STREAM_SEEDS]
    sprof = StageProfile(dev)
    t0 = time.perf_counter()
    stream = pipe.run_stream(wins, profile=sprof)
    t_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [pipe.run(w) for w in wins]
    t_solo = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(stream, solo)):
        assert a.sizes.tolist() == b.sizes.tolist(), f"stream window {k}"
        assert torch.equal(a.urd_sizes, b.urd_sizes)
        assert torch.equal(a.hit_ratios, b.hit_ratios)
        assert torch.equal(a.curves.edges, b.curves.edges)
        assert a.latency == b.latency and a.feasible == b.feasible
    assert sprof.syncs == len(wins) - 1 and sprof.windows == len(wins), \
        sprof.report()
    print(f"check: run_stream over windows of seeds {CP_STREAM_SEEDS} "
          f"(None: empty) == run, {sprof.syncs} syncs for "
          f"{sprof.windows} windows; stream {t_stream:.3f} s, the windows "
          f"one at a time {t_solo:.3f} s")
    gdev = greedy_allocate(curves, capacity, 1.0, 20.0, c_min=CP_C_MIN,
                           method="device")
    assert gdev.sizes.tolist() == heap.sizes.tolist()
    assert torch.equal(gdev.hit_ratios, heap.hit_ratios)
    print("check: greedy_allocate(method=\"device\") on the fused curves "
          "== heap walk (sizes, hit ratios)")
    # card against CPU, bit for bit, at a small size
    small = synthetic_mix(*DP_SMALL[:2], seed=DP_SMALL[2])
    cap_small = DP_SMALL[0] * CP_C_MIN * 2
    g = DeviceWindowPipeline(cap_small, c_min=CP_C_MIN,
                             transfer_sanitize=True, device=dev).run(small)
    c = DeviceWindowPipeline(cap_small, c_min=CP_C_MIN,
                             device="cpu").run(small)
    for f in ("sizes", "urd_sizes", "hit_ratios", "write_ratios"):
        assert torch.equal(getattr(g, f), getattr(c, f)), f
    for f in ("edges", "heights", "offsets"):
        assert torch.equal(getattr(g.curves, f), getattr(c.curves, f)), f
    assert g.feasible == c.feasible
    assert abs(g.latency - c.latency) <= 1e-12 * abs(c.latency)
    print(f"check: DeviceWindowPipeline card == CPU at "
          f"synthetic_mix{DP_SMALL[:2]}, seed {DP_SMALL[2]}, capacity "
          f"{cap_small} (every output bit for bit, latency to rel 1e-12; "
          f"feasible={g.feasible})")
    return counts["cache_sim_segments_scan"], dec, g


def same_decision(what: str, got, want, exact_latency: bool = False) -> None:
    """Two ``WindowDecision``s: every tensor bit for bit, latency to rel
    1e-12 (or exactly)."""
    for f in ("sizes", "urd_sizes", "hit_ratios", "write_ratios"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), \
            f"{what}: {f}"
    for f in ("edges", "heights", "offsets", "n_accesses"):
        assert torch.equal(getattr(got.curves, f).cpu(),
                           getattr(want.curves, f).cpu()), f"{what}: {f}"
    assert got.feasible == want.feasible, f"{what}: feasibility"
    assert (got.latency == want.latency if exact_latency else
            abs(got.latency - want.latency) <= 1e-12 * abs(want.latency)), \
        f"{what}: latency {got.latency} vs {want.latency}"


def sharded_pipeline_phase(dev, traces, capacity, single, heap,
                           small_card) -> int:
    """Phase 9, third part: the 1024-tenant window through
    ``DeviceWindowPipeline(mesh=)`` on 1, 2 and 8 logical shards of the
    card under ``transfer_sanitize=True``, timed in turns with the
    single-device pipeline in the same loop: every output bit for bit
    with the single-device decision (latency to rel 1e-12) and sizes and
    hit ratios with the heap walk, one sync a window, every shard
    launching ``cache_sim_segments_scan`` once a width group;
    ``run_stream`` over the 8-shard mesh against the single-device
    pipeline's windows; and each mesh on the card against the same mesh
    on the CPU and the card's single-device pipeline at ``DP_SMALL``.
    Returns the segments launches of the last timed run at each count and
    of the stream."""
    from repro_torch.core import StageProfile, Trace
    from repro_torch.core.device_pipeline import DeviceWindowPipeline
    from repro_torch.core.shard_pipeline import ingest_window_sharded
    from repro_torch.data.traces import synthetic_mix
    from repro_torch.distributed import ShardMesh
    one = DeviceWindowPipeline(capacity, c_min=CP_C_MIN,
                               transfer_sanitize=True, device=dev)
    lens = [len(t) for t in traces]
    bounds = np.concatenate([[0], np.cumsum(lens)]).tolist()
    addrs = torch.cat([t.addrs for t in traces])
    reads = torch.cat([t.is_read for t in traces])
    launches = 0
    for k in SHARD_COUNTS:
        mesh = ShardMesh((dev,) * k)
        pipe = DeviceWindowPipeline(capacity, c_min=CP_C_MIN,
                                    transfer_sanitize=True, mesh=mesh)
        groups = len(ingest_window_sharded(addrs, reads, bounds, lens,
                                           mesh=mesh).key[0])
        walls = {"single": [], "sharded": []}
        for rep in range(4):                 # the first warms the caches
            for name, p in (("single", one), ("sharded", pipe)):
                prof = StageProfile(dev)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                dec = p.run(traces, profile=prof)
                walls[name].append(time.perf_counter() - t0)
                counts = read_counts()
                assert prof.syncs_per_window == 1 and prof.windows == 1, \
                    prof.report()
                if name == "single":
                    stages = prof.times
        seg = counts["cache_sim_segments_scan"]
        assert seg == k * groups, (k, groups, counts)
        launches += seg
        same_decision(f"{k} shards vs one device", dec, single)
        assert dec.sizes.tolist() == heap.sizes.tolist(), "sizes vs heap"
        assert torch.equal(dec.hit_ratios, heap.hit_ratios)
        print(f"control plane DeviceWindowPipeline(mesh={k} logical "
              f"shard{'s' if k > 1 else ''} of the card).run "
              f"(transfer_sanitize=True, CPU traces): "
              f"{[round(x, 4) for x in walls['sharded']]} s, the "
              f"single-device pipeline in turn "
              f"{[round(x, 4) for x in walls['single']]} s (the first run "
              f"of each warms); sharded stages "
              f"{json.dumps({k_: round(v, 4) for k_, v in prof.times.items()})}"
              f", single-device {json.dumps({k_: round(v, 4) for k_, v in stages.items()})}"
              f"; {groups} width group{'s' if groups > 1 else ''} a shard, "
              f"cache_sim_segments_scan launches {seg}; launches "
              f"{json.dumps(counts)}")
    print(f"check: DeviceWindowPipeline(mesh=) at {SHARD_COUNTS} logical "
          f"shards == the single-device pipeline (curves, URD sizes, write "
          f"ratios, sizes, hit ratios bit for bit, latency to rel 1e-12) == "
          f"heap walk (sizes, hit ratios), one sync a window, every shard "
          f"launching cache_sim_segments_scan once a width group")
    empty = [Trace(torch.zeros(0, dtype=torch.int64),
                   torch.zeros(0, dtype=torch.bool))] * CP_TENANTS
    wins = [empty if sd is None else synthetic_mix(CP_TENANTS, CP_ACCESSES,
                                                   seed=sd)
            for sd in CP_STREAM_SEEDS]
    pipe = DeviceWindowPipeline(capacity, c_min=CP_C_MIN,
                                transfer_sanitize=True,
                                mesh=ShardMesh((dev,) * SHARD_COUNTS[-1]))
    sprof = StageProfile(dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    stream = pipe.run_stream(wins, profile=sprof)
    t_stream = time.perf_counter() - t0
    seg = read_counts()["cache_sim_segments_scan"]
    launches += seg
    for k, (a, w) in enumerate(zip(stream, wins)):
        same_decision(f"sharded stream window {k}", a, one.run(w))
    assert sprof.syncs == len(wins) - 1 and sprof.windows == len(wins), \
        sprof.report()
    print(f"check: run_stream over the {SHARD_COUNTS[-1]}-shard mesh, "
          f"windows of seeds {CP_STREAM_SEEDS} (None: empty) == the "
          f"single-device pipeline's run of each, {sprof.syncs} syncs for "
          f"{sprof.windows} windows; stream {t_stream:.3f} s; "
          f"cache_sim_segments_scan launches {seg}")
    small = synthetic_mix(*DP_SMALL[:2], seed=DP_SMALL[2])
    cap_small = DP_SMALL[0] * CP_C_MIN * 2
    for k in SHARD_COUNTS:
        g = DeviceWindowPipeline(cap_small, c_min=CP_C_MIN,
                                 transfer_sanitize=True,
                                 mesh=ShardMesh((dev,) * k)).run(small)
        c = DeviceWindowPipeline(cap_small, c_min=CP_C_MIN,
                                 mesh=ShardMesh(("cpu",) * k)).run(small)
        same_decision(f"{k} shards, card vs CPU", g, c)
        same_decision(f"{k} shards vs the card's single device", g,
                      small_card)
    print(f"check: DeviceWindowPipeline(mesh=) card == the same mesh on "
          f"the CPU == the card's single-device pipeline at "
          f"synthetic_mix{DP_SMALL[:2]}, seed {DP_SMALL[2]}, at "
          f"{SHARD_COUNTS} logical shards (every output bit for bit, latency "
          f"to rel 1e-12)")
    return launches


@contextlib.contextmanager
def default_mesh(mesh):
    """``mesh`` (logical shards of the card) as the sharded pipeline's
    default mesh in place of ``control_plane_mesh``'s (every card), for
    this script's runs only; the port has no switch for it."""
    import repro_torch.core.shard_pipeline as sp
    real = sp.control_plane_mesh
    sp.control_plane_mesh = lambda n_shards=None, device=None: mesh
    try:
        yield
    finally:
        sp.control_plane_mesh = real


def manager_device_phase(dev, path, windows, names, capacity, host_run,
                         pipeline="device", against="the host pipeline's",
                         **kw):
    """The manager under ``pipeline`` ("device" or "sharded") on the card
    against another run of the same windows on the card (``against``: the
    host pipeline's, or the device pipeline's): decisions, event logs,
    per-tenant counts and LRU states equal.  Returns the run."""
    from repro_torch.core import StageProfile
    gpu, grec = host_run
    t0 = time.perf_counter()
    mgr, rec = run_windows(dev, windows, names, capacity,
                           profile=StageProfile(dev), pipeline=pipeline, **kw)
    wall = time.perf_counter() - t0
    for w, (dd, dh) in enumerate(zip(mgr.history, gpu.history)):
        assert dd.sizes.tolist() == dh.sizes.tolist(), f"{path} {w}: sizes"
        assert dd.policies == dh.policies and dd.feasible == dh.feasible
        assert dd.guard == dh.guard
        assert torch.equal(dd.sample_rates, dh.sample_rates)
        assert dd.partition.latency == dh.partition.latency
        assert rec["counts"][w] == grec["counts"][w], f"{path} {w}: counts"
        compare_states(f"{path} device pipeline, window {w}",
                       rec["states"][w], grec["states"][w])
    assert [(e.window, e.tenant, e.reason) for e in mgr.events] == \
        [(e.window, e.tenant, e.reason) for e in gpu.events]
    print(f"check: {path} manager, pipeline=\"{pipeline}\", "
          f"{len(windows)} window(s) on the card ({wall:.1f} s; monitor "
          f"{[round(x['monitor'], 4) for x in rec['stages']]} s a window, "
          f"{against} "
          f"{[round(x['monitor'], 4) for x in grec['stages'][:len(windows)]]}"
          f"; segments launches "
          f"{[x['cache_sim_segments_scan'] for x in rec['launches']]}) == "
          f"{against} run (decisions, events, per-tenant counts, LRU "
          f"states)")
    return mgr, rec


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


def control_plane_phase(dev) -> tuple[collections.Counter, int, int]:
    """Phase 9: the 1024-tenant control plane, seed and fused rows on the
    card, the heap walk on the CPU, then ``DeviceWindowPipeline``
    (``device_pipeline_phase``) and its sharded twin
    (``sharded_pipeline_phase``).  Returns the seed row's launches and the
    device and sharded pipelines' segments launches."""
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
        rows[row] = (curves, part, counts, wall)
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
    segments, single, small_card = device_pipeline_phase(
        dev, traces, capacity, rows["fused"][:2], heap, rows["fused"][3])
    t0 = time.perf_counter()
    sharded = sharded_pipeline_phase(dev, traces, capacity, single, heap,
                                     small_card)
    print(f"phase seconds: the sharded pipeline {time.perf_counter() - t0:.1f}"
          f" s")
    return rows["seed"][2], segments, sharded


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


def fault_plan_16():
    """Phase 11b(a)'s plan: the standard plan of slice 1's deployment and
    the device-rung specs of ``FAULT_DEVICE_SPECS``."""
    from repro_torch.core import FaultPlan, FaultSpec
    std = FaultPlan.standard(len(MSR_16), FAULT_WINDOWS, seed=0)
    return FaultPlan(std.specs + tuple(
        FaultSpec("pipeline", window=w, rung="device", count=n)
        for w, n in FAULT_DEVICE_SPECS), seed=std.seed)


def decision_key(d) -> tuple:
    """Everything a decision says, on the host (sample rates too)."""
    return (d.sizes.tolist(),
            None if d.sizes2 is None else d.sizes2.tolist(),
            [p.value for p in d.policies],
            None if d.policies2 is None else [p.value for p in d.policies2],
            bool(d.feasible), bool(d.quarantined), d.degraded, d.held,
            d.deferred, d.guard,
            None if d.sample_rates is None else d.sample_rates.tolist())


def same_summaries(what: str, got: dict, want: dict, skip=()) -> None:
    """Integers exactly, floats to rel 1e-12."""
    assert set(got) == set(want), f"{what}: summary keys differ"
    for k, v in want.items():
        if k in skip:
            continue
        assert (got[k] == v if isinstance(v, int)
                else abs(got[k] - v) <= 1e-12 * abs(v)), \
            f"{what}: summary {k}: {got[k]} vs {v}"


def device_extra(mgr) -> list:
    """The device-rung step-downs a ``pipeline="device"`` manager logs."""
    from repro_torch.core import DegradeEvent
    return [e for e in mgr.events
            if isinstance(e, DegradeEvent) and e.rung == "device"]


def fault_deployment(dev, fwindows) -> collections.Counter:
    """Phase 11b(a): slice 1's deployment under ``fault_plan_16()`` on the
    card (``pipeline="device"``) against the CPU (``pipeline="host"``)."""
    from repro_torch.core import StageProfile
    plan = fault_plan_16()
    kw = dict(faults=plan, demote_cooldown=FAULT_COOLDOWN)
    prof = StageProfile(dev)
    t0 = time.perf_counter()
    g, grec = run_windows(dev, fwindows, MSR_16, 6000, profile=prof,
                          pipeline="device", **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, crec = run_windows("cpu", fwindows, MSR_16, 6000, **kw)
    cpu_s = time.perf_counter() - t0
    launches = collections.Counter()
    for x in grec["launches"]:
        launches.update(x)
    dead = dict(FAULT_DEVICE_SPECS)
    # L1 blocks a window's replay runs with: the sizes going into it, none
    # in the window whose start loses the tier (a replay at capacity 0
    # counts nothing and launches no cache_sim_scan)
    lost = {e.window for e in g.events if e.reason == "tier_loss"}
    cap_in = [len(MSR_16) * 100] + [int(d.sizes.sum())
                                     for d in list(g.history)[:-1]]
    cap_in = [0 if w in lost else c for w, c in enumerate(cap_in)]
    for w, d in enumerate(g.history):
        evs = [f"{type(e).__name__[:-5]}:{e.reason}" + (f"@{e.rung}"
                                                        if getattr(e, "rung", "")
                                                        else "")
               for e in g.events if e.window == w]
        st = grec["stages"][w]
        print(f"fault window {w}: {grec['walls'][w]:.3f} s on the card "
              f"(CPU {crec['walls'][w]:.3f}), replayed at {cap_in[w]} L1 "
              f"blocks, monitor {st['monitor']:.4f} s, "
              f"pgd {st['pgd']:.4f} s; degraded={d.degraded or '-'} "
              f"quarantined={d.quarantined} held={list(d.held)} "
              f"deferred={list(d.deferred)} allocated={int(d.sizes.sum())} "
              f"policies {dict(collections.Counter(p.value for p in d.policies))}"
              f"; events {evs}; launches {json.dumps(grec['launches'][w])}")
        lw = grec["launches"][w]
        if cap_in[w] > 0:
            assert lw["cache_sim_scan"] > 0, \
                f"fault window {w}: no replay launch"
        # the device rung dispatches (one segments launch a width group)
        # except where every attempt died before the dispatch
        ran = not (w in dead and dead[w] > g.retry_limit)
        assert (lw["cache_sim_segments_scan"] > 0) == ran, \
            f"fault window {w}: segments launches {lw}"
        one, two = crec["host_tokens"][w]
        got = tuple(lw[k] for k in RO_KERNELS)
        assert got == (int(one > 0), int(two > 0)), \
            f"fault window {w}: RO replay launches {got}, CPU host token " \
            f"loops {(one, two)}"
    tenant_w = [w for w, n in FAULT_DEVICE_SPECS if n > g.retry_limit][0]
    calm = [w for w in range(1, len(fwindows))
            if not any(e.window == w for e in g.events)
            and w not in dead]
    ref_w = calm[0] if calm else 0
    print(f"per-tenant rung (window {tenant_w}): "
          f"{grec['walls'][tenant_w]:.3f} s, monitor "
          f"{grec['stages'][tenant_w]['monitor']:.4f} s, "
          f"{grec['launches'][tenant_w]['cache_sim_scan']} cache_sim_scan "
          f"launches; beside the device rung's window {ref_w}: "
          f"{grec['walls'][ref_w]:.3f} s, monitor "
          f"{grec['stages'][ref_w]['monitor']:.4f} s; card {card_s:.1f} s, "
          f"CPU {cpu_s:.1f} s for {len(fwindows)} windows")

    # the card against the CPU, window by window (a PGD tie is reported,
    # and the windows after it are not compared, as in phase 4)
    tie_at = None
    for w, (dg, dc) in enumerate(zip(g.history, c.history)):
        kg, kc = decision_key(dg), decision_key(dc)
        assert kg[2:9] == kc[2:9], f"fault window {w}: {kg[2:9]} vs {kc[2:9]}"
        compare_counts(w, grec["counts"][w], crec["counts"][w])
        stage = pgd_tie(dg, dc, grec["curves"][w])
        if stage is not None:
            print(f"PGD TIE in fault window {w} ({stage}): card {kg[0]} vs "
                  f"CPU {kc[0]}; later windows are not compared")
            tie_at = w
            break
        assert kg == kc, f"fault window {w}: {kg} vs {kc}"
        compare_states(f"fault window {w}", grec["states"][w],
                       crec["states"][w])
    assert len(g.history) == len(c.history) == len(fwindows)
    extra = device_extra(g)
    assert [(e.window, e.reason) for e in extra] == [(tenant_w, "stepdown")], \
        extra
    sg, sc = g.summary(), c.summary()
    if tie_at is None:
        assert [e for e in g.events if e not in extra] == list(c.events), \
            "fault event logs differ"
        same_summaries("fault deployment", sg, sc,
                       skip=("device_stepdowns", "degrade_events"))
        assert sg["degrade_events"] == sc["degrade_events"] + len(extra)
    assert (sg["device_stepdowns"], sc["device_stepdowns"]) == (1, 0)
    for k in FAULT_FINGERPRINTS:
        assert sg[k] > 0, f"fault deployment: no {k}"
    assert sg["guard_violations_actuated"] == 0
    print(f"check: fault deployment (16 tenants, {len(fwindows)} windows, "
          f"pipeline=\"device\") card == CPU pipeline=\"host\" (decisions, "
          f"per-tenant counts, LRU states with dirty bits, latencies to rel "
          f"1e-12, summaries, event logs) but the card's device step-down at "
          f"window {tenant_w}; fingerprints "
          f"{json.dumps({k: sg[k] for k in FAULT_FINGERPRINTS})}; "
          f"guard quarantines {sg['guard_quarantines']}, lkg decisions "
          f"{sg['lkg_decisions']}; launches {json.dumps(dict(launches))}")
    return launches


def bench_faults_trace(window: int, tenant: int):
    """``benchmarks/bench_faults.py``'s ``_trace`` (its seed formula and
    draws), as the port's tensor ``Trace``."""
    from repro_torch.core import Trace
    rng = np.random.default_rng(
        (BF_SEED * 1_000_003 + window * 8_191 + tenant * 131) & 0x7FFFFFFF)
    addrs = rng.integers(0, 2048, BF_ACCESSES)
    return Trace(torch.as_tensor(addrs),
                 torch.as_tensor(rng.random(BF_ACCESSES) < 0.55),
                 f"t{tenant}")


def bench_faults_phase(dev) -> collections.Counter:
    """Phase 11b(b): bench_faults' scenarios, reconvergence and
    default-off identity, on the card and the CPU."""
    from repro_torch.core import ECICacheManager, FaultPlan
    from repro_torch.data.scenarios import FAULT_SCENARIOS, replay_scenario
    cuda = dev.type == "cuda"
    launches = collections.Counter()

    def factory(device, faults=None):
        return lambda names: ECICacheManager(
            BF_CAPACITY, list(names), c_min=BF_C_MIN,
            initial_blocks=BF_C_MIN, faults=faults,
            demote_cooldown=FAULT_COOLDOWN, t_fast=1.0, t_slow=20.0,
            flush_cost=10.0, device=device)

    def on_both(fn):
        """fn(device) on the card (launches counted) and on the CPU."""
        out = []
        for device in (dev, torch.device("cpu")):
            if cuda:
                torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = fn(device)
            if cuda:
                torch.cuda.synchronize()
            if device.type == "cuda":
                launches.update(read_counts())
            out.append((res, time.perf_counter() - t0))
        return out

    def same_runs(what, g, c):
        assert [decision_key(d) for d in g.history] == \
            [decision_key(d) for d in c.history], f"{what}: decisions"
        assert list(g.events) == list(c.events), f"{what}: events"
        same_summaries(what, g.summary(), c.summary())
        _same_results(what, [t.result for t in g.tenants],
                      [t.result for t in c.tenants])

    fingerprint = {"faulted_tier_loss": "dirty_loss",
                   "faulted_straggler_burst": "straggler_windows",
                   "faulted_poisoned_join": "poisoned_windows"}
    for name, build in FAULT_SCENARIOS.items():
        fs = build(seed=BF_SEED)
        ((g, gi), gs), ((c, ci), cs) = on_both(
            lambda d: replay_scenario(fs.run, factory(d, fs.plan)))
        assert gi == ci
        same_runs(name, g, c)
        s = g.summary()
        assert s[fingerprint[name]] > 0, f"{name}: no {fingerprint[name]}"
        assert s["guard_violations_actuated"] == 0
        print(f"fault scenario {name}: card {gs:.2f} s, CPU {cs:.2f} s; "
              f"{len(g.history)} windows; {fingerprint[name]} "
              f"{s[fingerprint[name]]}, degrade events "
              f"{s['degrade_events']}, lkg decisions {s['lkg_decisions']}")

    names = [f"t{i}" for i in range(BF_TENANTS)]
    plan = FaultPlan.standard(BF_TENANTS, 8, seed=BF_SEED)
    k = plan.reconverge_bound(FAULT_COOLDOWN)
    last = plan.last_fault_window()
    n_windows = last + k + 2
    tapes = [[bench_faults_trace(w, t) for t in range(BF_TENANTS)]
             for w in range(max(n_windows, 8))]

    def reconverge(device):
        base, faulted = factory(device)(names), factory(device, plan)(names)
        for mgr in (base, faulted):
            for w in range(n_windows):
                mgr.run_window(tapes[w])
        return base, faulted

    ((gb, gf), gs), ((cb, cf), cs) = on_both(reconverge)
    same_runs("reconvergence, fault-free", gb, cb)
    same_runs("reconvergence, faulted", gf, cf)
    recovered_at = n_windows
    for w in range(n_windows - 1, -1, -1):
        db, df = gb.history[w], gf.history[w]
        if not (db.sizes.tolist() == df.sizes.tolist()
                and db.policies == df.policies
                and db.sizes2.tolist() == df.sizes2.tolist()):
            break
        recovered_at = w
    dirty = gf.summary()["dirty_loss"]
    assert recovered_at - last <= k, (recovered_at, last, k)
    assert 0 < dirty <= BF_CAPACITY, dirty
    assert gf.summary()["guard_violations_actuated"] == 0

    def disabled(device):
        plain = factory(device)(names)
        off = factory(device, FaultPlan((), seed=BF_SEED))(names)
        for mgr in (plain, off):
            for w in range(8):
                mgr.run_window(tapes[w])
        return plain, off

    ((gp, go), ds), ((cp, co), dcs) = on_both(disabled)
    for what, a, b in (("disabled plan (card)", go, gp),
                       ("disabled plan (CPU)", co, cp),
                       ("disabled plan, card vs CPU", go, co)):
        same_runs(what, a, b)
    assert go.summary() == gp.summary() and go.fault_tolerant
    print(f"check: bench_faults' settings card == CPU (decisions, events, "
          f"summaries, per-tenant counts): 3 fault scenarios with their "
          f"fingerprints; FaultPlan.standard({BF_TENANTS}, 8) over "
          f"{n_windows} windows recovers at window {recovered_at} (last "
          f"fault {last}, K {k}; card {gs:.2f} s, CPU {cs:.2f} s), dirty "
          f"loss {dirty}; the disabled plan bit-identical to no plan (card "
          f"{ds:.2f} s, CPU {dcs:.2f} s); launches "
          f"{json.dumps(dict(launches))}")
    return launches


def sharded_fault_run(dev, fwindows) -> collections.Counter:
    """Phase 11b(d): slice 1's deployment under ``pipeline="sharded"``
    over the default mesh (every card) with a dead sharded rung at window
    ``SHARDED_FAULT_WINDOW``, against the same plan's run under
    ``pipeline="device"`` on the card (where the sharded spec never
    fires): decisions, latencies, per-tenant counts, LRU states, events
    and summaries equal but the one sharded step-down."""
    from repro_torch.core import (DegradeEvent, FaultPlan, FaultSpec,
                                  StageProfile)
    from repro_torch.distributed import control_plane_mesh
    plan = FaultPlan((FaultSpec("pipeline", window=SHARDED_FAULT_WINDOW,
                                rung="sharded", count=99),), seed=0)
    runs, walls = {}, {}
    for pipe in ("sharded", "device"):
        t0 = time.perf_counter()
        runs[pipe] = run_windows(dev, fwindows, MSR_16, 6000,
                                 profile=StageProfile(dev), pipeline=pipe,
                                 faults=plan, demote_cooldown=FAULT_COOLDOWN)
        walls[pipe] = time.perf_counter() - t0
    (s, srec), (d, drec) = runs["sharded"], runs["device"]
    launches = collections.Counter()
    for w, (ds, dd) in enumerate(zip(s.history, d.history)):
        assert decision_key(ds) == decision_key(dd), f"sharded fault {w}"
        assert ds.partition.latency == dd.partition.latency
        compare_counts(w, srec["counts"][w], drec["counts"][w], rel=0.0)
        compare_states(f"sharded fault window {w}", srec["states"][w],
                       drec["states"][w])
        lw = srec["launches"][w]
        launches.update(lw)
        assert lw["cache_sim_segments_scan"] > 0, (w, lw)
        print(f"sharded fault window {w}: {srec['walls'][w]:.3f} s on the "
              f"card (pipeline=\"device\": {drec['walls'][w]:.3f}), monitor "
              f"{srec['stages'][w]['monitor']:.4f} s (device "
              f"{drec['stages'][w]['monitor']:.4f}); launches {json.dumps(lw)}")
    assert len(s.history) == len(fwindows)
    extra = [e for e in s.events
             if isinstance(e, DegradeEvent) and e.rung == "sharded"]
    assert [(e.window, e.reason) for e in extra] == \
        [(SHARDED_FAULT_WINDOW, "stepdown")], extra
    assert [e for e in s.events if e not in extra] == list(d.events)
    ss, sd = s.summary(), d.summary()
    assert (ss.pop("sharded_stepdowns"), sd.pop("sharded_stepdowns")) == \
        (1, 0)
    assert ss.pop("degrade_events") == sd.pop("degrade_events") + 1
    same_summaries("sharded fault run", ss, sd)
    print(f"check: sharded fault run ({len(fwindows)} windows, "
          f"pipeline=\"sharded\" over the default mesh of "
          f"{control_plane_mesh(device=dev).size} card(s), the sharded rung "
          f"dead at window {SHARDED_FAULT_WINDOW}) == the same plan under "
          f"pipeline=\"device\" (decisions, latencies, per-tenant counts, "
          f"LRU states, events, summaries) but its one sharded step-down; "
          f"card {walls['sharded']:.1f} s and {walls['device']:.1f} s")
    return launches


def fault_phase(dev, fwindows) -> collections.Counter:
    """Phase 11b: (a), (b) and (d); (c) runs in the serving phase."""
    launches = fault_deployment(dev, fwindows)
    launches.update(bench_faults_phase(dev))
    launches.update(sharded_fault_run(dev, fwindows[:SHARDED_FAULT_WINDOWS]))
    assert launches["cache_sim_scan"] > 0 and \
        launches["cache_sim_segments_scan"] > 0
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
    from repro_torch.kernels.mamba2_ssd.kernel import (chunk_scan,
                                                       chunk_state,
                                                       mamba2_ssd,
                                                       state_pass)
    from repro_torch.kernels.mamba2_ssd.ref import SWEEP as SSD_SWEEP
    from repro_torch.kernels.mamba2_ssd.ref import (SEQUENTIAL_CASES,
                                                    chunk_scan_ref,
                                                    chunk_state_ref,
                                                    mamba2_ssd_chunked,
                                                    mamba2_ssd_ref,
                                                    seg_from_dA,
                                                    state_pass_ref)
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
        # each pass against its plain version, from the plain version of
        # the pass before it (launches of the passes alone count none)
        s_want = chunk_state_ref(x, B, seg, chunk=chunk)
        h_want = state_pass_ref(s_want, seg, chunk=chunk)
        pairs = [("chunk_scan", chunk_scan(x, B, C, seg, h_want, chunk=chunk),
                  chunk_scan_ref(x, B, C, seg, h_want, chunk=chunk))]
        if s_want.numel():
            pairs += [("chunk_state", chunk_state(x, B, seg, chunk=chunk),
                       s_want),
                      ("state_pass", state_pass(s_want.clone(), seg,
                                                chunk=chunk), h_want)]
        for name, got_p, want_p in pairs:
            check_close(max_err, "mamba2_ssd", f"{name} BH={bh} S={s}",
                        got_p, want_p, 3e-6, float(want_p.abs().max()))
        names = ", ".join(name for name, _, _ in pairs)
        print(f"check: mamba2_ssd's passes ({names}) == their plain "
              f"versions at BH={bh} S={s} (3e-6 of the largest output)")


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


def attention_row(what: str, q, k, v, fa_kw: dict, launches: int,
                  prev_ms: float | None, max_err: dict) -> dict:
    """``flash_attention`` at inputs captured from a main path (the
    model's ``[B, H, S, D]`` views of its ``[B, S, H, D]`` projections,
    read in place): every element within 2^-6 |out| + 1e-4 max |out| of
    ``attention_ref``, then timed beside ``attention_ref``,
    ``blockwise_attention``, the layout copies the views save, one
    ``scaled_dot_product_attention`` call computing the same function
    (none when a window is set) and its bound.  Returns the kernel's
    row."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         blockwise_attention)
    F = torch.nn.functional
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
        f"flash_attention at the captured {what} inputs: {worst} of its limit"
    max_err["flash_attention"] = max(max_err["flash_attention"], err)
    print(f"check: flash_attention == attention_ref at the captured bf16 "
          f"{what} inputs q {list(q.shape)}, k/v {list(k.shape)} (strides "
          f"{list(q.stride())}): max err {err:.3g} (max |out| {top:.3g}, "
          f"mean |out| {typical:.3g}); the worst element at {worst:.3g} of "
          f"its limit 2^-6 |out| + 1e-4 max |out|")
    del got, want, want32, diff, limit
    ms = cuda_ms(lambda: flash_attention(q, k, v, **fa_kw), REPS)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **fa_kw), REPS // 4)
    blk_ms = cuda_ms(lambda: blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **fa_kw),
        REPS // 4)
    # what the port copied around the kernel before it took strides: q, k
    # and v to [B, H, S, D], the output (written [B, H, S, Dv]) back to
    # [B, S, H, Dv]
    out = torch.empty((*q.shape[:-1], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    copy_ms = cuda_ms(lambda: (q.contiguous(), k.contiguous(),
                               v.contiguous(),
                               out.transpose(1, 2).contiguous()), REPS)
    if fa_kw["window"] > 0:
        lib_ms, lib = None, "no single PyTorch call computes a window"
    else:
        gqa = k.shape[1] < q.shape[1]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=fa_kw["causal"], enable_gqa=gqa), REPS)
        lib = (f"scaled_dot_product_attention (is_causal={fa_kw['causal']},"
               f" enable_gqa={gqa}) {lib_ms:.3f} ms: kernel / library = "
               f"{ms / lib_ms:.2f}")
    nbytes, flops = attention_work(q, k, v, **fa_kw)
    bnd, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                  (flops / PEAK_BF16_PER_S * 1e3, "operations"))
    prev = "" if prev_ms is None else f" (before its redesign {prev_ms} ms)"
    print(f"flash_attention at {list(q.shape)} {q.dtype} ({what}, the "
          f"model's own views): {ms:.3f} ms{prev}, attention_ref "
          f"{plain_ms:.3f} ms, "
          f"blockwise_attention {blk_ms:.3f} ms; {lib}; the layout copies "
          f"the views save {copy_ms:.3f} ms a call; {flops / 1e9:.1f} "
          f"GFLOP, {nbytes / 1e6:.1f} MB: bound {bnd:.4f} ms by {by}; "
          f"kernel / bound = {ms / bnd:.1f}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
        "shape": what, "launches": launches,
        "max_abs_err": max_err["flash_attention"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib_ms}


def model_phase(dev, max_err: dict) -> list[dict]:
    """Phase 12: zamba2-7b at full width on the card.

    (a) bf16 from seed 0: ``prefill`` on 4 prompts of 2048 tokens (one
    warm-up call, then the counted one: 81 ``mamba2_ssd`` and 13
    ``flash_attention`` launches), then 4 requests of ``DECODE_PROMPT``
    tokens teacher-forced through ``decode_step`` and 32 greedy tokens (no
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
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.mamba2_ssd.kernel import (chunk_scan,
                                                       chunk_state,
                                                       mamba2_ssd,
                                                       state_pass)
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
    q, k, v = rows_in[0][0]
    rows = [attention_row(
        "zamba2-7b prefill", q, k, v,
        dict(causal=cfg.causal, window=cfg.window),
        pre_launches["flash_attention"], PREV_MS["flash_attention"],
        max_err)]
    del q, k, v
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
    # the kernel's 3xTF32 does three tensor-core products for each one
    bnd3 = max(nbytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_PER_S) * 1e3
    # each pass alone, on the previous pass's output (state_pass in place,
    # on states it has already passed over: its time is what is kept)
    states = chunk_state(x_dt, B, seg, chunk=chunk)
    h_in = state_pass(states.clone(), seg, chunk=chunk)
    pass_ms = [cuda_ms(lambda: chunk_state(x_dt, B, seg, chunk=chunk), REPS),
               cuda_ms(lambda: state_pass(states, seg, chunk=chunk), REPS),
               cuda_ms(lambda: chunk_scan(x_dt, B, C, seg, h_in,
                                          chunk=chunk), REPS)]
    del states, h_in
    print(f"mamba2_ssd at x_dt {list(x_dt.shape)}, B/C {list(B.shape)}, "
          f"chunk {chunk} (captured layer-0 prefill inputs): {ms:.3f} ms "
          f"(before its redesign {PREV_MS['mamba2_ssd']} ms; chunk_state "
          f"{pass_ms[0]:.3f} + state_pass {pass_ms[1]:.3f} + chunk_scan "
          f"{pass_ms[2]:.3f} ms alone), mamba2_ssd_chunked {plain_ms:.3f} "
          f"ms; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB: bound "
          f"{bnd:.4f} ms by {by} at fp32's 67 TFLOP/s, {bnd3:.4f} ms at a "
          f"third of TF32's 495; kernel / bound = {ms / bnd:.1f}")
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
    and 32; random tables, lengths mid-page, on a page edge and at 1) and
    ``ref.LONG_ROWS`` (rows of about 2048 positions at B 1 and 4, many
    splits; a row of length 0 must be 0), float32 (2e-5) and bfloat16
    (2e-2), and a second call giving the same bits (the splits merge in
    a fixed order)."""
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.paged_attention.ref import (LONG_ROWS, SWEEP,
                                                         paged_attention_ref,
                                                         sweep_arrays)
    for i, case in enumerate(SWEEP + LONG_ROWS):
        a = sweep_arrays(case, seed=i)
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            args = [torch.from_numpy(a[n]).to(dev) for n in PAGED_NAMES]
            args[:3] = [t.to(dtype) for t in args[:3]]
            live = args[4] > 0
            got = paged_attention(*args)
            check_close(max_err, "paged_attention", f"{case} {dtype}",
                        got[live], paged_attention_ref(*args)[live], tol)
            assert not bool(got[~live].any()), f"{case}: length 0 not 0"
            assert torch.equal(got, paged_attention(*args)), \
                f"{case} {dtype}: two calls differ"
    print(f"check: paged_attention == paged_attention_ref at {len(SWEEP)} "
          f"shapes (tests/test_kernels.py's sweep, qwen3's 16/8 heads of 128 "
          f"at page 8, 16, 32; lengths 1, mid-page, page edge) and "
          f"{len(LONG_ROWS)} long-row cases (B 1 and 4, about 2048 "
          f"positions, a length-0 row written 0) in float32 and bfloat16 "
          f"(2e-5 / 2e-2), two calls bit-equal; max err "
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
                 window, fault_tolerant=None):
    """The deployment: pool, manager, tiered cache and engine; the pool's
    ``allocate`` counts the engine's page-0 fallbacks (an unmanaged,
    tenant -2, allocation that returns None) and the most pages taken at
    once (``peak_pages``: the free list hands out page ids in one order
    whatever the pool's size, so a pool of more pages than that serves the
    same traffic the same way)."""
    from repro_torch.cache import BlockPool, TieredKVCache
    from repro_torch.core import ECICacheManager
    from repro_torch.serve.engine import MultiTenantEngine
    pool = BlockPool(n_pages, SERVE_PAGE, cfg.n_layers, cfg.n_kv_heads,
                     cfg.head_dim, dtype=getattr(torch, cfg.dtype),
                     device=dev)
    mgr = ECICacheManager(capacity, ["chat", "batchjob"], c_min=c_min,
                          initial_blocks=initial,
                          fault_tolerant=fault_tolerant, device=dev)
    tiered = TieredKVCache(pool, mgr, window_events=window)
    eng = MultiTenantEngine(cfg, params, tiered, page_size=SERVE_PAGE,
                            max_pages_per_seq=SERVE_MAX_PAGES)
    eng.fallbacks = eng.peak_pages = 0
    alloc = pool.allocate

    def allocate(tenant, *a, **k):
        pid, evicted = alloc(tenant, *a, **k)
        eng.fallbacks += tenant == -2 and pid is None
        eng.peak_pages = max(eng.peak_pages, pool.n_pages - len(pool.free))
        return pid, evicted
    pool.allocate = allocate
    return eng


def serve_run(eng, traffic, new_tokens: int, crash: bool = False) -> dict:
    """Submit the traffic and run the engine to the end, timing each
    prefill and decode step (host clock between synchronizes).  With
    ``crash`` the HBM pool fails after the first step
    (``TieredKVCache.fail_tier(1)``), two steps run with it down, and it
    recovers before the rest.  Returns what the runs are compared on and
    the times."""
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
    if crash:
        eng.step()
        eng.tiered.fail_tier(1)
        eng.step()
        eng.step()
        eng.tiered.recover_tier(1)
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
        "pages": [list(r.pages) for r in sorted(eng.completed,
                                                key=lambda r: r.rid)],
        "summary": summary, "pool_stats": dict(eng.pool.stats),
        "decisions": [(d.sizes.tolist(), [p.value for p in d.policies],
                       bool(d.feasible), d.sizes2.tolist(),
                       [p.value for p in d.policies2], d.guard)
                      for d in mgr.history],
        "fallbacks": eng.fallbacks, "peak_pages": eng.peak_pages,
        "wall": wall, "times": times,
        "aborted_restarts": eng.aborted_restarts,
        "manager_failures": {k: mgr.summary()[k] for k in (
            "dirty_loss", "tier_failures", "degrade_events")},
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


def regather_merge(q, k_self, v_self, att_pool, k_pg, tables, lens):
    """The merge the serving decode made before the in-flight token was
    folded into ``paged_attention`` (the reference's ``_merge_self``,
    ``src/repro/serve/engine.py:293``): the pool's log-sum-exp rebuilt
    from a second gather of every table page in fp32, the KV heads
    repeated, merged with the in-flight token's score.  Timed here beside
    the fold that replaced it."""
    from repro_torch.kernels.paged_attention.ref import gather_pages
    rep = q.shape[1] // k_self.shape[1]
    kr = k_self.repeat_interleave(rep, dim=1)
    vr = v_self.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kp = gather_pages(k_pg, tables).repeat_interleave(rep, dim=2)
    s_pool = torch.einsum("bhd,bkhd->bhk", q.float(), kp.float()) * scale
    pos = torch.arange(kp.shape[1], device=q.device)
    s_pool = torch.where(pos[None, None, :] < lens[:, None, None], s_pool,
                         -1e30)
    lse_pool = torch.logsumexp(s_pool, dim=-1)
    s_self = torch.einsum("bhd,bhd->bh", q.float(), kr.float()) * scale
    lse_all = torch.logaddexp(lse_pool, s_self)
    return (att_pool.float() * torch.exp(lse_pool - lse_all)[..., None]
            + vr.float() * torch.exp(s_self - lse_all)[..., None]
            ).to(att_pool.dtype)


def paged_row(what: str, cfg, args, kwargs, step_ms: float, launches: int,
              max_err: dict, shape: bool = False) -> dict:
    """``paged_attention`` at decode inputs captured from a serving path
    (``args``, and ``kwargs``: the in-flight token's ``k_self`` /
    ``v_self`` the engine folds in): with the fold and without, every
    element within 2^-6 |out| + 1e-4 max |out| of ``paged_attention_ref``
    on the same arguments, then timed beside it, beside the kernel without
    the fold and beside the composition the fold replaced (the kernel,
    then ``regather_merge``), the gather + ``scaled_dot_product_attention``
    reading and its bound, a call and the kernels alone (a CUDA graph of
    the calls), with its split count, and at the first 1 and 4 captured
    rows.  Returns the kernel's row (with ``shape`` when asked): ``ms``
    the call with the fold, as the serving decode makes it."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import (TILE,
                                                            paged_attention,
                                                            split_count)
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    L = cfg.n_layers
    q, kp, vp, tables, lens = args
    ks, vs = kwargs["k_self"], kwargs["v_self"]
    folds = paged_attention.self_folds
    for fold in (kwargs, {}):
        got = paged_attention(q, kp, vp, tables, lens, **fold)
        want = paged_attention_ref(q, kp, vp, tables, lens, **fold)
        want32, diff = want.float(), (got.float() - want.float()).abs()
        top, typical = float(want32.abs().max()), float(want32.abs().mean())
        worst = float((diff / (2.0 ** -6 * want32.abs() + 1e-4 * top)).max())
        err = float(diff.max())
        assert got.shape == want.shape and worst <= 1.0, \
            f"paged_attention at the captured inputs (fold {bool(fold)}): " \
            f"{worst} of its limit"
        max_err["paged_attention"] = max(max_err["paged_attention"], err)
        print(f"check: paged_attention == paged_attention_ref at the "
              f"captured bf16 {what} inputs "
              f"{'with' if fold else 'without'} the in-flight token (q "
              f"{list(q.shape)}, pages {list(kp.shape)}, tables "
              f"{list(tables.shape)}, lengths {lens.min().item()}.."
              f"{lens.max().item()}): max err {err:.3g} (max |out| "
              f"{top:.3g}, mean |out| {typical:.3g}); the worst element at "
              f"{worst:.3g} of its limit 2^-6 |out| + 1e-4 max |out|")
    assert paged_attention.self_folds == folds + 1

    def fused():
        return paged_attention(q, kp, vp, tables, lens, k_self=ks, v_self=vs)

    def unfused():
        return paged_attention(q, kp, vp, tables, lens)

    def composed():
        return regather_merge(q, ks, vs, unfused(), kp, tables, lens)
    comp_err = float((composed().float() - fused().float()).abs().max())
    ms = cuda_ms(fused, REPS)
    bare_ms = cuda_ms(unfused, REPS)
    comp_ms = cuda_ms(composed, REPS // 4)
    plain_ms = cuda_ms(lambda: paged_attention_ref(q, kp, vp, tables, lens,
                                                   k_self=ks, v_self=vs),
                       REPS // 4)
    b, hq, d = q.shape
    seq = torch.arange(tables.shape[1] * SERVE_PAGE, device=q.device)
    mask = (seq[None, :] < lens[:, None])[:, None, None, :]

    def gather_sdpa():
        k = gather_pages(kp, tables).transpose(1, 2)
        v = gather_pages(vp, tables).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask, enable_gqa=True)
    lib_err = float((gather_sdpa()[:, :, 0].float()
                     - paged_attention_ref(*args).float()).abs().max())
    lib_ms = cuda_ms(gather_sdpa, REPS)
    seen = int(lens.clamp(max=tables.shape[1] * SERVE_PAGE).sum())
    esize = q.element_size()
    nbytes = (seen * cfg.n_kv_heads * d * 2 * esize + 2 * q.numel() * esize
              + 4 * (tables.numel() + lens.numel()))
    flops = 4 * hq * d * seen
    bnd, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                  (flops / PEAK_BF16_PER_S * 1e3, "operations"))
    print(f"paged_attention at the {what} shape (B {b}, {seen} positions "
          f"seen): with the in-flight token folded in {ms:.4f} ms, without "
          f"it {bare_ms:.4f} ms, the composition it replaced (the kernel, "
          f"then regather_merge) {comp_ms:.3f} ms (max diff {comp_err:.3g}),"
          f" paged_attention_ref with the token {plain_ms:.3f} ms; a "
          f"reading: gather + scaled_dot_product_attention (two calls, no "
          f"token) {lib_ms:.3f} ms (max diff {lib_err:.3g}); "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: bound "
          f"{bnd:.4f} ms by {by}; kernel / bound = {ms / bnd:.1f}; of a "
          f"{step_ms:.2f} ms decode step, {L} fused launches are "
          f"{L * ms / step_ms:.1%}, where the {L} compositions they replace "
          f"would be {L * comp_ms / step_ms:.1%}")
    # the split count chosen, the kernels alone (a CUDA graph of the
    # calls), and the first 1 and 4 rows of the same captured inputs
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    pps = tables.shape[1]
    n_split, per = split_count(b, cfg.n_kv_heads, pps, SERVE_PAGE,
                               TILE[q.dtype], sms)
    alone = graph_ms(fused, REPS)
    bare_alone = graph_ms(unfused, REPS)
    prev = "" if shape else \
        f" (before its redesign {PREV_MS['paged_attention']} ms)"
    print(f"paged_attention at B {b}: {n_split} splits of {per} pages "
          f"({b * cfg.n_kv_heads * n_split} CTAs on {sms} SMs); per call "
          f"{ms:.4f} ms with the fold, {bare_ms:.4f} without{prev}; the "
          f"kernels alone (a CUDA graph of {REPS} calls) {alone:.4f} ms "
          f"with the fold, {bare_alone:.4f} without")
    for rows in (1, 4):
        sub = (q[:rows].contiguous(), kp, vp, tables[:rows].contiguous(),
               lens[:rows].contiguous())
        fold = dict(k_self=ks[:rows].contiguous(),
                    v_self=vs[:rows].contiguous())
        got_s = paged_attention(*sub, **fold).float()
        want_s = paged_attention_ref(*sub, **fold).float()
        lim = 2.0 ** -6 * want_s.abs() + 1e-4 * float(want_s.abs().max())
        assert bool(((got_s - want_s).abs() <= lim).all()), \
            f"paged_attention at the first {rows} captured rows"
        ns, ps = split_count(rows, cfg.n_kv_heads, pps, SERVE_PAGE,
                             TILE[q.dtype], sms)
        seen_s = int(sub[4].clamp(max=pps * SERVE_PAGE).sum())
        bytes_s = (seen_s * cfg.n_kv_heads * d * 2 * esize
                   + 2 * sub[0].numel() * esize
                   + 4 * (sub[3].numel() + sub[4].numel()))
        print(f"paged_attention at the first {rows} captured row(s) ({seen_s}"
              f" positions; {ns} splits of {ps} pages, "
              f"{rows * cfg.n_kv_heads * ns} CTAs; with the fold, within its "
              f"element limit): "
              f"{cuda_ms(lambda: paged_attention(*sub, **fold), REPS):.4f} "
              f"ms a call, "
              f"{graph_ms(lambda: paged_attention(*sub, **fold), REPS):.4f} "
              f"ms alone; bound {bytes_s / PEAK_BYTES_PER_S * 1e3:.4f} ms by "
              f"bytes")
    row = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/paged_attention/csrc/"
                     "paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:76",
           "launches": launches, "max_abs_err": None,
           "ms": ms, "alone_ms": alone, "no_fold_ms": bare_ms,
           "no_fold_alone_ms": bare_alone, "replaced_composition_ms": comp_ms,
           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "library_ms": None}
    if shape:
        row["shape"] = what
    return row


def serving_phase(dev, max_err: dict) -> list[dict]:
    """Phase 13: the multi-tenant serving path, qwen3-0.6b at full width.

    (a) bf16 from seed 0 over the 14 GiB pool: the two tenants' 32
    requests through ``MultiTenantEngine.run`` (counters 0 just before,
    read just after): 32 x 28 ``flash_attention`` launches in prefill and
    31 decode steps x 28 ``paged_attention``; no page-0 fallback; prefill
    and decode times, peak memory, the rebalances and the tiered summary.
    (b) ``paged_attention`` at the captured layer-0 decode inputs against
    ``paged_attention_ref`` element by element (two bf16 steps plus 1e-4
    of max |out|), with the in-flight token and without, timed beside the
    plain version, the composition the fold replaced, the
    gather + ``scaled_dot_product_attention`` reading and its bound.  (c)
    the same traffic through the plain versions on the card (neither
    kernel launched): summaries, pool stats, quotas, policies and
    decisions exactly equal; then the model in fp32 through both (tokens
    equal, last logits within 1e-4 of max |logit|) and the bf16 tokens
    held by the model phase's rule.  (d) 2 layers at full width in fp32,
    reduced traffic: the card against the port's CPU engine, exactly,
    logits within 1e-5.  Also ``flash_attention`` at the captured layer-0
    prefill inputs (``attention_row``).  Returns the two kernels' rows."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.models.attention as attention
    import repro_torch.serve.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
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
            Recorder(fa_ops, "flash_attention") as fa_rec:
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

    # ------ (b) the kernels at the captured layer-0 prefill and decode
    # inputs
    fa_row = attention_row(
        "qwen3-0.6b serving prefill", *fa_rec.args[:3],
        dict(causal=fa_rec.kwargs["causal"], window=fa_rec.kwargs["window"]),
        launches["flash_attention"], None, max_err)
    fa_rec.args = None
    print(f"serving prefill: {sum(pre) * 1e3 / n_req:.2f} ms a request "
          f"(median {np.median(pre) * 1e3:.2f} ms), {L} flash_attention "
          f"launches a request at {fa_row['ms']:.3f} ms each: "
          f"{L * fa_row['ms'] / (np.median(pre) * 1e3):.1%} of a request")
    row = paged_row("decode", cfg, pa_rec.args, pa_rec.kwargs, step_ms,
                    launches["paged_attention"], max_err)
    del eng
    pa_rec.args = pa_rec.kwargs = None
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

    # ----- (e) the same, the pool crashing after the first step (11b(c))
    crashed = {}
    for where, prm in ((dev, rp), (torch.device("cpu"), _to(rp, "cpu"))):
        t0 = time.perf_counter()
        zero_counts()
        r = serve_run(serve_engine(rcfg, prm, where, **SERVE_REDUCED,
                                   fault_tolerant=True),
                      small, SERVE_REDUCED_NEW, crash=True)
        crashed[where.type] = (r, read_counts(), time.perf_counter() - t0)
    (g, glaunch, gs), (c, _, cs) = crashed[dev.type], crashed["cpu"]
    compare_serving("pool crash card vs CPU", g, c)
    assert g["tokens"] == c["tokens"], "pool crash: tokens differ"
    assert g["tokens"] == out[dev.type][0]["tokens"], \
        "pool crash: the restarted requests' tokens differ from the run " \
        "without the crash"
    assert g["aborted_restarts"] == c["aborted_restarts"] == len(small)
    assert g["manager_failures"] == c["manager_failures"]
    fs = g["summary"]
    assert (fs["tier_failures"], fs["tiers_down"]) == (1, []) and \
        fs["dropped_pages"] > 0 and g["manager_failures"]["tier_failures"] == 1
    # every request prefilled twice: before the crash and after it
    assert glaunch["flash_attention"] == \
        (len(small) + g["aborted_restarts"]) * SERVE_REDUCED_LAYERS, glaunch
    assert glaunch["paged_attention"] > 0
    row["fault_launches"] = glaunch["paged_attention"]
    fa_row["fault_launches"] = glaunch["flash_attention"]
    print(f"check: pool crash after the first step, reduced depth, card "
          f"({gs:.1f} s) vs CPU ({cs:.1f} s): tokens (equal to the run "
          f"without the crash), aborted_restarts {g['aborted_restarts']}, "
          f"summaries (tier_failures {fs['tier_failures']}, dropped_pages "
          f"{fs['dropped_pages']}, dirty_loss {fs['dirty_loss']}, "
          f"rerouted_writes {fs['rerouted_writes']}), the manager's "
          f"{json.dumps(g['manager_failures'])} and decisions equal; "
          f"flash_attention {glaunch['flash_attention']} launches "
          f"({len(small)} first prefills and {g['aborted_restarts']} second "
          f"ones x {SERVE_REDUCED_LAYERS} layers), paged_attention "
          f"{glaunch['paged_attention']}")
    row["max_abs_err"] = max_err["paged_attention"]
    fa_row["max_abs_err"] = max_err["flash_attention"]
    return [row, fa_row]


class ShapeRecorder(Recorder):
    """A ``Recorder`` of ``flash_attention``-like calls that keeps the
    first call's arguments for each (q's shape, k's shape, causal) and
    counts the calls of each in ``by_key``."""

    def __enter__(self):
        self.first, self.by_key = {}, collections.Counter()

        def wrapped(*a, **k):
            self.calls += 1
            key = (tuple(a[0].shape), tuple(a[1].shape), k.get("causal"))
            self.first.setdefault(key, (a, k))
            self.by_key[key] += 1
            return self.fn(*a, **k)
        setattr(self.module, self.name, wrapped)
        return self


class FfnTimer:
    """Wraps the model's and the engine's ``_ffn`` (both still run): CUDA
    events around every call, split into prefill calls (S > 1) and decode
    calls (S = 1), and the routed experts' dropped choices of the prefill
    calls, summed on the card (``layers.moe_route`` wrapped too)."""

    def __init__(self, *modules):
        from repro_torch.models import layers
        self.modules, self.layers = modules, layers
        self.events = {"prefill": [], "decode": []}
        self.dropped = self.choices = 0

    def __enter__(self):
        self.saved = [m._ffn for m in self.modules]
        self.saved_route = self.layers.moe_route

        def make(fn):
            def ffn(p, hn, cfg):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = fn(p, hn, cfg)
                t1.record()
                self.events["decode" if hn.shape[1] == 1 else
                            "prefill"].append((t0, t1))
                return out
            return ffn

        def route(x, p, cfg):
            r = self.saved_route(x, p, cfg)
            if x.shape[1] > 1:
                self.dropped = self.dropped + (~r.keep).sum()
                self.choices += r.keep.numel()
            return r
        for m, fn in zip(self.modules, self.saved):
            m._ffn = make(fn)
        self.layers.moe_route = route
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            m._ffn = fn
        self.layers.moe_route = self.saved_route

    def ms(self, kind: str) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[kind])


class RouteLog:
    """Wraps ``layers.moe_route`` (which still runs) and keeps each call's
    expert ids and, per token, the gap between its k-th and (k+1)-th
    router logits over its largest |logit| (the call's routing margin)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.calls = layers, []

    def __enter__(self):
        self.saved = self.layers.moe_route

        def route(x, p, cfg):
            r = self.saved(x, p, cfg)
            logits = x.float() @ p["router"].float()
            top = logits.topk(cfg.top_k + 1, dim=-1).values
            gap = (top[..., -2] - top[..., -1]) / logits.abs().amax(-1)
            self.calls.append((r.idx, gap))
            return r
        self.layers.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.saved


def route_differences(got: RouteLog, want: RouteLog, layers: int,
                      pages: list | None = None) -> dict:
    """Call by call (both runs route in the same order: each prefill
    request's ``layers`` calls in rid order, then each decode step's, a
    row a request): the token-layers routed and routed apart (their sets
    of chosen experts differ), ``want``'s routing margins at each
    request's first difference (``margins``), and the requests with a
    difference (``touched``).  Past a request's first
    difference its tokens' inputs differ (the flipped token's hidden state,
    and through attention the rest of its request), so later differences
    are consequences; so is a decode difference of a request that shares a
    page (``pages``: each request's page ids) with a request whose prefill
    differed, since it reads the KV that prefill wrote (``excused``)."""
    assert len(got.calls) == len(want.calls)
    share = [set() for _ in pages or []]
    for i, a in enumerate(pages or []):
        for j, b in enumerate(pages):
            if i != j and set(a) & set(b):
                share[i].add(j)
    out = {"routed": 0, "apart": 0, "margins": [], "touched": set(),
           "excused": set()}
    touched, prefill_touched, prefill_calls = out["touched"], set(), 0
    for (gi, _), (wi, wgap) in zip(got.calls, want.calls):
        # the chosen set: an order swap inside the top k (two of its
        # logits near a tie) leaves the gates, queues and output as they
        # were
        diff = (gi.sort(-1).values != wi.sort(-1).values).any(-1)  # [B, S]
        out["routed"] += diff.numel()
        out["apart"] += int(diff.sum())
        prefill = gi.shape[1] > 1                # a prefill call, B = 1
        if prefill:
            first = {prefill_calls // layers: diff[0]}
            prefill_calls += 1
        else:                                    # a decode step, S = 1
            first = {i: diff[i] for i in
                     diff.any(-1).nonzero().flatten().tolist()}
        for req, d in first.items():
            if req in touched or not bool(d.any()):
                continue
            touched.add(req)
            if prefill:
                prefill_touched.add(req)
            elif share and share[req] & prefill_touched:
                out["excused"].add(req)
                continue
            gaps = wgap[0] if prefill else wgap[req]
            out["margins"].append(float(gaps[d].max()))
    return out


def hold_routed(what: str, got: RouteLog, want: RouteLog, layers: int,
                pairs, pages: list | None = None) -> str:
    """The MoE runs' fp32 rule (``route_differences``): routing equal
    until each request's first difference, which must be at near ties
    (margin <= ``MOE_NEAR_TIE`` of the token's largest |logit|: summation
    order can flip a top-k there, and the choice is discrete) unless it is
    downstream of another request's prefill difference, and each (got,
    want) pair of logits [requests, V] within 1e-4 of max |logit| in every
    request whose routing was equal at every layer, prefill and decode.
    Returns what it found, for the check's line."""
    r = route_differences(got, want, layers, pages)
    margin = max(r["margins"], default=0.0)
    print(f"{what}: first differences at routing margins "
          f"{sorted(r['margins'])} of max |logit|; requests touched "
          f"{sorted(r['touched'])}, of which downstream of a shared page "
          f"{sorted(r['excused'])}")
    assert margin <= MOE_NEAR_TIE, \
        f"{what}: routing apart at a margin of {margin} (> {MOE_NEAR_TIE})"
    errs = []
    for g, w in pairs:
        row = ((g.float() - w.float()).abs().amax(-1)
               / w.float().abs().max()).tolist()
        clean = [e for i, e in enumerate(row) if i not in r["touched"]]
        worst = max(clean, default=0.0)
        assert worst <= 1e-4, f"{what}: logits {worst} of max |logit|"
        errs.append(f"{worst:.3g} ({max(row):.3g} with the touched)")
    return (f"{r['apart']} of {r['routed']} token-layers routed apart, "
            f"{len(r['margins'])} first differences at near ties (largest "
            f"margin {margin:.3g} of max |logit|, limit {MOE_NEAR_TIE}), "
            f"{len(r['excused'])} downstream of a shared page; logits "
            f"within {', '.join(errs)} of max |logit| where routing agreed "
            f"(tolerance 1e-4)")


def moe_serving_phase(dev, max_err: dict) -> list[dict]:
    """Phase 13b: the MoE serving path, qwen2-moe-a2.7b at full width.

    (a) bf16 from seed 0 over a 24 GiB pool of 8192 16-token pages (the
    manager, tenants and traffic of phase 13): 32 x 24 ``flash_attention``
    launches in prefill and 31 decode steps x 24 ``paged_attention`` (a
    KV group of 1), counted; no page-0 fallback; prefill and decode times,
    the MoE FFN's share of each (CUDA events) and the routed experts' drop
    share in prefill.  (b) both kernels at the captured layer-0 inputs
    (``attention_row``, ``paged_row``).  (c) the same traffic through the
    plain versions on the card: summaries, pool stats, quotas, policies and
    decisions exactly equal; then in fp32 through both, over a pool of the
    pages the bf16 run took at once (the fp32 weights, 57 GB, leave no room
    for 8192 fp32 pages): the same equalities, fp32 tokens equal, last
    logits within 1e-4 of max |logit|, the bf16 tokens held by the model
    phase's rule.  (d) 2 layers at full width in fp32, 2 requests a tenant
    and 8 new tokens: the card against the port's CPU engine (tokens,
    summaries and decisions equal, logits within 1e-4 of max |logit|).
    Returns the two kernels' rows."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.models.attention as attention
    import repro_torch.serve.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.layers import moe_capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
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
    print(f"MoE serving: {cfg.name} at full width ({L} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}; {cfg.n_experts} routed experts, top "
          f"{cfg.top_k}, expert d_ff {cfg.expert_d_ff}, shared d_ff "
          f"{cfg.shared_d_ff}, capacity factor {cfg.capacity_factor}; vocab "
          f"{V}); n_params() {cfg.n_params():,}, {_leaf_count(params):,} in "
          f"the tree, {cfg.dtype} from seed {SERVE_SEED} in "
          f"{time.perf_counter() - t0:.1f} s; pool {SERVE_POOL} pages of "
          f"{SERVE_PAGE} tokens ({page_bytes / 2**20:.2f} MiB a page, "
          f"{SERVE_POOL * page_bytes / 2**30:.2f} GiB); the phase 13 "
          f"manager and traffic ({n_req} requests, {SERVE_NEW} new tokens)")

    # ------------------------------------ (a) the main path, bf16
    want_fa, want_pa = n_req * L, (SERVE_NEW - 1) * L
    eng = serve_engine(cfg, params, dev, **full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Tap(engine_mod, V) as tap, \
            Recorder(engine_mod, "paged_attention") as pa_rec, \
            Recorder(fa_ops, "flash_attention") as fa_rec, \
            FfnTimer(M, engine_mod) as ffn:
        zero_counts()
        run = serve_run(eng, traffic, SERVE_NEW)
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches["flash_attention"] == want_fa and \
        launches["paged_attention"] == want_pa, \
        f"MoE serving launches {launches}, predicted flash_attention " \
        f"{want_fa}, paged_attention {want_pa}"
    assert run["fallbacks"] == 0, f"{run['fallbacks']} page-0 fallbacks"
    assert all(len(t) == SERVE_NEW and all(0 <= x < V for x in t)
               for t in run["tokens"])
    assert bool(torch.isfinite(tap.last).all())
    pre, dec = run["times"]["prefill"], run["times"]["decode"]
    step_ms = float(np.median(dec)) * 1e3
    ffn_pre, ffn_dec = ffn.ms("prefill"), ffn.ms("decode")
    drop = int(ffn.dropped) / max(ffn.choices, 1)
    s = run["summary"]
    print(f"MoE serving bf16 (kernels): {run['wall']:.2f} s; prefill "
          f"{sum(pre) * 1e3:.1f} ms for {n_req} requests (median "
          f"{np.median(pre) * 1e3:.2f} ms a request, "
          f"{run['prompt_tokens'] / sum(pre):.0f} tokens/s); decode "
          f"{len(dec)} steps at B {n_req}: median {step_ms:.2f} ms a step "
          f"(min {min(dec) * 1e3:.2f}, max {max(dec) * 1e3:.2f}; "
          f"{n_req / np.median(dec):.0f} tokens/s); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)} "
          f"(flash_attention {want_fa}, paged_attention {want_pa} "
          f"predicted); page-0 fallbacks 0; {run['peak_pages']} pages taken "
          f"at once")
    print(f"MoE FFN (CUDA events around each call): prefill "
          f"{ffn_pre:.1f} ms of {sum(pre) * 1e3:.1f} ms "
          f"({ffn_pre / (sum(pre) * 1e3):.1%}), decode {ffn_dec:.1f} ms of "
          f"{sum(dec) * 1e3:.1f} ms ({ffn_dec / (sum(dec) * 1e3):.1%}; "
          f"{ffn_dec / len(dec):.2f} ms a step, every expert for every "
          f"row); routed choices dropped in prefill {int(ffn.dropped)} of "
          f"{ffn.choices} ({drop:.2%}; {moe_capacity(cfg, BATCH_PROMPT, cfg.n_experts)}"
          f" slots an expert in a {BATCH_PROMPT}-token request)")
    print(f"MoE serving tiered summary: hbm_hit_ratio "
          f"{s['hbm_hit_ratio']:.4f}, hbm_writes {s['hbm_writes']}, "
          f"bypassed_writes {s['bypassed_writes']}, resident_pages "
          f"{s['resident_pages']}, quotas {s['quotas']}, policies "
          f"{s['policies']}; pool stats {run['pool_stats']}; "
          f"{run['rebalances']} rebalances in {run['rebalance_s']:.3f} s")

    # ------------------ (b) the kernels at the captured layer-0 inputs
    fa_row = attention_row(
        f"{cfg.name} serving prefill", *fa_rec.args[:3],
        dict(causal=fa_rec.kwargs["causal"], window=fa_rec.kwargs["window"]),
        launches["flash_attention"], None, max_err)
    fa_rec.args = None
    print(f"MoE serving prefill: {L} flash_attention launches a request at "
          f"{fa_row['ms']:.3f} ms each: "
          f"{L * fa_row['ms'] / (np.median(pre) * 1e3):.1%} of a request "
          f"(median {np.median(pre) * 1e3:.2f} ms), the MoE FFN "
          f"{ffn_pre / n_req:.2f} ms a request")
    pa_row = paged_row(f"{cfg.name} serving decode (KV group 1)", cfg,
                       pa_rec.args, pa_rec.kwargs, step_ms,
                       launches["paged_attention"], max_err, shape=True)
    del eng
    pa_rec.args = pa_rec.kwargs = None
    free_cards()

    # ---- (c) the plain versions on the card; the model in fp32 as well
    def plain(prm, c, pool):
        saved = (engine_mod.paged_attention, attention.prefill_attention)
        engine_mod.paged_attention = paged_attention_ref
        attention.prefill_attention = blockwise_attention
        try:
            with Tap(engine_mod, V) as t:
                zero_counts()
                out = serve_run(serve_engine(c, prm, dev, **pool), traffic,
                                SERVE_NEW)
                got = read_counts()
            assert got["flash_attention"] == got["paged_attention"] == 0, \
                f"the plain run launched {got}"
        finally:
            engine_mod.paged_attention, attention.prefill_attention = saved
        free_cards()
        return out, t

    plain16, ptap16 = plain(params, cfg, full)
    compare_serving("MoE bf16 plain vs kernels", plain16, run)
    del params
    free_cards()
    pool32 = {**full, "n_pages": run["peak_pages"] + 4 * SERVE_PAGE}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init_params(cfg32, seed=SERVE_SEED, device=dev)
    with Tap(engine_mod, V) as ktap32, RouteLog() as kroute:
        kern32 = serve_run(serve_engine(cfg32, params32, dev, **pool32),
                           traffic, SERVE_NEW)
    peak32 = torch.cuda.max_memory_allocated()
    free_cards()
    with RouteLog() as proute:
        plain32, ptap32 = plain(params32, cfg32, pool32)
    del params32
    free_cards()
    compare_serving("MoE fp32 kernels vs bf16 kernels", kern32, run)
    compare_serving("MoE fp32 plain vs fp32 kernels", plain32, kern32)
    assert kern32["peak_pages"] == run["peak_pages"]
    assert kern32["tokens"] == plain32["tokens"], "MoE fp32 tokens differ"
    # fp32: the kernels and the plain versions sum in other orders (about
    # 1e-6 relative), which can flip a router's top-k where two experts'
    # logits nearly tie (hold_routed)
    routed32 = hold_routed("MoE fp32 kernels vs plain", kroute, proute, L,
                           [(ktap32.last, ptap32.last)], kern32["pages"])
    del kroute, proute
    print(f"check: MoE fp32 routing and last logits, kernels vs plain: "
          f"{routed32}")
    noise = _rel(torch.cat(ptap16.prefill), torch.cat(ptap32.prefill))
    held, ties = held_tokens(run, plain16, plain32,
                             ptap32.request_leads(), noise)
    same16 = sum(a == b for a, b in zip(run["tokens"], plain16["tokens"]))
    print(f"check: MoE serving, kernels vs plain versions on the card over "
          f"all {n_req} requests: summaries, pool stats, quotas, policies "
          f"and decisions equal in bf16 and fp32 (fp32 over a pool of "
          f"{pool32['n_pages']} pages, peak device memory "
          f"{peak32 / 2**30:.2f} GiB); fp32 tokens equal; bf16: {held} "
          f"tokens held, {ties} near ties let go (fp32 lead <= {noise:.3g} "
          f"of max |logit|), {same16} of {n_req} requests' tokens "
          f"identical; bf16 plain {plain16['wall']:.2f} s, fp32 kernels "
          f"{kern32['wall']:.2f} s, fp32 plain {plain32['wall']:.2f} s")

    # ------------- (d) reduced depth, full width, fp32: card vs CPU
    rcfg = dataclasses.replace(cfg, n_layers=MOE_REDUCED_LAYERS,
                               dtype="float32")
    rp = M.init_params(rcfg, seed=SERVE_SEED, device=dev)
    small = serve_traffic(V, per_tenant=MOE_REDUCED_PER_TENANT)
    out = {}
    for where, prm in ((dev, rp), (torch.device("cpu"), _to(rp, "cpu"))):
        t0 = time.perf_counter()
        with Tap(engine_mod, V) as t, RouteLog() as rl:
            zero_counts()
            r = serve_run(serve_engine(rcfg, prm, where, **SERVE_REDUCED),
                          small, MOE_REDUCED_NEW)
            got = read_counts()
        out[where.type] = (r, t, got, time.perf_counter() - t0, rl)
    (g, gt, glaunch, gs, grl), (c, ct, _, cs, crl) = out[dev.type], \
        out["cpu"]
    assert (glaunch["flash_attention"], glaunch["paged_attention"]) == (
        len(small) * MOE_REDUCED_LAYERS,
        (MOE_REDUCED_NEW - 1) * MOE_REDUCED_LAYERS), glaunch
    compare_serving("MoE reduced depth card vs CPU", g, c)
    assert g["tokens"] == c["tokens"], "MoE reduced depth: tokens differ"
    grl.calls = [(i.cpu(), gap.cpu()) for i, gap in grl.calls]
    routed_r = hold_routed("MoE reduced depth card vs CPU", grl, crl,
                           MOE_REDUCED_LAYERS,
                           [(torch.cat(gt.prefill).cpu(),
                             torch.cat(ct.prefill)),
                            (gt.last.cpu(), ct.last)], g["pages"])
    print(f"check: MoE reduced depth ({MOE_REDUCED_LAYERS} layers, full "
          f"width, fp32; {len(small)} requests of "
          f"{sorted({len(p) for _, p in small})} tokens, {MOE_REDUCED_NEW} "
          f"new each; {g['rebalances']} rebalances) card ({gs:.1f} s) vs CPU "
          f"({cs:.1f} s): tokens, summaries, pool stats and decisions "
          f"equal; {routed_r} (prefill, then the last decode step)")
    del rp
    free_cards()
    fa_row["max_abs_err"] = max_err["flash_attention"]
    pa_row["max_abs_err"] = max_err["paged_attention"]
    return [fa_row, pa_row]


def sdpa_backends(q, k, v, causal: bool) -> dict:
    """``scaled_dot_product_attention`` at these inputs with each of
    PyTorch's fused backends alone: its ms by CUDA events, or the reason
    it refused the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    gqa = k.shape[1] < q.shape[1]
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def call():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=gqa)
        try:
            with sdpa_kernel([backend]):
                call()
                torch.cuda.synchronize()
                out[backend.name] = cuda_ms(call, REPS)
        except RuntimeError as e:
            out[backend.name] = "refused (" + str(e).strip().split(".")[0] \
                + ")"
    return out


def fa_instance_pair(q, k, v, causal: bool, max_err: dict) -> tuple:
    """MLA's bf16 (96, 64) attention on contiguous ``[B, H, S, D]`` copies
    of the captured inputs through the <6, 1> instance (the wrapper) and
    through the padded <8, 2> path it replaced (the library called with q
    and k zero-padded to 128 columns and the scale of 96: what D = 96 ran
    before, there zero-filled by TMA past column 96), each held element by
    element to ``attention_ref``.  Returns (ms of <6, 1>, ms of <8, 2>)."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import attention_ref
    F = torch.nn.functional
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    b, hq, sq, d = qc.shape
    hkv, skv, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    qp = F.pad(qc, (0, 128 - d)).contiguous()
    kp = F.pad(kc, (0, 128 - d)).contiguous()
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (qp, kp, vc, out) for st in fak._strides(t)))
    lib = fak._lib()

    def padded():
        err = lib.flash_attention(
            qp.data_ptr(), kp.data_ptr(), vc.data_ptr(), out.data_ptr(),
            strides, b, hq, hkv, sq, skv, 128, dv, 1.0 / math.sqrt(d),
            int(causal), 0, fak.DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"flash_attention <8, 2> launch failed ({err})"
        return out

    want = attention_ref(qc, kc, vc, causal=causal).float()
    limit = 2.0 ** -6 * want.abs() + 1e-4 * float(want.abs().max())
    for name, got in (("<6, 1>", fak.flash_attention(qc, kc, vc,
                                                     causal=causal)),
                      ("<8, 2>", padded())):
        diff = (got.float() - want).abs()
        worst = float((diff / limit).max())
        assert worst <= 1.0, f"flash_attention {name}: {worst} of its limit"
        max_err["flash_attention"] = max(max_err["flash_attention"],
                                         float(diff.max()))
    new_ms = cuda_ms(lambda: fak.flash_attention(qc, kc, vc, causal=causal),
                     REPS)
    old_ms = cuda_ms(padded, REPS)
    return new_ms, old_ms


def family_model_phase(dev, max_err: dict, arch: str) -> list[dict]:
    """Phase 13c (MLA, minicpm3-4b) and 13d (encoder-decoder,
    seamless-m4t-large-v2) at full width and depth on the card.

    (a) bf16 from seed 0: ``prefill`` (one warm-up call, then the counted
    one): minicpm3 on 4 prompts of 2048 tokens, 62 ``flash_attention``
    launches on the <6, 1> instance; seamless on 4 x 1024 encoder frames
    of seeded normal embeddings and 4 decoder prompts of 256 tokens, 72
    launches (24 encoder, non-causal; 24 decoder self, causal; 24 cross,
    non-causal, Sq 256 over Skv 1024).  Then ``decode_step``: minicpm3
    teacher-forces 4 prompts of 256 tokens (the absorbed MLA decode) and
    takes 32 greedy tokens; seamless fills each decoder layer's cross
    caches with ``cross_attention_kv`` from the encoder's output, then
    teacher-forces its 256-token prompts and takes 32 greedy tokens; no
    launch.  (b) the same prefill through the plain versions on the card,
    and in fp32 through both, as phase 12: fp32 last logits within 1e-4
    of max |logit|, greedy tokens equal; bf16 greedy tokens equal to the
    plain run's.  (c) 2 layers (and 2 encoder layers) at full width in
    fp32: prefill against teacher-forced decode over 256 tokens (2e-4,
    the reference's bound), and the card against the CPU (1e-4).  (d)
    each captured prefill shape held to ``attention_ref`` element by
    element and timed (``attention_row``) beside
    ``scaled_dot_product_attention`` with each fused backend alone; for
    MLA also the <6, 1> instance beside the padded <8, 2> path.  Returns
    the ``flash_attention`` rows, one a shape."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.models import model as M
    from repro_torch.models.attention import cross_attention_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    V = cfg.vocab_size
    encdec = cfg.n_enc_layers > 0
    per_layer = 3 if encdec else 1
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=MODEL_SEED, device=dev)
    torch.cuda.synchronize()
    attn = (f"MLA: {cfg.n_heads} heads, q_lora {cfg.q_lora_rank}, kv_lora "
            f"{cfg.kv_lora_rank}, nope {cfg.qk_nope_dim} + rope "
            f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}" if not encdec else
            f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
            f"{cfg.n_heads} heads of {cfg.head_dim}, the speech frontend a "
            f"stub")
    print(f"model: {cfg.name} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}; {attn}; d_ff {cfg.d_ff}, vocab {V}); n_params() "
          f"{cfg.n_params():,}, {_leaf_count(params):,} in the tree, "
          f"{cfg.dtype} from seed {MODEL_SEED} in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(MODEL_SEED)
    if encdec:
        shape = (ENC_ROWS, DEC_PROMPT)
        enc = torch.as_tensor(rng.standard_normal(
            (ENC_ROWS, ENC_FRAMES, cfg.d_model)), dtype=torch.float32,
            device=dev)
    else:
        shape, enc = PREFILL_SHAPE, None
    prompts = torch.as_tensor(rng.integers(0, V, shape), device=dev)

    def enc_kw(dtype, rows=None):
        if enc is None:
            return {}
        return {"enc_embeds": enc[:rows].to(dtype)}

    bf16 = torch.bfloat16
    want_fa = per_layer * cfg.n_layers
    with ShapeRecorder(fa_ops, "flash_attention") as fa_rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, prompts, **enc_kw(bf16))          # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        fa_rec.by_key.clear()
        zero_counts()
        t0 = time.perf_counter()
        logits = M.prefill(params, cfg, prompts, **enc_kw(bf16))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_launches = read_counts()
    by_shape = fa_rec.by_key
    pre_peak = torch.cuda.max_memory_allocated()
    assert pre_launches["flash_attention"] == want_fa and \
        sum(pre_launches.values()) == want_fa, \
        f"{cfg.name} prefill launches {pre_launches}, predicted {want_fa}"
    assert logits.shape == (shape[0], cfg.padded_vocab())
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    ntok = shape[0] * shape[1]
    frames = f" over {ENC_ROWS} x {ENC_FRAMES} encoder frames" if encdec \
        else ""
    print(f"{cfg.name} prefill {shape[0]} x {shape[1]}{frames} bf16: "
          f"{prefill_s * 1e3:.1f} ms ({ntok / prefill_s:.0f} decoder tokens/s"
          f"; warm-up call {warm_s * 1e3:.1f} ms); peak device memory "
          f"{pre_peak / 2**30:.2f} GiB; launches {json.dumps(pre_launches)} "
          f"== predicted (flash_attention {want_fa}: "
          f"{dict((f'{q[2]}x{kk[2]} causal={c}', n) for (q, kk, c), n in by_shape.items())})")

    # ------------------------------------------------ decode, bf16
    if encdec:
        req, new_tokens = prompts, FAMILY_DECODE_NEW
    else:
        req = torch.as_tensor(rng.integers(0, V, (PREFILL_SHAPE[0],
                                                  MLA_DECODE_PROMPT)),
                              device=dev)
        new_tokens = FAMILY_DECODE_NEW
    rows_n, plen = req.shape

    def filled_cache(prm, c, rows, length, kw, where=dev):
        """A zero decode cache on ``where``; the encoder-decoder's cross
        K/V projected from the encoder's output, decoder layer by layer."""
        cache = M.init_decode_cache(c, rows, length, device=where,
                                    enc_len=ENC_FRAMES if kw else 0)
        if kw:
            out = M._encode(prm, c, kw["enc_embeds"])
            for i in range(c.n_layers):
                ck, cv = cross_attention_kv(M._layer(prm, i)["cross"], out, c)
                cache["cross_k"][i], cache["cross_v"][i] = ck, cv
        return cache

    cache = filled_cache(params, cfg, rows_n, plen + new_tokens,
                         enc_kw(bf16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for t in range(plen):
        out, cache = M.decode_step(params, cfg, req[:, t], cache)
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    tok, new = out.argmax(-1), []
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        new.append(tok)
        out, cache = M.decode_step(params, cfg, tok, cache)
        tok = out.argmax(-1)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    dec_launches = read_counts()
    dec_peak = torch.cuda.max_memory_allocated()
    new = torch.stack(new, 1)
    assert not any(dec_launches.values()), f"decode launched {dec_launches}"
    assert bool(torch.isfinite(out[:, :V]).all())
    assert bool((out[:, V:] == -1e30).all())
    assert cache["len"].tolist() == [plen + new_tokens] * rows_n
    assert bool(((new >= 0) & (new < V)).all())
    steps = plen + new_tokens
    kind = "the absorbed MLA decode over the latent cache" if not encdec \
        else f"self attention and cross attention over {ENC_FRAMES} frames"
    print(f"{cfg.name} decode: {rows_n} requests x ({plen} teacher-forced + "
          f"{new_tokens} greedy) bf16, {kind}: "
          f"{forced_s / plen * 1e3:.2f} ms a teacher-forced step, "
          f"{greedy_s / new_tokens * 1e3:.2f} ms a greedy step "
          f"({rows_n * steps / (forced_s + greedy_s):.1f} tokens/s); peak "
          f"device memory {dec_peak / 2**30:.2f} GiB; launches "
          f"{json.dumps(dec_launches)} (none predicted); first request's "
          f"greedy tokens {new[0, :8].tolist()}...")
    del cache

    # ---------------- the same prefill through the plain versions
    def plain_prefill(prm, dtype):
        saved = attention.prefill_attention
        attention.prefill_attention = blockwise_attention
        try:
            zero_counts()
            out = M.prefill(prm, cfg, prompts, **enc_kw(dtype))
            torch.cuda.synchronize()
            assert not any(read_counts().values()), "the plain run launched"
        finally:
            attention.prefill_attention = saved
        return out

    t0 = time.perf_counter()
    plain_logits = plain_prefill(params, bf16)
    plain_s = time.perf_counter() - t0
    del params
    free_cards()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init_params(cfg32, seed=MODEL_SEED, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    logits32 = M.prefill(params32, cfg32, prompts,
                         **enc_kw(torch.float32))
    torch.cuda.synchronize()
    k32_s = time.perf_counter() - t0
    assert read_counts()["flash_attention"] == want_fa
    plain32 = plain_prefill(params32, torch.float32)
    del params32
    free_cards()
    rel32 = _rel(logits32, plain32)
    noise = _rel(plain_logits, plain32)
    rel = _rel(logits, plain_logits)

    def greedy(a) -> list[int]:
        return a[:, :V].argmax(-1).tolist()

    top2 = plain32[:, :V].topk(2, dim=-1).values
    lead = ((top2[:, 0] - top2[:, 1]) / plain32[:, :V].abs().max()).tolist()
    assert rel32 <= 1e-4, f"{cfg.name} fp32 kernels vs plain prefill: {rel32}"
    assert greedy(logits32) == greedy(plain32)
    assert greedy(logits) == greedy(plain_logits), \
        f"bf16 greedy tokens: kernels {greedy(logits)}, plain " \
        f"{greedy(plain_logits)} (fp32 top-1 leads {lead})"
    print(f"check: {cfg.name} full-width prefill, kernels vs plain versions "
          f"on the card: fp32 last logits within {rel32:.3g} of max |logit| "
          f"(tolerance 1e-4), same greedy tokens; bf16: same greedy tokens "
          f"{greedy(logits)} (fp32 top-1 leads its runner-up by "
          f"{', '.join(f'{x:.3g}' for x in lead)} of max |logit|), last "
          f"logits {rel:.3g} of max |logit| apart (the plain bf16 run lies "
          f"{noise:.3g} from the plain fp32 run); plain bf16 prefill "
          f"{plain_s * 1e3:.1f} ms, fp32 kernels prefill {k32_s * 1e3:.1f} "
          f"ms")
    del plain_logits, logits32, plain32

    # --------------------- 2 layers at full width, fp32
    rcfg = dataclasses.replace(
        cfg, n_layers=FAMILY_REDUCED_LAYERS, dtype="float32",
        n_enc_layers=FAMILY_REDUCED_LAYERS if encdec else 0)
    rp = M.init_params(rcfg, seed=MODEL_SEED, device=dev)
    toks = torch.as_tensor(rng.integers(0, V, (1, FAMILY_REDUCED_PROMPT)),
                           device=dev)
    rkw = enc_kw(torch.float32, 1)
    zero_counts()
    pre = M.prefill(rp, rcfg, toks, **rkw)
    assert read_counts()["flash_attention"] == per_layer * rcfg.n_layers
    rc = filled_cache(rp, rcfg, 1, FAMILY_REDUCED_PROMPT, rkw)
    for t in range(FAMILY_REDUCED_PROMPT):
        out, rc = M.decode_step(rp, rcfg, toks[:, t], rc)
    rel = _rel(out[:, :V], pre[:, :V])
    assert rel <= 2e-4, f"{cfg.name} prefill vs decode (fp32): {rel}"
    t0 = time.perf_counter()
    cp = _to(rp, "cpu")
    ckw = {k: v.cpu() for k, v in rkw.items()}
    cpu_pre = M.prefill(cp, rcfg, toks.cpu(), **ckw)
    rel_pre = _rel(pre.cpu(), cpu_pre)
    gc_ = filled_cache(rp, rcfg, 1, FAMILY_REDUCED_DECODE, rkw)
    cc_ = filled_cache(cp, rcfg, 1, FAMILY_REDUCED_DECODE, ckw, "cpu")
    rel_dec = 0.0
    for t in range(FAMILY_REDUCED_DECODE):
        lg, gc_ = M.decode_step(rp, rcfg, toks[:, t], gc_)
        lc, cc_ = M.decode_step(cp, rcfg, toks[:, t].cpu(), cc_)
        rel_dec = max(rel_dec, _rel(lg[:, :V].cpu(), lc[:, :V]))
    assert rel_pre <= 1e-4 and rel_dec <= 1e-4, (rel_pre, rel_dec)
    print(f"check: {cfg.name} at {rcfg.n_layers} layers, fp32, full width: "
          f"prefill's last logits vs teacher-forced decode's at token "
          f"{FAMILY_REDUCED_PROMPT}: within {rel:.3g} of max |logit| "
          f"(tolerance 2e-4, tests/test_models.py:78); card vs CPU "
          f"({time.perf_counter() - t0:.1f} s on the host): prefill within "
          f"{rel_pre:.3g}, {FAMILY_REDUCED_DECODE} decode steps within "
          f"{rel_dec:.3g} of max |logit| (tolerance 1e-4)")
    del rp, cp, rc, gc_, cc_
    free_cards()

    # -------------------- the kernel at each captured prefill shape
    rows = []
    for key, (a, kw) in fa_rec.first.items():
        q, k, v = a[:3]
        qs, ks, causal = key
        if not encdec:
            what = f"{cfg.name} prefill (MLA, D {qs[3]} / Dv {v.shape[3]})"
        elif qs[2] != ks[2]:
            what = f"{cfg.name} prefill cross attention (Sq {qs[2]}, Skv " \
                   f"{ks[2]})"
        else:
            what = f"{cfg.name} prefill " + ("decoder self attention"
                                            if causal else "encoder")
        row = attention_row(what, q, k, v, dict(causal=causal,
                                                window=kw["window"]),
                            by_shape[key], None, max_err)
        backends = sdpa_backends(q, k, v, causal)
        print(f"scaled_dot_product_attention at {what}, each fused backend "
              f"alone: " + "; ".join(
                  f"{n} {m:.3f} ms" if isinstance(m, float) else f"{n} {m}"
                  for n, m in backends.items()))
        if not encdec:
            new_ms, old_ms = fa_instance_pair(q, k, v, causal, max_err)
            print(f"flash_attention bf16 instances at {what}, contiguous "
                  f"copies: <6, 1> {new_ms:.3f} ms, the padded <8, 2> path "
                  f"it replaces {old_ms:.3f} ms ({old_ms / new_ms:.2f}x); "
                  f"both within the element limit of attention_ref")
            row["ms_padded_8_2"] = old_ms
        rows.append(row)
    fa_rec.first = None
    assert sum(r["launches"] for r in rows) == want_fa
    return rows


def train_grads(params, cfg, batch) -> tuple:
    """(loss, {path: gradient}) of ``loss_fn`` at ``params`` (detached
    leaves that require grad, ``torch.autograd.grad``)."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_items, tree_unflatten
    paths, leaves = zip(*tree_items(params))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = M.loss_fn(tree_unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(paths, grads))


def plain_training(fn):
    """``fn()`` with the plain versions in the kernels' places (swapped
    here only; the port has no switch): plain autograd, no launch."""
    import repro_torch.kernels.mamba2_ssd.ops as ssd_ops
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked
    saved = (attention.prefill_attention, ssd_ops.mamba2_ssd)
    attention.prefill_attention, ssd_ops.mamba2_ssd = \
        blockwise_attention, mamba2_ssd_chunked
    try:
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        assert not any(read_counts().values()), "the plain run launched"
    finally:
        attention.prefill_attention, ssd_ops.mamba2_ssd = saved
    return out


def grad_norm(grads: dict) -> float:
    return math.sqrt(sum(float(g.float().square().sum())
                         for g in grads.values()))


def hold_grads(what: str, got: dict, want: dict, tol: float) -> float:
    """Each leaf within ``tol`` of its largest |g|; returns the worst
    share."""
    worst = 0.0
    for name, w in want.items():
        top = float(w.float().abs().max())
        err = float((got[name].float().cpu() - w.float().cpu()).abs().max())
        share = err / top if top else err
        assert err <= tol * top + 1e-30, \
            f"{what}: gradient {name} {share} of its largest |g| (> {tol})"
        worst = max(worst, share)
    return worst


class FunctionTimer:
    """CUDA events around every forward and backward of an autograd
    Function (its ``forward`` / ``backward`` wrapped while inside): the
    stream time each takes, summed, read after a synchronize."""

    def __init__(self, fn_cls):
        self.cls, self.events = fn_cls, {"forward": [], "backward": []}

    def __enter__(self):
        self.saved = {k: getattr(self.cls, k) for k in self.events}
        for kind, fn in self.saved.items():
            def timed(*a, _fn=fn, _kind=kind):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = _fn(*a)
                t1.record()
                self.events[_kind].append((t0, t1))
                return out
            setattr(self.cls, kind, staticmethod(timed))
        return self

    def __exit__(self, *exc):
        for kind, fn in self.saved.items():
            setattr(self.cls, kind, staticmethod(fn))

    def ms(self, kind: str) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[kind])


def training_phase(dev, max_err: dict) -> list[dict]:
    """Phase 16: training (ROADMAP §1 item 5), qwen3-0.6b at full width
    and depth on the card.

    (a) bf16 from seed 0: ``make_train_step`` with ``TRAIN_OPT`` over
    ``TRAIN_STEPS`` batches of ``SyntheticLM`` (8 x 2048 tokens, 16,384 a
    step; made on the host before the run): the loss at the last step
    below the first, every ``grad_norm`` finite, 28 ``flash_attention``
    launches a step (the forward; the backward recomputes the plain
    version) and none of another kernel; the step's ms and tokens/s, the
    peak memory; then one more step with CUDA events around the
    attention Function's forward and backward (its share of a step).  (b)
    remat: ``remat="full"`` and ``"dots"`` each take the first step from
    the same start: loss and ``grad_norm`` within 1e-5 of (a)'s first,
    56 launches (the recompute launches the kernel again).  (c) the first
    step's loss and gradients at ``TRAIN_HOLD_BATCH`` rows x 2048, kernels
    against the plain versions on the card: fp32 (the bf16 parameters are
    its rounding) loss to rel 1e-5 and each leaf within 1e-4 of its
    largest |g|; bf16 loss to 2e-2 and the gradients' global norm to
    5e-2.  (d) ``TRAIN_REDUCED`` layers at full width in fp32 on
    ``TRAIN_CPU_SHAPE`` tokens: loss and gradients and a train step's
    metrics, card against CPU, to 1e-4.  (e) the ``Trainer`` at
    ``TRAIN_REDUCED`` layers in bf16: a failure at step ``TRAINER_FAIL``,
    a checkpoint every ``TRAINER_CKPT`` steps (in a temporary directory,
    removed after), ``TRAINER_STEPS`` steps: one restart, and the final
    loss equal to an uninterrupted run's to rel 1e-5.  (f) the
    ``mamba2_ssd`` wrapper's gradient at zamba2-7b's layer shape, batch 1
    (``SSD_GRAD_CASE``): one launch, the forward within 3e-6 of the
    largest output of the chunked form, the gradients of x, B, C and dA
    equal to plain autograd's bit for bit; the forward kernel and the
    plain-recompute backward timed.  (g) ``flash_attention`` at the
    captured training inputs ([8, 16/8, 2048, 128] bf16 causal, the
    model's views): ``attention_row``'s hold and times, then the
    plain-recompute backward, the wrapper's forward + backward,
    ``scaled_dot_product_attention`` forward + backward under each fused
    backend alone (``enable_gqa``), and the bound of forward + backward
    (the backward at 2.5x the forward's FLOPs, 989 TFLOP/s; the bytes of
    q, k, v, o read and written by both passes and dO, dQ, dK, dV).
    Returns the kernels' rows."""
    import tempfile
    from torch.nn.attention import SDPBackend, sdpa_kernel
    free_cards()
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.mamba2_ssd.ops as ssd_ops
    from repro_torch.configs import get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
    from repro_torch.kernels.mamba2_ssd.ref import (mamba2_ssd_chunked,
                                                    seg_from_dA)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    F = torch.nn.functional

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(**TRAIN_OPT)
    b, s = TRAIN_SHAPE
    data = SyntheticLM(cfg.vocab_size, s, b, seed=TRAIN_SEED)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    state = init_train_state(M.init_params(cfg, seed=TRAIN_SEED,
                                           device=dev))
    torch.cuda.synchronize()
    print(f"training: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}), "
          f"{_leaf_count(state['params']):,} {cfg.dtype} parameters from "
          f"seed {TRAIN_SEED} with fp32 master, mu and nu, in "
          f"{time.perf_counter() - t0:.1f} s; AdamWConfig({TRAIN_OPT}), "
          f"{b} x {s} tokens a step")

    # ------------------------------------------- (a) the main path, bf16
    step = make_train_step(cfg, opt)
    losses, norms, times = [], [], []
    with Recorder(fa_ops, "flash_attention") as fa_rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        for batch in batches:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))          # waits for the step
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * TRAIN_STEPS
    assert launches["flash_attention"] == want and \
        sum(launches.values()) == want, \
        f"training launches {launches}, predicted {want} flash_attention"
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert int(m["lr_step"]) == TRAIN_STEPS == int(state["step"])
    step_s = float(np.median(times[1:]))
    print(f"train steps {b} x {s} bf16: median {step_s * 1e3:.1f} ms a step "
          f"over steps 1-{TRAIN_STEPS - 1} ({b * s / step_s:.0f} tokens/s; "
          f"step 0 {times[0] * 1e3:.1f} ms); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)} == "
          f"predicted ({cfg.n_layers} flash_attention a step); loss "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in norms)}")
    with FunctionTimer(fa_ops.FlashAttention) as ft:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(TRAIN_STEPS))
        float(m["loss"])
        timed_s = time.perf_counter() - t0
    fwd_in_step, bwd_in_step = ft.ms("forward"), ft.ms("backward")
    share = (fwd_in_step + bwd_in_step) / (timed_s * 1e3)
    print(f"one more step with CUDA events around FlashAttention: "
          f"{timed_s * 1e3:.1f} ms; {len(ft.events['forward'])} forwards "
          f"{fwd_in_step:.2f} ms, {len(ft.events['backward'])} backwards "
          f"(plain recompute) {bwd_in_step:.2f} ms: {share:.1%} of the step")
    del state, m, step

    # --------------------------------- (b) remat full and dots, one step
    remat = {}
    for mode in ("full", "dots"):
        st = init_train_state(M.init_params(cfg, seed=TRAIN_SEED, device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        st, m = make_train_step(dataclasses.replace(cfg, remat=mode),
                                opt)(st, batches[0])
        lm, gm = float(m["loss"]), float(m["grad_norm"])
        dt = time.perf_counter() - t0
        got = read_counts()
        rl, rg = abs(lm - losses[0]) / losses[0], abs(gm - norms[0]) / norms[0]
        assert got["flash_attention"] == 2 * cfg.n_layers == \
            sum(got.values()), f"remat={mode} launches {got}"
        assert rl <= 1e-5 and rg <= 1e-5, (mode, rl, rg)
        remat[mode] = (dt, torch.cuda.max_memory_allocated())
        print(f"check: remat={mode!r} first step vs remat='none': loss "
              f"{rl:.3g}, grad_norm {rg:.3g} apart (tolerance 1e-5); "
              f"{got['flash_attention']} flash_attention launches (the "
              f"recompute launches again); {dt * 1e3:.1f} ms (a first step); "
              f"peak {remat[mode][1] / 2**30:.2f} GiB")
        del st, m

    # -------------- (c) kernels vs plain versions, first step, 2 x 2048
    hold = {k: torch.as_tensor(v[:TRAIN_HOLD_BATCH]).to(dev)
            for k, v in batches[0].items()}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        prm = M.init_params(c, seed=TRAIN_SEED, device=dev)
        zero_counts()
        lk, gk = train_grads(prm, c, hold)
        torch.cuda.synchronize()
        got = read_counts()
        assert got["flash_attention"] == cfg.n_layers == sum(got.values())
        lp, gp = plain_training(lambda: train_grads(prm, c, hold))
        rl = abs(float(lk) - float(lp)) / abs(float(lp))
        if dtype == "float32":
            assert rl <= 1e-5, f"fp32 loss kernels vs plain: {rl}"
            worst = hold_grads("fp32 kernels vs plain", gk, gp, 1e-4)
            detail = (f"every leaf within {worst:.3g} of its largest |g| "
                      f"(tolerance 1e-4)")
        else:
            nk, npl = grad_norm(gk), grad_norm(gp)
            rn = abs(nk - npl) / npl
            assert rl <= 2e-2 and rn <= 5e-2, (rl, rn)
            detail = (f"gradient norm {nk:.4f} vs {npl:.4f}, {rn:.3g} apart "
                      f"(tolerance 5e-2)")
        print(f"check: first-step loss and gradients at "
              f"{TRAIN_HOLD_BATCH} x {s} in {dtype}, kernels vs plain "
              f"versions on the card: loss {float(lk):.6f} vs "
              f"{float(lp):.6f}, {rl:.3g} apart (tolerance "
              f"{1e-5 if dtype == 'float32' else 2e-2}); {detail}")
        del prm, gk, gp

    # ------------------ (d) TRAIN_REDUCED layers, fp32, card vs CPU
    rcfg = dataclasses.replace(cfg, n_layers=TRAIN_REDUCED, dtype="float32")
    rp = M.init_params(rcfg, seed=TRAIN_SEED, device=dev)
    cp = _to(rp, "cpu")
    rb, rs_ = TRAIN_CPU_SHAPE
    small = {k: torch.as_tensor(v[:rb, :rs_]) for k, v in batches[0].items()}
    t0 = time.perf_counter()
    lg, gg = train_grads(rp, rcfg, _to(small, dev))
    lc, gcpu = train_grads(cp, rcfg, small)
    rl = abs(float(lg) - float(lc)) / abs(float(lc))
    assert rl <= 1e-4, f"card vs CPU loss: {rl}"
    worst = hold_grads("card vs CPU", gg, gcpu, 1e-4)
    _, mg = make_train_step(rcfg, opt)(init_train_state(rp), small)
    _, mc = make_train_step(rcfg, opt)(init_train_state(cp), small)
    rm = max(abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
             for k in ("loss", "grad_norm"))
    assert rm <= 1e-4, f"card vs CPU train step metrics: {rm}"
    print(f"check: {TRAIN_REDUCED} layers at full width, fp32, {rb} x {rs_} "
          f"tokens, card vs CPU ({time.perf_counter() - t0:.1f} s): loss "
          f"{rl:.3g} apart, every gradient leaf within {worst:.3g} of its "
          f"largest |g|, a train step's loss and grad_norm within {rm:.3g} "
          f"(tolerance 1e-4)")
    del rp, cp, gg, gcpu

    # ------------------------------------------------- (e) the Trainer
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_REDUCED)
    tparams = M.init_params(tcfg, seed=TRAIN_SEED, device=dev)
    tdata = SyntheticLM(cfg.vocab_size, TRAINER_SHAPE[1], TRAINER_SHAPE[0],
                        seed=TRAIN_SEED + 3)
    tstep = make_train_step(tcfg, opt)
    fails = []

    def hook(i):
        if i == TRAINER_FAIL and not fails:
            fails.append(i)
            raise RuntimeError("injected node loss")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(tstep, init_train_state(tparams), tdata,
                     TrainerConfig(total_steps=TRAINER_STEPS,
                                   ckpt_every=TRAINER_CKPT, ckpt_dir=d),
                     failure_hook=hook)
        out = tr.run()
        ckpts = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in ckpts)
    faulted_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        plain = Trainer(tstep, init_train_state(tparams), tdata,
                        TrainerConfig(total_steps=TRAINER_STEPS,
                                      ckpt_every=10**9, ckpt_dir=d)).run()
    rl = abs(out["final_loss"] - plain["final_loss"]) / plain["final_loss"]
    assert out["restarts"] == 1 and out["final_step"] == TRAINER_STEPS, out
    assert rl <= 1e-5, (out, plain)
    print(f"check: Trainer at {TRAIN_REDUCED} layers, full width, bf16, "
          f"{TRAINER_SHAPE[0]} x {TRAINER_SHAPE[1]}: failure at step "
          f"{TRAINER_FAIL}, {len(ckpts)} checkpoints ({ckpt_bytes / 2**30:.2f}"
          f" GiB; every {TRAINER_CKPT} steps), restarts {out['restarts']}, "
          f"final step {out['final_step']}, final loss "
          f"{out['final_loss']:.6f} vs the uninterrupted run's "
          f"{plain['final_loss']:.6f} ({rl:.3g} apart, tolerance 1e-5); "
          f"{faulted_s:.1f} s with the faults")
    del tparams, tr

    # ---------------- (f) the SSD wrapper's gradient, zamba2's layer
    bh, ss, p, n, chunk, groups = SSD_GRAD_CASE
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    x = torch.randn((bh, ss, p), generator=gen, device=dev) * 0.5
    Bm = torch.randn((groups, ss, n), generator=gen, device=dev) * 0.5
    Cm = torch.randn((groups, ss, n), generator=gen, device=dev) * 0.5
    dA = -torch.rand((bh, ss), generator=gen, device=dev) * 0.5
    up = torch.randn((bh, ss, p), generator=gen, device=dev)

    def grads_of(fn):
        xs = [t.detach().requires_grad_(True) for t in (x, Bm, Cm, dA)]
        out_ = fn(*xs)
        return out_, torch.autograd.grad(out_, xs, up)

    def plain_ssd(x_, b_, c_, a_):
        return mamba2_ssd_chunked(x_, b_, c_, seg_from_dA(a_, chunk),
                                  chunk=chunk)
    zero_counts()
    y, got = grads_of(lambda *t: ssd_ops.mamba2_ssd_op(*t, chunk=chunk))
    torch.cuda.synchronize()
    assert read_counts()["mamba2_ssd"] == 1
    y_want, want_g = grads_of(plain_ssd)
    y, y_want = y.detach(), y_want.detach()
    err = check_close(max_err, "mamba2_ssd", "training layer forward", y,
                      y_want, 3e-6, float(y_want.abs().max()))
    for name, g, w in zip(("x", "B", "C", "dA"), got, want_g):
        assert torch.equal(g, w), f"mamba2_ssd gradient of {name}"
    seg = seg_from_dA(dA, chunk)
    ssd_fwd = cuda_ms(lambda: mamba2_ssd(x, Bm, Cm, seg, chunk=chunk), REPS)
    ssd_bwd = cuda_ms(lambda: grads_of(plain_ssd), 3)
    nbytes, flops = ssd_work(x, Bm, chunk)
    ssd_bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S) * 1e3
    print(f"check: mamba2_ssd_op gradient at x {list(x.shape)}, B/C "
          f"{list(Bm.shape)}, chunk {chunk}: forward within {err:.3g} "
          f"(3e-6 of max |y|), the gradients of x, B, C, dA equal to plain "
          f"autograd's bit for bit; kernel forward {ssd_fwd:.3f} ms, plain "
          f"forward + backward (what a training step adds) {ssd_bwd:.3f} ms; "
          f"forward bound {ssd_bound:.4f} ms")
    del x, Bm, Cm, dA, up, y, got, y_want, want_g, seg

    # ------------- (g) flash_attention at the captured training inputs
    # the first call's inputs, detached from step 0's graph (the raw
    # launcher refuses inputs that require grad)
    q, k, v = (t.detach() for t in fa_rec.args)
    fa_kw = fa_rec.kwargs
    row = attention_row(f"{cfg.name} training", q, k, v, fa_kw,
                        launches["flash_attention"], None, max_err)
    gqa = k.shape[1] < q.shape[1]
    up = torch.randn(q.shape[:-1] + (v.shape[-1],), device=dev,
                     dtype=q.dtype)
    ups = up.transpose(1, 2)                      # the model's layout

    def plain_bwd():
        xs = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
        with torch.enable_grad():
            o = blockwise_attention(*xs, **fa_kw)
        return torch.autograd.grad(o, xs, ups)

    def wrapper_fb():
        xs = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
        o = fa_ops.prefill_attention(*xs, **fa_kw)
        return torch.autograd.grad(o, xs, ups)
    bwd_ms = cuda_ms(plain_bwd, 5)
    fb_ms = cuda_ms(wrapper_fb, 5)
    sdpa = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def sdpa_fb():
            xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(
                *xs, is_causal=fa_kw["causal"], enable_gqa=gqa)
            return torch.autograd.grad(o, xs, up)
        try:
            with sdpa_kernel([backend]):
                sdpa[backend.name] = cuda_ms(sdpa_fb, REPS)
        except RuntimeError as e:
            sdpa[backend.name] = "refused (" + \
                str(e).strip().split(".")[0] + ")"
    nbytes, flops = attention_work(q, k, v, **fa_kw)
    elt = q.element_size()
    grad_bytes = (2 * (q.numel() + k.numel() + v.numel())
                  + 2 * up.numel()) * elt          # dq dk dv; o and do read
    fb_bound = max((2 * nbytes + grad_bytes) / PEAK_BYTES_PER_S,
                   3.5 * flops / PEAK_BF16_PER_S) * 1e3
    steps_share = cfg.n_layers * (row["ms"] + bwd_ms) / (step_s * 1e3)
    timed = [x for x in sdpa.values() if isinstance(x, float)]
    vs_sdpa = (f"; wrapper / best SDPA = {fb_ms / min(timed):.1f}" if timed
               else "")
    print(f"flash_attention training [{', '.join(map(str, q.shape))}] "
          f"{q.dtype}: kernel forward {row['ms']:.3f} ms; plain-recompute "
          f"backward {bwd_ms:.3f} ms; the wrapper's forward + backward "
          f"{fb_ms:.3f} ms; {cfg.n_layers} x (forward + backward) = "
          f"{steps_share:.1%} of the median step ({share:.1%} by events in "
          f"a step); scaled_dot_product_attention forward + backward "
          f"(enable_gqa={gqa}) {json.dumps(sdpa)}; bound of forward + "
          f"backward {fb_bound:.4f} ms (3.5x the forward's "
          f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s){vs_sdpa}")
    row.update({
        "train_step_ms": step_s * 1e3, "train_tokens_per_s": b * s / step_s,
        "train_peak_gib": peak / 2**30, "launches_per_step": cfg.n_layers,
        "backward_plain_ms": bwd_ms, "forward_backward_ms": fb_ms,
        "step_share": steps_share, "step_share_events": share,
        "sdpa_forward_backward_ms": sdpa, "bound_forward_backward_ms":
            fb_bound,
        "ssd_training": {"shape": list(SSD_GRAD_CASE), "forward_ms": ssd_fwd,
                         "plain_forward_backward_ms": ssd_bwd,
                         "forward_bound_ms": ssd_bound}})
    return [row]


class DryRun:
    """The port's dry run, ``python -m repro_torch.launch.dryrun --all
    --both-meshes``, in DRYRUN_PARTS host processes of their own (``--part
    I/N``), each on ``meta`` (no card: ``CUDA_VISIBLE_DEVICES`` is empty,
    one CPU thread).  Phase 17 starts them just before (e)'s checkpoint
    save and restore, after its other timings, so no phase's step or
    kernel time runs beside them.  ``stop`` (also at exit) ends any that
    still runs."""

    def __init__(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="dryrun_")
        src = pathlib.Path(importlib.util.find_spec("repro_torch")
                           .submodule_search_locations[0]).parent
        env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        self.log = open(os.path.join(self.dir, "log"), "w")
        self.start = time.time()
        self.results = [os.path.join(self.dir, f"dryrun_{i}.json")
                        for i in range(DRYRUN_PARTS)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--part", f"{i}/{DRYRUN_PARTS}", "--results",
             path], env=env, stdout=self.log, stderr=subprocess.STDOUT)
            for i, path in enumerate(self.results)]
        import atexit
        atexit.register(self.stop)

    def wait(self, timeout: float) -> tuple[list, float]:
        """(the records, the dry run's wall seconds: its last part's);
        fails on a non-zero exit, with the end of the log."""
        deadline = time.time() + timeout
        rcs = [p.wait(timeout=max(1.0, deadline - time.time()))
               for p in self.procs]
        self.log.flush()
        if any(rcs):
            with open(os.path.join(self.dir, "log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"dry run exited {rcs}:\n{tail}")
        recs = []
        for path in self.results:
            with open(path) as f:
                recs += json.load(f)
        return recs, max(os.path.getmtime(p) for p in self.results) \
            - self.start

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.log.close()
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_part(dry: DryRun) -> None:
    """Phase 17 (a): every cell of ``configs.all_cells()`` on both
    production meshes, one line a cell."""
    from repro_torch.configs import all_cells
    recs, wall = dry.wait(max(60.0, DRYRUN_TIMEOUT_S
                              - (time.time() - dry.start)))
    cells = {(a, s.name) for a, s in all_cells()}
    for mesh in ("16x16", "2x16x16"):
        ok = {(r["arch"], r["shape"]) for r in recs
              if r["mesh"] == mesh and r["ok"]}
        assert ok == cells, f"dry run on {mesh}: missing {cells - ok}"
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        t, pd = r["roofline_s"], r["per_device"]
        assert all(math.isfinite(v) and v >= 0 for v in t.values()), r
        print(f"dry run {r['arch']} x {r['shape']} x {r['mesh']} "
              f"({r['kind']}, {r['n_chips']} chips): compute "
              f"{t['compute']:.3e} s, memory {t['memory']:.3e} s, "
              f"collective {t['collective']:.3e} s -> "
              f"{max(t, key=t.get)}-bound; args {pd['arg_bytes'] / 1e9:.3f} "
              f"GB a chip (HBM fit {r['hbm_fit']}); model/analyzed "
              f"{r['model_flops_ratio']:.3f}; analyzed in {r['analyze_s']} s")
    print(f"(a) dry run: {len(recs)} records ({len(cells)} cells x 2 "
          f"meshes) ran on meta in {wall:.1f} s wall, in {DRYRUN_PARTS} "
          f"host processes beside (e)'s save and restore; "
          f"roofline against the "
          f"NVIDIA H100 80GB HBM3 (SXM5, 700 W) sheet figures (989 TFLOP/s "
          f"bf16, 3.35 TB/s, NVLink 450 GB/s, 50 GB/s across pods)")


def executed_cells_part(dev, max_err: dict) -> tuple[int, dict]:
    """Phase 17 (b): qwen3-0.6b's prefill_32k and decode_32k cells run for
    real on the card as one chip; the analyzer's FLOPs on the card equal
    its FLOPs on meta for the same cell, exactly.  Returns
    (flash_attention launches, the kernel row at the prefill's captured
    inputs)."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import blockwise_attention
    from repro_torch.launch import specs as L
    from repro_torch.launch.cost_analysis import analyze_step
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.roofline import model_bytes, model_flops
    from repro_torch.models.config import SHAPES
    F = torch.nn.functional
    cfg = get_config(DIST_ARCH)
    row = None
    launches = 0
    for shape_name, b in (("prefill_32k", DIST_PREFILL_BATCH),
                          ("decode_32k", DIST_DECODE_BATCH)):
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=b)
        meta = L.build_cell(DIST_ARCH, shape_name, tp=1, global_batch=b)
        want = analyze_step(meta.step_fn, *meta.args)
        free_cards()
        t0 = time.perf_counter()
        cell = L.build_cell(DIST_ARCH, shape_name, tp=1, device=dev,
                            seed=DIST_SEED, global_batch=b)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        print(f"executed cell {DIST_ARCH} x {shape_name}: batch cut "
              f"{SHAPES[shape_name].global_batch} -> {b}, one chip"
              + (f"; the {shape.seq_len}-deep decode cache filled with "
                 f"seeded normal values (len {shape.seq_len - 1}) in place "
                 f"of a prefill" if cell.kind == "decode" else "")
              + f"; built in {build_s:.1f} s")
        with Recorder(fa_ops, "flash_attention") as rec:
            zero_counts()
            got = analyze_step(cell.step_fn, *cell.args)
            torch.cuda.synchronize()
            counts = read_counts()
        out = cell.step_fn(*cell.args)
        logits = out[0] if cell.kind == "decode" else out
        assert logits.shape == (b, cfg.padded_vocab()) and \
            bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
        fa_want = cfg.n_layers if cell.kind == "prefill" else 0
        assert counts["flash_attention"] == fa_want and \
            sum(counts.values()) == fa_want, counts
        launches += counts["flash_attention"]
        assert got.flops == want.flops, \
            f"{shape_name}: analyzer FLOPs on the card {got.flops} != meta " \
            f"{want.flops}"
        assert got.while_trip_counts == want.while_trip_counts
        if cell.kind == "decode":
            k = out[1]["kv"]["k"]
            assert k.shape == (cfg.n_layers, b, 1, cfg.n_kv_heads,
                               cfg.head_dim)
        ms = cuda_ms(lambda: cell.step_fn(*cell.args), 3)
        mf = model_flops(cfg, shape)
        compute_ms = got.flops / PEAK_FLOPS * 1e3
        memory_ms = model_bytes(cfg, shape, 1) / HBM_BW * 1e3
        print(f"(b) {shape_name} on the card: {ms:.2f} ms a step (CUDA "
              f"events, 3 steps); analyzer FLOPs {got.flops:.6e} on the "
              f"card == {want.flops:.6e} on meta (bytes proxy "
              f"{got.bytes:.4e} / {want.bytes:.4e}); model_flops {mf:.6e} "
              f"(model/analyzed {mf / got.flops:.3f}); roofline as one chip: "
              f"compute {compute_ms:.3f} ms, memory {memory_ms:.3f} ms; "
              f"launches {json.dumps(counts)} (kernel-op calls "
              f"{json.dumps(got.while_trip_counts)})")
        del cell, out, logits
        free_cards()
        if shape_name == "prefill_32k":
            q, k, v = rec.args
            row = _long_prefill_row(q, k, v, rec.kwargs, max_err,
                                    blockwise_attention, F)
            del q, k, v, rec
            free_cards()
    return launches, row


def long_hold(got, exact, noise_ref, rows: int = LONG_HOLD_ROWS):
    """The hold of ``flash_attention`` over long prefills, per (batch,
    head, ``rows``-row query block) of [B, H, S, D] outputs: (max |got -
    exact|, its bound 2 max |noise_ref - exact| + LONG_HOLD_REL max
    |exact|), each [B, H, S / rows].  The bound follows each block's own
    bf16 noise and |out|, which shrink together along a causal prefill."""
    def block_max(x):
        b, h, s, d = x.shape
        return x.abs().reshape(b, h, s // rows, rows * d).amax(-1)
    err = block_max(got.float() - exact)
    bound = 2 * block_max(noise_ref.float() - exact) \
        + LONG_HOLD_REL * block_max(exact)
    return err, bound


def tail_attention(q, k, v, kw: dict, rows: int, drop: slice | None
                   ) -> torch.Tensor:
    """fp32 attention of the last ``rows`` query rows of [B, H, S, D]
    q/k/v (grouped KV heads), with the keys in ``drop`` masked out: what
    a kernel that loses those keys' tile would give there."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    sc = torch.einsum("bhqd,bhkd->bhqk", q[:, :, s - rows:].float(),
                      k.float().repeat_interleave(rep, 1)) / math.sqrt(d)
    qp = torch.arange(s - rows, s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None]
    mask = torch.ones((rows, s), dtype=torch.bool, device=q.device)
    if kw["causal"]:
        mask &= kp <= qp
    if kw["window"] > 0:
        mask &= kp > qp - kw["window"]
    if drop is not None:
        mask[:, drop] = False
    p = torch.softmax(torch.where(mask, sc, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float().repeat_interleave(rep, 1))


def _long_prefill_row(q, k, v, kw: dict, max_err: dict, blockwise, F
                      ) -> dict:
    """``flash_attention`` at the prefill_32k cell's captured inputs
    (layer 0's [B, H, S, D] views, bf16), held to the plain blockwise
    prefill computed in fp32 from the same inputs by ``long_hold``: over
    32,768 keys bf16 rounding alone moves an output by more than phase
    12's 2^-6 |out| + 1e-4 max |out|, and |out| falls along the prefill
    (about 1.45 / sqrt(i) at row i), so each 64-row block is held at its
    own scale.  Two kernels that lose one 64-key tile (``kBN``) in the
    last block, the diagonal one or one at long range, must fail the
    hold.  Timed beside the bf16 plain version (warmed, PLAIN_LONG_REPS
    runs) and ``scaled_dot_product_attention``, with its bound."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ops import seen_pairs

    def kern():
        return flash_attention(q, k, v, **kw)

    def plain(a=q, b=k, c=v):
        return blockwise(a.transpose(1, 2), b.transpose(1, 2),
                         c.transpose(1, 2), **kw).transpose(1, 2)
    s, rows = q.shape[2], LONG_HOLD_ROWS
    exact = plain(q.float(), k.float(), v.float())
    bf16 = plain()                         # the warm-up of the timed runs
    got = kern()
    errs, bounds = long_hold(got, exact, bf16)
    err = float((got.float() - exact).abs().max())
    noise = float((bf16.float() - exact).abs().max())
    ratio = errs / bounds
    worst = divmod(int(ratio.flatten().argmax()), ratio.shape[-1])
    scale = lambda x: float(x.float().abs().max())      # noqa: E731
    for where, blk in (("first", slice(0, rows)), ("last", slice(s - rows,
                                                                  s))):
        print(f"long hold, the {where} {rows}-row block: max |err| "
              f"{scale(got[:, :, blk].float() - exact[:, :, blk]):.4g}, "
              f"bf16 plain's {scale(bf16[:, :, blk].float() - exact[:, :, blk]):.4g}"
              f", max |out| {scale(exact[:, :, blk]):.4g}")
    assert bool((errs <= bounds).all()), \
        f"flash_attention at S {s}: block {worst} err {float(errs.max())} " \
        f"over its bound (worst ratio {float(ratio.max()):.3f})"
    tail = tail_attention(q, k, v, kw, rows, None)
    assert torch.allclose(tail, exact[:, :, s - rows:], rtol=1e-4,
                          atol=1e-6), "tail_attention disagrees"
    last_bound = bounds[..., -1]
    mutants = {}
    for name, drop in (("diagonal", slice(s - LONG_DROP_KEYS, s)),
                       ("long range", slice(0, LONG_DROP_KEYS))):
        mut = tail_attention(q, k, v, kw, rows, drop).to(q.dtype).float()
        m_err = (mut - exact[:, :, s - rows:]).abs().flatten(2).amax(-1)
        caught = m_err > last_bound
        mutants[name] = float((m_err / last_bound).max())
        assert bool(caught.any()), \
            f"a kernel without the {name} tile passes the hold"
        print(f"long hold: the {name} {LONG_DROP_KEYS}-key tile dropped in "
              f"the last block fails it in {int(caught.sum())} of "
              f"{caught.numel()} heads (err / bound {float((m_err / last_bound).min()):.2f}"
              f" .. {mutants[name]:.2f})")
    del exact, bf16, got, tail
    plain_runs = []
    for _ in range(PLAIN_LONG_REPS):      # warmed by the noise run above
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        plain()
        t1.record()
        torch.cuda.synchronize()
        plain_runs.append(t0.elapsed_time(t1))
    plain_ms = sum(plain_runs) / len(plain_runs)
    max_err["flash_attention"] = max(max_err["flash_attention"], err)
    b, hq, s, d = q.shape
    gqa = k.shape[1] != hq
    ms = cuda_ms(kern, 5)
    try:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kw["causal"], enable_gqa=gqa), 5)
    except RuntimeError as e:
        lib_ms = None
        print(f"scaled_dot_product_attention refused: {e}")
    flops = 2 * (d + v.shape[-1]) * b * hq * seen_pairs(
        s, k.shape[2], kw["causal"], kw["window"])
    nbytes = (q.numel() + k.numel() + v.numel() + b * hq * s * v.shape[-1]) \
        * q.element_size()
    bound, by = max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
                    (flops / PEAK_BF16_PER_S * 1e3, "operations"))
    print(f"flash_attention [{b}, {hq}/{k.shape[1]}, {s}, {d}] {q.dtype} "
          f"(the prefill_32k cell's layer 0, captured): {ms:.3f} ms, plain "
          f"blockwise {plain_ms:.1f} ms (runs {json.dumps(plain_runs)}), "
          f"scaled_dot_product_attention "
          f"{lib_ms if lib_ms is None else f'{lib_ms:.3f}'} ms, bound "
          f"{bound:.4f} ms by {by} ({flops / 1e12:.2f} TFLOP); max |err| "
          f"from the fp32 plain version {err:.4g}, the bf16 plain "
          f"version's {noise:.4g}; held per {rows}-row block and head at "
          f"2 x the bf16 plain's + 2^-8 x max |out|: worst err / bound "
          f"{float(ratio.max()):.3f} at (batch x head, block) {worst}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
            "shape": "phase 17: qwen3-0.6b prefill_32k, batch 2",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "long_hold": {
                "noise": noise, "worst_ratio": float(ratio.max()),
                "dropped_tile_ratio": mutants}}


def split_kv_part(dev) -> None:
    """Phase 17 (c): the split-KV decode at full width and depth against
    the committing decode, for GQA (qwen3-0.6b) and MLA's absorbed merge
    (minicpm3-4b), in fp32 and bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    for arch in (DIST_ARCH, DIST_MLA_ARCH):
        base = get_config(arch)
        v = base.vocab_size
        rng = np.random.default_rng(DIST_SEED)
        toks = torch.as_tensor(rng.integers(
            0, v, (SPLIT_ROWS, SPLIT_PROMPT + SPLIT_STEPS)), device=dev)
        rows = torch.arange(SPLIT_ROWS, device=dev)
        runs = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            params = M.init_params(cfg, seed=DIST_SEED, device=dev)
            cache = M.init_decode_cache(cfg, SPLIT_ROWS,
                                        SPLIT_PROMPT + SPLIT_STEPS, dev)
            t0 = time.perf_counter()
            for t in range(SPLIT_PROMPT):
                _, cache = M.decode_step(params, cfg, toks[:, t], cache)
            torch.cuda.synchronize()
            prompt_s = time.perf_counter() - t0
            split, commit, f_ms, t_ms = [], [], [], []
            layer0 = deeper = 0.0
            for t in range(SPLIT_PROMPT, SPLIT_PROMPT + SPLIT_STEPS):
                snap = {k: x.clone() for k, x in cache["kv"].items()}
                at = cache["len"].long()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lf, frozen = M.decode_step(params, cfg, toks[:, t], cache,
                                           commit=False)
                torch.cuda.synchronize()
                f_ms.append((time.perf_counter() - t0) * 1e3)
                for k, x in cache["kv"].items():
                    assert torch.equal(x, snap[k]), f"{arch} {k} written"
                assert torch.equal(frozen["len"], cache["len"])
                t0 = time.perf_counter()
                lt, cache = M.decode_step(params, cfg, toks[:, t], cache)
                torch.cuda.synchronize()
                t_ms.append((time.perf_counter() - t0) * 1e3)
                for k, delta in frozen["kv"].items():
                    wrote = cache["kv"][k][:, rows, at]
                    assert torch.equal(wrote[0], delta[0, :, 0]), \
                        f"{arch} {dtype} {k}: layer 0's delta"
                    deeper = max(deeper, _rel(delta[:, :, 0], wrote))
                split.append(lf[:, :v].float().cpu())
                commit.append(lt[:, :v].float().cpu())
            if dtype == "float32":
                assert deeper <= 1e-5, f"{arch} fp32 deltas: {deeper}"
            runs[dtype] = (torch.stack(split), torch.stack(commit),
                           float(np.median(f_ms)), float(np.median(t_ms)),
                           prompt_s, deeper)
            del params, cache, snap, frozen
            free_cards()
        f32, t32 = runs["float32"][:2]
        rel32 = max(_rel(a, b) for a, b in zip(f32, t32))
        assert rel32 <= 1e-5, f"{arch} fp32 split-KV logits: {rel32}"
        f16, t16 = runs["bfloat16"][:2]
        noise = max(_rel(a, b) for a, b in zip(t16, t32))
        held = ties = 0
        for step in range(SPLIT_STEPS):
            top2 = t32[step].topk(2, dim=-1).values
            lead = (top2[:, 0] - top2[:, 1]) / t32[step].abs().max()
            for r in range(SPLIT_ROWS):
                if float(lead[r]) > noise:
                    assert int(f16[step, r].argmax()) == \
                        int(t16[step, r].argmax()), \
                        f"{arch} bf16 step {step} row {r}"
                    held += 1
                else:
                    ties += 1
        print(f"(c) split-KV decode {arch} ({base.attn.value}, "
              f"{base.n_layers} layers) at full width, {SPLIT_ROWS} rows, "
              f"prompt {SPLIT_PROMPT} teacher-forced with commit=True, then "
              f"{SPLIT_STEPS} steps: fp32 commit=False logits within "
              f"{rel32:.3g} of max |logit| of commit=True's (tolerance "
              f"1e-5), deltas layer 0 bit for bit and the rest within "
              f"{runs['float32'][5]:.3g} of max |delta|; bf16: {held} greedy "
              f"tokens held, {ties} near ties let go (fp32 lead <= "
              f"{noise:.3g}, what bf16 moves the logits), layer 0's deltas "
              f"bit for bit (deeper {runs['bfloat16'][5]:.3g}); the frozen "
              f"cache untouched bit for bit every step; ms a step (median) "
              f"commit=False / commit=True: fp32 {runs['float32'][2]:.2f} / "
              f"{runs['float32'][3]:.2f}, bf16 {runs['bfloat16'][2]:.2f} / "
              f"{runs['bfloat16'][3]:.2f} (prompt {runs['float32'][4]:.1f} s "
              f"and {runs['bfloat16'][4]:.1f} s)")


def pipeline_part(dev) -> int:
    """Phase 17 (d): qwen3-0.6b's blocks as ``PIPE_STAGES`` GPipe stages on
    a logical ``("pod",)`` mesh of the card, against ``forward_hidden``;
    the gradients of a ``PIPE_GRAD_LAYERS``-layer fp32 copy against the
    sequential ones.  Returns the bf16 run's flash_attention launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_forward, stack_stages
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import rms_norm
    from repro_torch.tree import tree_items
    base = get_config(DIST_ARCH)
    mesh = Mesh.of(dev, (PIPE_STAGES,), ("pod",))
    rng = np.random.default_rng(DIST_SEED + 1)
    toks = torch.as_tensor(rng.integers(0, base.vocab_size, PIPE_SHAPE),
                           device=dev)
    launches = 0

    def stage_fn(cfg):
        def run(p_stage, h):
            for i in range(p_stage["ln1"].shape[0]):
                h = M._attn_mlp_block(M._layer({"layers": p_stage}, i), h,
                                      cfg)
            return h
        return run

    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = M.init_params(cfg, seed=DIST_SEED, device=dev)
        staged = stack_stages(params["layers"], PIPE_STAGES)
        with torch.no_grad():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = pipeline_forward(stage_fn(cfg), staged, params["embed"][toks],
                                 mesh=mesh, axis="pod",
                                 n_microbatches=PIPE_MICRO)
            got = rms_norm(h, params["final_norm"], cfg.rms_eps)
            torch.cuda.synchronize()
            pipe_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            t0 = time.perf_counter()
            want = M.forward_hidden(params, cfg, toks)
            torch.cuda.synchronize()
            seq_ms = (time.perf_counter() - t0) * 1e3
        n_fa = PIPE_MICRO * cfg.n_layers
        assert counts["flash_attention"] == n_fa and \
            sum(counts.values()) == n_fa, counts
        scale = float(want.float().abs().max())
        err = (got.float() - want.float()).abs()
        if dtype == "float32":
            assert float(err.max()) <= 1e-5 * scale, \
                f"fp32 pipeline: {float(err.max())} of {scale}"
        else:
            launches = counts["flash_attention"]
            tol = 2.0 ** -6 * want.float().abs() + 1e-4 * scale
            assert bool((err <= tol).all()), f"bf16 pipeline: {err.max()}"
        print(f"(d) pipeline_forward {DIST_ARCH} {dtype}: {cfg.n_layers} "
              f"blocks as {PIPE_STAGES} stages on {PIPE_STAGES} logical "
              f"shards of the card, {PIPE_SHAPE[0]} x {PIPE_SHAPE[1]} tokens "
              f"in {PIPE_MICRO} microbatches: {counts['flash_attention']} "
              f"flash_attention launches; against forward_hidden max |err| "
              f"{float(err.max()):.3g} of max |h| {scale:.3g}; "
              f"{pipe_ms:.1f} ms pipelined, {seq_ms:.1f} ms unpipelined "
              f"(host clock; the stages share one card)")
        del params, staged, h, got, want
        free_cards()
    cfg = dataclasses.replace(base, dtype="float32",
                              n_layers=PIPE_GRAD_LAYERS)
    params = M.init_params(cfg, seed=DIST_SEED, device=dev)
    leaves = [t.requires_grad_(True) for _, t in tree_items(params["layers"])]
    x = params["embed"][toks[:PIPE_GRAD_SHAPE[0], :PIPE_GRAD_SHAPE[1]]] \
        .detach()
    y = pipeline_forward(stage_fn(cfg), stack_stages(params["layers"],
                                                     PIPE_GRAD_LAYERS),
                         x, mesh=Mesh.of(dev, (PIPE_GRAD_LAYERS,), ("pod",)),
                         n_microbatches=2)
    g_pipe = torch.autograd.grad(y.square().mean(), leaves)
    g_seq = torch.autograd.grad(stage_fn(cfg)(params["layers"], x)
                                .square().mean(), leaves)
    worst = 0.0
    for (name, _), a, b in zip(tree_items(params["layers"]), g_pipe, g_seq):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert e <= 1e-4, f"pipeline gradient {name}: {e}"
        worst = max(worst, e)
    print(f"(d) pipeline gradients, {PIPE_GRAD_LAYERS} layers fp32 at "
          f"{PIPE_GRAD_SHAPE[0]} x {PIPE_GRAD_SHAPE[1]} ({PIPE_GRAD_LAYERS} "
          f"stages, 2 microbatches): every leaf within {worst:.3g} of its "
          f"largest |g| of the sequential gradients (tolerance 1e-4)")
    del params, leaves, x, y, g_pipe, g_seq
    free_cards()
    return launches


def sharded_step_part(dev, before_restore=lambda: None) -> int:
    """Phase 17 (e): the sharded train step of qwen3-0.6b at full width and
    depth in fp32 on a logical ``SHARD_MESH`` ("data", "model") mesh of
    the card against the single-device step, which then runs once more
    under the cost reader (its FLOPs and kernel-op calls equal to the
    same step's on meta: a train cell's count does not depend on the
    device); then the
    placed state saved and restored onto ``SHARD_RESTORE_MESH`` with
    ``shardings=``, exact (``before_restore()`` is called just before the
    save).  Returns the sharded step's flash_attention launches."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.distributed.sharding import (Mesh, _gather_leaf,
                                                  param_specs, place,
                                                  state_specs)
    from repro_torch.launch.cost_analysis import analyze_step
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.tree import tree_items
    cfg = dataclasses.replace(get_config(DIST_ARCH), dtype="float32")
    opt = AdamWConfig(**TRAIN_OPT)
    batch = SyntheticLM(cfg.vocab_size, SHARD_SHAPE[1], SHARD_SHAPE[0],
                        seed=DIST_SEED).batch_at(0)
    params = M.init_params(cfg, seed=DIST_SEED, device=dev)
    state = init_train_state(params)
    mesh = Mesh.of(dev, SHARD_MESH, ("data", "model"))
    placed = place(state, state_specs(state, mesh))
    gsh = param_specs(params, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1, m1 = make_train_step(cfg, opt)(state, batch)
    l1 = float(m1["loss"])
    one_s = time.perf_counter() - t0
    p1 = s1["params"]
    del s1
    got = analyze_step(make_train_step(cfg, opt), state, batch)
    want = analyze_step(make_train_step(cfg, opt), init_train_state(
        M.init_params(cfg, seed=DIST_SEED, device="meta")), batch)
    assert got.flops == want.flops and \
        got.while_trip_counts == want.while_trip_counts, \
        f"train step: analyzer on the card {got.flops} " \
        f"{got.while_trip_counts} != meta {want.flops} " \
        f"{want.while_trip_counts}"
    print(f"(e) cost reader on the single-device train step: FLOPs "
          f"{got.flops:.6e} on the card == {want.flops:.6e} on meta, "
          f"kernel-op calls {json.dumps(got.while_trip_counts)} (each "
          f"backward counted by its formula)")
    del state, params, m1
    free_cards()
    step = make_train_step(cfg, opt, grad_shardings=gsh)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2, m2 = step(placed, batch)
    l2 = float(m2["loss"])
    sharded_s = time.perf_counter() - t0
    counts = read_counts()
    del placed
    free_cards()
    n_fa = SHARD_MESH[0] * cfg.n_layers
    assert counts["flash_attention"] == n_fa and \
        sum(counts.values()) == n_fa, counts
    assert abs(l1 - l2) / abs(l1) < 2e-4, (l1, l2)
    worst = 0.0
    for (name, a), (_, x) in zip(tree_items(p1), tree_items(s2["params"])):
        c = _gather_leaf(x, dev)
        assert torch.allclose(c, a, rtol=2e-3, atol=2e-4), name
        worst = max(worst, float((c - a).abs().max()))
    del p1
    free_cards()
    print(f"(e) sharded train step {DIST_ARCH} fp32 full width and depth on "
          f"a logical {SHARD_MESH[0]} x {SHARD_MESH[1]} (data, model) mesh of "
          f"the card, {SHARD_SHAPE[0]} x {SHARD_SHAPE[1]} tokens: loss "
          f"{l2:.6f} vs single-device {l1:.6f} (rel "
          f"{abs(l1 - l2) / abs(l1):.3g}, tolerance 2e-4), params within "
          f"{worst:.3g} (rtol 2e-3, atol 2e-4); {counts['flash_attention']} "
          f"flash_attention launches ({SHARD_MESH[0]} DP blocks x "
          f"{cfg.n_layers}); {sharded_s * 1e3:.0f} ms sharded, "
          f"{one_s * 1e3:.0f} ms single-device (host clock, first steps)")
    mesh2 = Mesh.of(dev, SHARD_RESTORE_MESH, ("data", "model"))
    specs2 = state_specs(s2, mesh2)
    tmp = tempfile.mkdtemp(prefix="elastic_")
    need = sum(math.prod(x.shape) * x.shards[0].element_size()
               for _, x in tree_items(s2))
    saved, what = s2, "the whole placed state"
    if shutil.disk_usage(tmp).free < 2 * need:
        saved = {"params": s2["params"], "step": s2["step"]}
        specs2 = {"params": specs2["params"], "step": specs2["step"]}
        what = (f"the parameters and step only (the whole state, "
                f"{need / 1e9:.1f} GB, is more than half the free disk)")
    try:
        before_restore()
        t0 = time.perf_counter()
        save_checkpoint(tmp, saved, 1)
        restored, step_no = restore_checkpoint(tmp, saved, shardings=specs2)
        io_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert step_no == 1
    n = 0
    for (name, a), (_, b) in zip(tree_items(saved), tree_items(restored)):
        assert b.sharding.mesh is mesh2 and a.dtype == b.dtype, name
        assert torch.equal(_gather_leaf(a, dev), _gather_leaf(b, dev)), name
        n += 1
    print(f"(e) elastic restore: {what} ({need / 1e9:.1f} GB placed on "
          f"{SHARD_MESH[0]} x {SHARD_MESH[1]}) saved and restored onto a "
          f"logical {SHARD_RESTORE_MESH[0]} x {SHARD_RESTORE_MESH[1]} mesh "
          f"with shardings=: all {n} leaves equal bit for bit; save + "
          f"restore {io_s:.1f} s (beside the dry run)")
    del s2, saved, restored
    free_cards()
    return counts["flash_attention"]


def distributed_phase(dev, max_err: dict) -> list[dict]:
    """Phase 17: distributed/ and launch/ (ROADMAP section 1 item 6), on
    one card: every mesh is made of logical shards of it.  The dry run (a)
    runs on the host beside (e)'s checkpoint save and restore, after every
    other timing of the phase, and is read last."""
    print("phase 17: distributed and launch; every mesh below is logical "
          "shards of the one card (distinct cards have not run)")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    launches, row = executed_cells_part(dev, max_err)
    print(f"phase seconds: 17 (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split_kv_part(dev)
    print(f"phase seconds: 17 (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += pipeline_part(dev)
    print(f"phase seconds: 17 (d) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = []
    try:
        launches += sharded_step_part(dev, lambda: dry.append(DryRun()))
        print(f"phase seconds: 17 (e) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dryrun_part(dry[0])
    finally:
        for d in dry:
            d.stop()
    print(f"phase seconds: 17 (a) the rest of the dry run "
          f"{time.perf_counter() - t0:.1f} s")
    row["launches"] = launches
    return [row]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if (src / "repro_torch").is_dir():
        sys.path.insert(0, str(src))
    elif importlib.util.find_spec("repro_torch") is None:
        print(f"chip_smoke: no repro_torch in {src} nor on the import path "
              f"(PYTHONPATH={os.environ.get('PYTHONPATH', '')!r}); run it "
              f"from the repository root, or with PYTHONPATH=<repo>/src",
              file=sys.stderr)
        return 2
    import repro_torch.core.batch_sim as bs
    from repro_torch.core.batch_sim import segment_links
    from repro_torch.kernels import build_library
    from repro_torch.core.trace import prev_next_occurrence
    from repro_torch.data.traces import msr_trace
    from repro_torch.kernels.cache_sim.kernel import (LIBRARIES, LIVE_TILE,
                                                      SEGMENTS_SMEM_WIDTH,
                                                      TILE,
                                                      cache_sim_levels_scan,
                                                      cache_sim_scan,
                                                      cache_sim_segments_scan,
                                                      live_count_scan)
    from repro_torch.kernels.cache_sim.ref import (cache_sim_levels_ref,
                                                   cache_sim_levels_tiled_ref,
                                                   cache_sim_ref,
                                                   cache_sim_segments_ref,
                                                   cache_sim_segments_tiled_ref,
                                                   cache_sim_segments_tree,
                                                   cache_sim_tiled_ref,
                                                   live_counts_delta,
                                                   live_counts_onepass_ref,
                                                   live_counts_ref,
                                                   stack_distances_tree)
    from repro_torch.kernels.flash_attention.kernel import \
        LIBRARIES as FA_LIBRARIES
    from repro_torch.kernels.mamba2_ssd.kernel import \
        LIBRARIES as SSD_LIBRARIES
    from repro_torch.kernels.paged_attention.kernel import \
        LIBRARIES as PA_LIBRARIES
    from repro_torch.kernels.ro_replay.kernel import LIBRARIES as RO_LIBRARIES
    from repro_torch.kernels.ro_replay.kernel import (
        ro_token_replay_levels_scan, ro_token_replay_scan)
    from repro_torch.kernels.ro_replay.ref import (
        EDGE_CASES as RO_EDGE_CASES, ro_edge_tape, ro_token_replay_blocks_ref,
        ro_token_replay_levels_blocks_ref)
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
                 + PA_LIBRARIES + RO_LIBRARIES)
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
              f"(occ=1, occ=is_read; tile {TILE}; "
              f"{int((prev < 0).sum())} cold rows)")
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
    # the shared tiled count's corners: tile-edge intervals, intervals past
    # 16 whole tiles (a row's lanes loop), capacities of every kind
    for n in (1, 255, 256, 257, 4097, 65536):
        prev, nxt, reads = edge_tape(n, seed=n + 13, device=dev)
        starts, ends, whole = edge_rows(prev, TILE)
        assert (starts > 0 or n <= 2 * TILE) and (ends > 0 or n <= TILE)
        assert n < 65536 or whole > 16, whole
        p32, n32 = prev.to(torch.int32), nxt.to(torch.int32)
        ones = torch.ones_like(p32)
        got = urd_scan(p32, n32)
        check("urd_scan", f"edge tape n={n} vs dense", got,
              urd_scan_ref(p32, n32))
        check("urd_scan", f"edge tape n={n} vs tiled", got,
              cache_sim_tiled_ref(p32, n32, ones, TILE))
        cap1, captot = edge_caps(n, n, dev)
        for tag, occ in (("occ=1", ones),
                         ("occ=is_read", reads.to(torch.int32))):
            got = cache_sim_levels_scan(p32, n32, occ, cap1, captot)
            for plain, want in (
                    ("dense", cache_sim_levels_ref(p32, n32, occ, cap1,
                                                   captot)),
                    ("tiled", cache_sim_levels_tiled_ref(p32, n32, occ, cap1,
                                                         captot, TILE))):
                for g, w, lv in zip(got, want, ("l1", "union")):
                    check("cache_sim_levels_scan",
                          f"edge tape n={n} {tag} {lv} vs {plain}", g, w)
        print(f"check: urd_scan and cache_sim_levels_scan == dense and "
              f"tiled plain versions on the edge tape at n={n} ({starts} "
              f"rows start and {ends} end on a tile edge, up to {whole} "
              f"whole tiles; cap1 > captot on "
              f"{int((cap1 > captot).sum())} rows, cap1 = 0 on "
              f"{int((cap1 == 0).sum())}, captot = 0 on "
              f"{int((captot == 0).sum())})")
    # the one-pass live count's corners: a tile +- 1, several tiles, a
    # million rows; 1,500 deaths on one word, deaths anywhere, rows never
    # or always live; a second call and two tapes in turn give the same bits
    for n in (1, LIVE_TILE - 1, LIVE_TILE, LIVE_TILE + 1, 3 * LIVE_TILE + 1,
              1 << 20):
        nl, reads = live_edge_tape(n, n + 17, dev)
        for tag, occ in (("occ=is_read", reads), ("occ=1", torch.ones_like(nl))):
            got = live_count_scan(nl, occ)
            for plain, want in (
                    ("delta", live_counts_delta(nl, occ)),
                    ("one-pass", live_counts_onepass_ref(nl, occ, LIVE_TILE))):
                check("live_count_scan", f"edge tape n={n} {tag} vs {plain}",
                      got, want)
            if n <= LIVE_TILE + 1:
                check("live_count_scan", f"edge tape n={n} {tag} vs dense",
                      got, live_counts_ref(nl, occ))
            check("live_count_scan", f"edge tape n={n} {tag} again",
                  live_count_scan(nl, occ), got)
    tapes = [live_edge_tape(n, n, dev) for n in (300_000, 77_777)]
    first = [live_count_scan(*t) for t in tapes]
    for _ in range(2):
        for t, f in zip(tapes, first):
            check("live_count_scan", "two tapes in turn", live_count_scan(*t),
                  f)
    print(f"check: live_count_scan == live_counts_delta == "
          f"live_counts_onepass_ref (tile {LIVE_TILE}) on edge tapes at n = "
          f"1 .. 2^20 (1,500 deaths on one word, deaths anywhere, nxt = -1, "
          f"j, n rows; occ=1, occ=is_read); the same bits call to call and "
          f"for two tapes in turn")
    # the segments kernel on both sides of the shared-memory / global
    # boundary, links that cross a block, prev at or past the row
    for w in (64, 640, 4096, SEGMENTS_SMEM_WIDTH - 1, SEGMENTS_SMEM_WIDTH,
              SEGMENTS_SMEM_WIDTH + 1, 2 * SEGMENTS_SMEM_WIDTH):
        prev, nxt, occ1, reads = segment_group(
            w, [w, w // 2 + 1, 1, 0, w - 1], w, dev, cross=w // 8 + 1)
        for tag, occ in (("occ=1", occ1), ("occ=is_read", reads)):
            got = cache_sim_segments_scan(prev, nxt, occ, w)
            check("cache_sim_segments_scan", f"edge group w={w} {tag} vs tiled",
                  got, cache_sim_segments_tiled_ref(prev, nxt, occ, w))
            check("cache_sim_segments_scan", f"edge group w={w} {tag} again",
                  cache_sim_segments_scan(prev, nxt, occ, w), got)
            if prev.shape[0] <= 4096:
                check("cache_sim_segments_scan",
                      f"edge group w={w} {tag} vs dense", got,
                      cache_sim_segments_ref(prev, nxt, occ, w))
    print(f"check: cache_sim_segments_scan == cache_sim_segments_tiled_ref on "
          f"width groups of 64 .. {2 * SEGMENTS_SMEM_WIDTH} (shared memory up "
          f"to {SEGMENTS_SMEM_WIDTH}, the global count past it; links across "
          f"blocks, prev at or past the row; full, half, one-row and empty "
          f"segments), the same bits call to call")
    # the RO token replays: pressured blocks with one-row blocks,
    # capacity 0, warm L2 below l2_end and a clean L2, the same bits call
    # to call, and an empty call
    for seed in (1, 2, 3):
        for levels, kern, plain in (
                (False, ro_token_replay_scan, ro_token_replay_blocks_ref),
                (True, ro_token_replay_levels_scan,
                 ro_token_replay_levels_blocks_ref)):
            tape, starts, ends, caps = ro_tape(seed, dev, levels)
            args = ro_kernel_args((*tape, starts, ends, *caps))
            got = kern(*args)
            want = plain(*(x.cpu() for x in tape), starts, ends, *caps)
            again = kern(*args)
            for g, w, a in zip(got, want, again):
                check(kern.__name__, f"edge tape {seed}", g.cpu(), w)
                check(kern.__name__, f"edge tape {seed} again", a, g)
    assert all(x.numel() == 0 for x in ro_token_replay_scan(
        *ro_kernel_args((*tape, [], [], []))))
    # the edge tapes of the ring design (ref.EDGE_CASES)
    for case in RO_EDGE_CASES:
        for levels, kern, plain in (
                (False, ro_token_replay_scan, ro_token_replay_blocks_ref),
                (True, ro_token_replay_levels_scan,
                 ro_token_replay_levels_blocks_ref)):
            tape, starts, ends, caps = ro_edge_tape(case, levels, device=dev)
            args = ro_kernel_args((*tape, starts, ends, *caps))
            got = kern(*args)
            want = plain(*(x.cpu() for x in tape), starts, ends, *caps)
            again = kern(*args)
            for g, w, a in zip(got, want, again):
                assert g.shape == w.shape, f"{kern.__name__} {case} shape"
                check(kern.__name__, f"edge tape {case}", g.cpu(), w)
                check(kern.__name__, f"edge tape {case} again", a, g)
    print("check: ro_token_replay_scan == ro_token_replay_blocks_ref and "
          "ro_token_replay_levels_scan == ro_token_replay_levels_blocks_ref "
          "on pressured multi-block tapes (one-row blocks, capacity 0, "
          "warm L2 below l2_end, a clean L2) and on the edge tapes "
          f"{', '.join(RO_EDGE_CASES)} (65,536 and 66,175 rows, pointers "
          "thousands of rows behind t, warm L2 across ring tiles, 170 "
          "blocks, a hit chain across a block), the same bits call to "
          "call")
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
    count_host_tokens(bs)
    ro_timed: dict = {}
    with RoCalls(bs) as ro16:
        launches16, run16, _ = drive("16-tenant", dev, windows, MSR_16, 6000)
    ro_path_checks("16-tenant", ro16, check, ro_timed)
    del ro16
    t0 = time.perf_counter()
    dev16 = manager_device_phase(dev, "16-tenant", windows, MSR_16, 6000,
                                 run16)
    print(f"phase seconds: the 16-tenant manager under pipeline=\"device\" "
          f"{time.perf_counter() - t0:.1f} s")
    del run16
    from repro_torch.distributed import ShardMesh
    t0 = time.perf_counter()
    with default_mesh(ShardMesh((dev,) * SHARD_COUNTS[-1])):
        _, rec_sh16 = manager_device_phase(
            dev, f"16-tenant ({SHARD_COUNTS[-1]} logical shards)", windows,
            MSR_16, 6000, dev16, pipeline="sharded",
            against="the device pipeline's")
    seg_sh16 = [x["cache_sim_segments_scan"] for x in rec_sh16["launches"]]
    assert all(x > 0 and x % SHARD_COUNTS[-1] == 0 for x in seg_sh16), \
        seg_sh16
    segments_sh16 = sum(seg_sh16)
    print(f"phase seconds: the 16-tenant manager under pipeline="
          f"\"sharded\" {time.perf_counter() - t0:.1f} s")
    del dev16, rec_sh16

    # ------------------------------------------------ 5. the SHARDS path
    t0 = time.perf_counter()
    swindows = make_windows([nm.split("#")[0] for nm in SHARDS_NAMES],
                            SHARDS_WINDOWS)
    print(f"traces: {SHARDS_WINDOWS} windows x {len(SHARDS_NAMES)} tenants "
          f"x {ACCESSES} accesses generated in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed region)")
    import repro_torch.kernels.cache_sim.ops as cs_ops
    with Recorder(cs_ops, "cache_sim_scan") as tape256, \
            Recorder(bs, "ro_live_counts") as live256, RoCalls(bs) as ro256:
        launches256, run256, _ = drive("256-tenant", dev, swindows,
                                       SHARDS_NAMES, SHARDS_CAPACITY,
                                       want=("cache_sim_segments_scan",),
                                       cpu_budget=True)
    ro_path_checks("256-tenant", ro256, check, ro_timed)
    del ro256
    t0 = time.perf_counter()
    manager_device_phase(dev, "256-tenant (window 0, sampled)", swindows[:1],
                         SHARDS_NAMES, SHARDS_CAPACITY, run256)
    print(f"phase seconds: the 256-tenant window 0 under pipeline="
          f"\"device\" {time.perf_counter() - t0:.1f} s")
    del run256

    # ------------------------- 6. the ETICA path, with its residency routes
    routes = RouteReplays(dev)
    with RoCalls(bs) as ro_et:
        launches_et, _, (cpu_et, crec_et) = drive(
            "ETICA", dev, windows, MSR_16, ETICA_CAP1, scheme="etica",
            before_window=routes, capacity2=ETICA_CAP2, t_fast2=T_FAST2)
    ro_path_checks("ETICA", ro_et, check, ro_timed)
    del ro_et
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
            Recorder(bs, "ro_live_counts") as live_rec, RoCalls(bs) as ro_pr:
        launches_pr, (gpu_pr, _), _ = drive(
            "pressure", dev, windows[:PRESSURE_WINDOWS], MSR_16,
            PRESSURE_CAP1, scheme="etica", capacity2=PRESSURE_CAP2,
            t_fast2=T_FAST2, w_threshold=0.0)
    ro_path_checks("pressure", ro_pr, check, ro_timed)
    del ro_pr
    print(f"pressure: ro_token_replay_levels_scan launches on the card "
          f"{launches_pr['ro_token_replay_levels_scan']} (tenant-windows "
          f"through the host loop on the CPU: {tok.by_device['cpu']}, on "
          f"the card: {tok.by_device['cuda']}); live_count_scan launches "
          f"on the card path (L and U2): {launches_pr['live_count_scan']}; "
          f"ro_fallback_windows {gpu_pr.summary()['ro_fallback_windows']}")
    assert launches_pr["ro_token_replay_levels_scan"] >= 1 and \
        tok.by_device["cuda"] == 0, \
        "the two-level token replay did not run as a kernel on the card"
    assert gpu_pr.summary()["ro_fallback_windows"] == 0
    assert launches_pr["live_count_scan"] > 0
    assert all(t.policy.value == "ro" for t in gpu_pr.tenants)
    for name, launches in (("16-tenant", launches16),
                           ("256-tenant", launches256),
                           ("ETICA", launches_et), ("pressure", launches_pr)):
        print(f"live_count_scan launches on the {name} path: "
              f"{launches['live_count_scan']}; RO replay launches "
              f"{[launches[k] for k in RO_KERNELS]}")
    print(f"phase seconds: slices 1-3 paths done at "
          f"{time.perf_counter() - T_START:.1f} s")

    # --------------------------------- 8. the Table-3 Analyzer (urd_scan)
    t0 = time.perf_counter()
    launches_t3 = table3_phase(dev)
    print(f"phase seconds: Table-3 Analyzer {time.perf_counter() - t0:.1f} s")

    # ------------------------- 9. the thousand-tenant control plane
    t0 = time.perf_counter()
    launches_cp, segments_dp, segments_sh = control_plane_phase(dev)
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

    # ----------------------- 11b. faults and the degradation ladder
    t0 = time.perf_counter()
    fwindows = make_windows(MSR_16, FAULT_WINDOWS)
    launches_ft = fault_phase(dev, fwindows)
    del fwindows
    print(f"phase seconds: faults {time.perf_counter() - t0:.1f} s")

    # ------------------------------------ 12. the model layer, zamba2-7b
    t0 = time.perf_counter()
    model_rows = model_phase(dev, max_err)
    print(f"phase seconds: model layer {time.perf_counter() - t0:.1f} s")

    # ---------------------------- 13. the serving path, qwen3-0.6b
    t0 = time.perf_counter()
    serve_rows = serving_phase(dev, max_err)
    print(f"phase seconds: serving {time.perf_counter() - t0:.1f} s")

    # ------ 13b-d. the MoE, MLA and encoder-decoder families at full width
    t0 = time.perf_counter()
    family_rows = moe_serving_phase(dev, max_err)
    print(f"phase seconds: MoE serving (qwen2-moe-a2.7b) "
          f"{time.perf_counter() - t0:.1f} s")
    for arch in (MLA_ARCH, ENCDEC_ARCH):
        t0 = time.perf_counter()
        family_rows += family_model_phase(dev, max_err, arch)
        print(f"phase seconds: {arch} {time.perf_counter() - t0:.1f} s")

    # ------------------------------------ 16. training, qwen3-0.6b
    t0 = time.perf_counter()
    train_rows = training_phase(dev, max_err)
    print(f"phase seconds: training {time.perf_counter() - t0:.1f} s")

    # ------------------------------ 17. distributed and launch, qwen3-0.6b
    t0 = time.perf_counter()
    dist_rows = distributed_phase(dev, max_err)
    print(f"phase seconds: 17 distributed and launch "
          f"{time.perf_counter() - t0:.1f} s")

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
    # the previous design's work: every position of every hot interval
    walked = int((pos[hot] - prev[hot] - 1).sum())
    lo, hi = prev[hot] + 1, pos[hot]
    # the kernel's work: direct compares over an interval inside its row's
    # tile or over a head; a search a whole tile; tails come from the
    # tile's coverage count
    start = hi // TILE * TILE
    edge = torch.minimum(-(-lo // TILE) * TILE, start)
    direct = int(torch.where(lo > start, hi - lo, edge - lo).sum())
    searches = int((start // TILE - edge // TILE).clamp(min=0).sum())
    ms = cuda_ms(lambda: cache_sim_scan(p32, n32, ones), REPS)
    print(f"full tape, tile {TILE}: {direct} direct compares and {searches}"
          f" tile searches, tails by coverage (the previous design walked "
          f"{walked} positions); {ms:.4f} ms a call, "
          f"{graph_ms(lambda: cache_sim_scan(p32, n32, ones), REPS):.4f} ms "
          f"alone")
    plain_ms = cuda_ms(lambda: stack_distances_tree(prev, nxt_c), REPS // 4)
    # the function's floor: read prev, nxt, occ and write SD once; a
    # Fenwick-tree count needs n * ceil(log2 n) operations
    bnd, bnd_by = bound_ms(16 * m, m * math.ceil(math.log2(max(m, 2))))
    print(f"full tape: {m} accesses; cache_sim_scan {ms:.4f} ms at tile "
          f"{TILE} (before its redesign {PREV_MS['cache_sim_scan']} ms; "
          f"{ms / PREV_MS['cache_sim_scan_tiled']:.3f}x the tiled count's "
          f"{PREV_MS['cache_sim_scan_tiled']} ms before it was shared), "
          f"merge-tree route {plain_ms:.3f} ms, bound {bnd:.6f} ms by "
          f"{bnd_by}; kernel / bound = {ms / bnd:.1f}")
    # the 256-tenant path's window-0 tape (its first launch)
    p256, n256, o256 = tape256.args
    check("cache_sim_scan", "256-tenant tape vs merge tree",
          cache_sim_scan(p256, n256, o256),
          stack_distances_tree(p256.long(), n256.long()))
    m256 = int(p256.shape[0])
    bnd256, _ = bound_ms(16 * m256, m256 * math.ceil(math.log2(m256)))
    print(f"256-tenant window-0 tape: {m256} accesses; cache_sim_scan "
          f"{cuda_ms(lambda: cache_sim_scan(p256, n256, o256), REPS):.4f} ms "
          f"a call at tile {TILE}, bound {bnd256:.6f} ms by bytes")
    del p256, n256, o256
    tape256.args = None
    rows = [{
        "name": "cache_sim_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:63",
        "launches": launches16["cache_sim_scan"],
        "max_abs_err": max_err["cache_sim_scan"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": None}]

    # ---- 14b. urd_scan at a seed-row window, a Table-3 window and the
    # same 16-tenant tape
    def urd_timed(what, prev_l, nxt_l, reps=REPS):
        """Held to the merge tree, then a call, alone, the merge tree's
        time and the bound: reading prev and nxt and writing RD once (12 n
        bytes); a Fenwick-tree count's n * ceil(log2 n) operations."""
        p, q = prev_l.to(torch.int32), nxt_l.to(torch.int32)
        check("urd_scan", f"{what} vs merge tree", urd_scan(p, q),
              stack_distances_tree(prev_l, nxt_l))
        n_ = int(p.shape[0])
        call = cuda_ms(lambda: urd_scan(p, q), reps)
        alone = graph_ms(lambda: urd_scan(p, q), reps)
        plain = cuda_ms(lambda: stack_distances_tree(prev_l, nxt_l),
                        max(1, reps // 4))
        bnd_, by_ = bound_ms(12 * n_, n_ * math.ceil(math.log2(max(n_, 2))))
        print(f"{what}: {n_} accesses, {int((prev_l >= 0).sum())} hot; "
              f"urd_scan {call:.4f} ms a call, {alone:.4f} alone, "
              f"merge-tree route {plain:.3f} ms, bound {bnd_:.6f} ms by "
              f"{by_}; kernel / bound = {call / bnd_:.1f}")
        return call, plain, bnd_, by_

    from repro_torch.data.traces import synthetic_mix
    mix = synthetic_mix(CP_TENANTS, CP_ACCESSES, seed=CP_SEED)
    seed_links = [prev_next_occurrence(t.addrs.to(dev)) for t in mix]
    sr_ms, sr_plain, sr_bnd, sr_by = urd_timed(
        f"seed-row window (tenant 0 of synthetic_mix({CP_TENANTS}, "
        f"{CP_ACCESSES}, seed={CP_SEED}))", *seed_links[0])
    every = [(p.to(torch.int32), q.to(torch.int32)) for p, q in seed_links]
    row_ms = cuda_ms(lambda: [urd_scan(p, q) for p, q in every], 1)
    print(f"seed row: the {CP_TENANTS} windows one urd_scan call each in "
          f"turn, {row_ms:.3f} ms ({row_ms / CP_TENANTS:.4f} ms a call); "
          f"launches x (time - bound) = "
          f"{CP_TENANTS * (sr_ms - sr_bnd):.3f} ms")
    del mix, seed_links, every
    t3 = msr_trace(TABLE3[0], ACCESSES, seed=3)
    urd_timed(f"Table-3 window ({TABLE3[0]}; before the tiled count "
              f"{PREV_MS['urd_scan_table3']} ms)",
              *prev_next_occurrence(t3.addrs.to(dev)))
    urd_ms, urd_plain, urd_bnd, urd_by = urd_timed(
        f"full tape (before the tiled count {PREV_MS['urd_scan']} ms)",
        prev, nxt_c)
    # the row of earlier runs, at the 16-tenant tape, and the seed-row
    # window, where the control plane's launches run, as a row of its own
    urd_row = {
        "name": "urd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/urd_scan/csrc/urd_scan.cu",
        "replaces": "src/repro/kernels/urd_scan/kernel.py:62",
        "launches": launches_t3["urd_scan"] + launches_cp["urd_scan"],
        "max_abs_err": max_err["urd_scan"],
        "ms": urd_ms, "plain_ms": urd_plain, "bound_ms": urd_bnd,
        "bound_by": urd_by, "library_ms": None}
    urd_seed_row = {
        **urd_row, "shape": f"control-plane seed-row window, tenant 0 of "
                            f"synthetic_mix({CP_TENANTS}, {CP_ACCESSES}, "
                            f"seed={CP_SEED})",
        "launches": launches_cp["urd_scan"],
        "ms": sr_ms, "plain_ms": sr_plain, "bound_ms": sr_bnd,
        "bound_by": sr_by}
    print(f"urd_scan launches on its paths: Table-3 Analyzer "
          f"{launches_t3['urd_scan']}, control-plane seed row "
          f"{launches_cp['urd_scan']}; on the scenario path "
          f"{launches_sc['urd_scan']}; the kernels line gives its time at "
          f"the 16-tenant tape (with both paths' launches, as before) and "
          f"at the seed-row window (with the seed row's)")

    # ---- 14c. full sampled tape: cache_sim_segments_scan vs its tree
    str0 = swindows[0]
    kept, groups, args = sampled_tape(str0, dev)
    for (a, w) in args:
        check("cache_sim_segments_scan", f"sampled tape w={w} vs tree",
              cache_sim_segments_scan(*a, w), cache_sim_segments_tree(*a, w))
    m, ops = segments_work(groups)
    for a, w in args:
        print(f"sampled tape width {w} ({a[0].shape[0]} entries): "
              f"cache_sim_segments_scan "
              f"{cuda_ms(lambda: cache_sim_segments_scan(*a, w), REPS):.4f} "
              f"ms a call, "
              f"{graph_ms(lambda: cache_sim_segments_scan(*a, w), REPS):.4f} "
              f"alone; key words staged {segments_staged(a[0], w)}")
    seg_ms = cuda_ms(lambda: [cache_sim_segments_scan(*a, w)
                              for a, w in args], REPS)
    seg_alone = graph_ms(lambda: [cache_sim_segments_scan(*a, w)
                                  for a, w in args], REPS)
    seg_plain = cuda_ms(lambda: [cache_sim_segments_tree(*a, w)
                                 for a, w in args], REPS // 4)
    bnd, bnd_by = bound_ms(16 * m, ops)
    staged = sum(segments_staged(a[0], w) for a, w in args)
    print(f"sampled tape (window 0): {int(kept.sum())} kept of "
          f"{sum(len(t) for t in str0)} accesses, padded to {m} in "
          f"{len(groups)} width groups {[(w, hi - lo) for w, lo, hi in groups]}"
          f"; cache_sim_segments_scan {seg_ms:.4f} ms a call for the "
          f"{len(groups)} launches, {seg_alone:.4f} alone (before its "
          f"redesign {PREV_MS['cache_sim_segments_scan']} ms a call), "
          f"merge-sort tree {seg_plain:.3f} ms, bound {bnd:.6f} ms by "
          f"{bnd_by}; kernel / bound = {seg_ms / bnd:.1f}; key words staged "
          f"{staged} ({8 * staged / 1e6:.1f} MB of nxt and occ read, the "
          f"function's bytes {16 * m / 1e6:.1f} MB)")
    print(f"cache_sim_segments_scan launches: 256-tenant path "
          f"{launches256['cache_sim_segments_scan']}, the control plane's "
          f"DeviceWindowPipeline.run {segments_dp}, its sharded runs "
          f"(mesh= at {SHARD_COUNTS} logical shards and run_stream) "
          f"{segments_sh}, the 16-tenant manager under pipeline=\"sharded\" "
          f"{segments_sh16}")
    rows.append({
        "name": "cache_sim_segments_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_sim/csrc/"
                  "cache_sim_segments.cu",
        "replaces": "src/repro/kernels/cache_sim/kernel.py:136",
        "launches": (launches256["cache_sim_segments_scan"]
                     + segments_dp + segments_sh + segments_sh16),
        "max_abs_err": max_err["cache_sim_segments_scan"],
        "ms": seg_ms, "plain_ms": seg_plain, "bound_ms": bnd,
        "bound_by": bnd_by, "library_ms": None})
    del swindows, args

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
    lv_alone = graph_ms(lambda: cache_sim_levels_scan(p32, n32, ones, c132,
                                                      ct32), REPS)
    lv_plain = cuda_ms(levels_plain, REPS // 4)
    # the function's floor: read prev, nxt, occ, cap1, captot and write
    # both masks once (28 n bytes); a Fenwick count's n * ceil(log2 n)
    bnd, bnd_by = bound_ms(28 * m, m * math.ceil(math.log2(max(m, 2))))
    print(f"ETICA tape (window {WINDOWS - 1}, warm prefixes included): {m} "
          f"accesses, {int(hot.sum())} hot; cache_sim_levels_scan "
          f"{lv_ms:.4f} ms a call, {lv_alone:.4f} alone (before the tiled "
          f"count {PREV_MS['cache_sim_levels_scan']} ms), merge tree + "
          f"compares {lv_plain:.3f} ms, bound {bnd:.6f} ms by {bnd_by}; "
          f"kernel / bound = {lv_ms / bnd:.1f}")
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
    lc_alone = graph_ms(lambda: live_count_scan(n32, o32), REPS)
    lc_plain = cuda_ms(lambda: live_counts_delta(nxt_l, occ_l), REPS)
    # the function's floor: nxt and occ read, L written once (12 n
    # bytes); a prefix sum's n additions
    bnd, bnd_by = bound_ms(12 * m, m)
    print(f"pressure guard tape: {m} accesses; live_count_scan "
          f"{lc_ms:.4f} ms a call, {lc_alone:.4f} alone (before its "
          f"redesign {PREV_MS['live_count_scan']} ms a call), delta form "
          f"{lc_plain:.3f} ms, bound {bnd:.6f} ms by {bnd_by}; kernel / "
          f"bound = {lc_ms / bnd:.1f}")
    # the 256-tenant path's guard tape (window 1, its one launch)
    n256 = live256.args[0].to(torch.int32).contiguous()
    o256 = live256.args[1].to(torch.int32).contiguous()
    live256.args = None
    check("live_count_scan", "256-tenant guard tape vs delta",
          live_count_scan(n256, o256), live_counts_delta(n256, o256))
    m256 = int(n256.shape[0])
    bnd256, by256 = bound_ms(12 * m256, m256)
    call256 = cuda_ms(lambda: live_count_scan(n256, o256), REPS)
    print(f"256-tenant guard tape: {m256} accesses; live_count_scan "
          f"{call256:.4f} ms a call, "
          f"{graph_ms(lambda: live_count_scan(n256, o256), REPS):.4f} alone, "
          f"bound {bnd256:.6f} ms by {by256}; kernel / bound = "
          f"{call256 / bnd256:.1f}")
    del n256, o256
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
    # ---- 14f. the RO token replays at their paths' largest pressured
    # call (timed in phases 4-7, each held to its plain version there)
    ro_launch = {k: sum(x[k] for x in (launches16, launches256, launches_et,
                                       launches_pr, launches_ri))
                 for k in RO_KERNELS}
    for name in RO_KERNELS:
        t = ro_timed[name]
        print(f"{name}: largest call on the {t['path']} path, {t['rows']} "
              f"rows: {t['ms']:.3f} ms a call, plain version (host loops) "
              f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']} (the longest block's stepped rows x the "
              f"walk's dependent integer operation a step, or 15-16 bytes "
              f"a row); kernel / bound = {t['ms'] / t['bound_ms']:.1f}; "
              f"against the earlier bound (a dependent L1 hit a row, "
              f"{t['bound_l1_chain_ms']:.4f} ms) "
              f"{t['ms'] / t['bound_l1_chain_ms']:.2f}; launches on the "
              f"paths "
              f"{ro_launch[name]}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/ro_replay/csrc/ro_replay.cu",
            "replaces": "none: no TPU kernel (the reference's host loop "
                        + ("src/repro/core/batch_sim.py:539 and its "
                           "lax.fori_loop :726" if name == RO_KERNELS[0]
                           else "src/repro/core/batch_sim.py:589 and its "
                                "lax.fori_loop :845") + ")",
            "launches": ro_launch[name], "max_abs_err": max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_l1_chain_ms": t["bound_l1_chain_ms"],
            "library_ms": None})
    rows += [urd_row, urd_seed_row]
    rows.extend(model_rows)
    rows.extend(serve_rows)
    rows.extend(family_rows)
    rows.extend(train_rows)
    rows.extend(dist_rows)
    # phase 11b's launches beside each row's own (the pool crash's are
    # already on the serving rows)
    for r in rows:
        r["fault_launches"] = r.get("fault_launches", 0) + \
            launches_ft[r["name"]]
    print(f"fault phase launches: {json.dumps(dict(launches_ft))}")
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
