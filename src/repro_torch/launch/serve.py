"""Serving launcher: multi-tenant engine + ECI-managed pool.

The port of the reference's ``src/repro/launch/serve.py``, with the same
flags and ``--device`` besides (default: the CUDA card; ``--device cpu``
runs it on the host).  It serves the arch's reduced (smoke) config from
random parameters, seed 0:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
        --requests 12

It prints what was served, the tiered cache's summary (``pool:``) and
the run's profile (``profile:``): the mean ms of each span, the
counters, the last window-log rows and the requests' mean queue wait.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.configs import get_smoke_config
from repro_torch.core import ECICacheManager, StageProfile
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import build_heads
from repro_torch.serve.engine import MultiTenantEngine, Request


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--pool-pages", type=int, default=512)
    ap.add_argument("--capacity", type=int, default=192)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = M.init_params(cfg, seed=0, device=dev)
    _, hkv = build_heads(cfg)
    pool = BlockPool(args.pool_pages, args.page_size, cfg.n_layers, hkv,
                     cfg.head_dim, dtype=torch.float32, device=dev)
    manager = ECICacheManager(
        args.capacity, [f"tenant{i}" for i in range(args.tenants)],
        c_min=8, initial_blocks=args.capacity // max(args.tenants, 1),
        device=dev)
    profile = StageProfile()
    tiered = TieredKVCache(pool, manager, window_events=128, profile=profile)
    engine = MultiTenantEngine(cfg, params, tiered,
                               page_size=args.page_size,
                               max_pages_per_seq=32, profile=profile)

    rng = np.random.default_rng(0)
    shared = {t: rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
              for t in range(args.tenants)}
    t0 = time.perf_counter()
    for i in range(args.requests):
        t = i % args.tenants
        prompt = np.concatenate(
            [shared[t], rng.integers(0, cfg.vocab_size, 8).astype(np.int32)])
        engine.submit(Request(tenant=t, prompt=prompt,
                              max_new_tokens=args.max_new_tokens))
    engine.run(max_steps=args.requests * args.max_new_tokens + 8)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    done = len(engine.completed)
    toks = sum(len(r.generated) for r in engine.completed)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {done}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s) on {where}")
    print("pool:", tiered.summary())
    waits = [r.scheduled_ns - r.submit_ns for r in engine.completed]
    print("profile:", {**profile.spans_report(),
                       "queue_wait_ms": (sum(waits) / len(waits) * 1e-6
                                         if waits else None)})


if __name__ == "__main__":
    main()
