#!/usr/bin/env python3
"""Time ``pgd_solve``'s two summation routes at one tenant count.

    PYTHONPATH=src python benchmarks_torch/pgd_routes.py [--tenants 256]
        [--device cuda]

``repro_torch.core.partitioner`` sums over tenants left to right up to
32 tenants (XLA's CPU order, one launch per tenant) and as a pairwise
tree past 32.  This script times one ``pgd_solve`` (300 steps) on seeded
curves, the same recipe as ``tests/test_torch_core.py``, with the tree
route and with the left-to-right route forced past 32, on the given
device (default: the CUDA card), and prints the card's name and power
limit beside the times.  The optima of the two routes differ in the
last bits, so the largest gap between them is printed too.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import partitioner  # noqa: E402
from repro_torch.core.mrc import build_hit_ratio_functions  # noqa: E402


def curves(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    lens = rng.integers(50, 400, n)
    dist = np.concatenate([
        np.where(rng.random(ln) < 0.3, -1,
                 rng.integers(0, rng.integers(5, 300), ln)) for ln in lens])
    tid = np.repeat(np.arange(n), lens)
    return build_hit_ratio_functions(torch.as_tensor(dist, device=device),
                                     torch.as_tensor(tid, device=device), n,
                                     torch.as_tensor(lens, device=device))


def timed_solve(h, cap: int, device) -> tuple[float, torch.Tensor]:
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = partitioner.pgd_solve(h, cap, 1.0, 20.0, c_min=5)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, res.relaxed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=256)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pgd_routes: no CUDA device is visible", file=sys.stderr)
        return 2
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    h = curves(args.tenants, args.seed, device)
    cap = int(h.max_useful_sizes.sum() * 0.6)
    timed_solve(curves(40, 0, device), 500, device)          # warm-up
    tree_s, tree_c = timed_solve(h, cap, device)
    seq_max = partitioner._SEQ_MAX
    partitioner._SEQ_MAX = max(seq_max, args.tenants)        # left to right
    try:
        seq_s, seq_c = timed_solve(h, cap, device)
    finally:
        partitioner._SEQ_MAX = seq_max
    gap = float((tree_c.double() - seq_c.double()).abs().max())
    print(json.dumps({"tenants": args.tenants, "device": str(device),
                      "card": card, "tree_s": tree_s,
                      "left_to_right_s": seq_s, "max_gap_blocks": gap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
