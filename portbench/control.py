"""The readings a cell's correctness limit is set from, on the chip:

    python3 -m portbench.control --workload <name> --seconds 10 \
        --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell with a short window at
its own load; the program's widest and mean logit gap on the sampled
requests (the lower readings) and, on the same prompts and served
tokens, the same of the tokens that the reference computed from fp8
operands puts first (the control: the upper readings).  Prints one JSON
line per seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import ROOT, bench


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = bench.Cell(ROOT, bench.load(ROOT), args.workload)
    for seed in args.seeds:
        run = cell.run(seed=seed, seconds=args.seconds, trace=False,
                       device="cuda", t_start=time.perf_counter(),
                       control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": run.notes["readings"],
                          "control": run.notes.get("control"),
                          "lost_pages": run.compared["lost_pages"][0],
                          "requests": run.notes["checked_requests"],
                          "tokens": run.notes["checked_tokens"]}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
