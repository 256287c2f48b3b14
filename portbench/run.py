"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (the port's kernels built into the
checkout, weights made on the card from the seed, the cell's traffic run
until every client has been answered) is timed as ``setup_s``; the window
then runs for ``--seconds``; after it the program's state is freed and
the served tokens are scored by the plain reference.  Standard output
ends with one JSON line (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the check compared, beside its limit); the
numbers compared also end standard error.  Exits 2 without a result when
no card is visible, too few for the cell, or the port is missing; 3 when
the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "portbench" / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, fault=None) -> dict:
    """The result line of one run (``fault``: for the tests, see the
    drivers)."""
    from portbench import bench
    spec = bench.load(root)
    cell = bench.Cell(root, spec, workload)
    run = cell.run(seed=seed, seconds=seconds, trace=trace, device=device,
                   t_start=t_start, fault=fault)
    metrics = {}
    for m in bench.metrics_for(spec, workload, trace):
        value = bench.metric_module(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(v <= lim for v, lim in run.compared.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": run.device}
    if trace and run.trace is not None:
        top = sorted(run.trace["ops"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(run.trace["idle"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:200], s] for n, s in top],
                            "idle_gaps": [[n, s] for n, s in idle]}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in run.compared.items()}
    return out


def loaded_forbidden() -> list[str]:
    """Modules in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: ``repro_torch`` is
    not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no port at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch
    from portbench import bench
    chips = bench.Cell(ROOT, bench.load(ROOT), args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)        # one process, few threads on the host
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: this process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
