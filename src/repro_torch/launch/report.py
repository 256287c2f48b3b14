"""Render the dry run's roofline table from ``results/dryrun_torch.json``.

The port of the reference's ``src/repro/launch/report.py``, against the
NVIDIA H100 80GB HBM3 (SXM5, 700 W) sheet figures of ``launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.report [--results path]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import HBM_BYTES, PEAK_FLOPS, RESULTS

__all__ = ["render"]


def render(path: str, mesh: str = "16x16") -> str:
    with open(path) as f:
        data = [d for d in json.load(f)
                if d.get("ok") and d["mesh"] == mesh and not d.get("tag")]
    data.sort(key=lambda d: (d["arch"], d["shape"]))
    out = ["| arch | shape | kind | compute s | memory s | collective s | "
           "bound | roofline frac | model/analyzed | HBM fit |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in data:
        r = d["roofline_s"]
        pd = d["per_device"]
        dom = max(r, key=r.get)
        tot = max(max(r.values()), 1e-30)
        # roofline fraction: useful-compute time / dominant-term time
        frac = (pd["model_flops"] / PEAK_FLOPS) / tot
        args_gb = pd["arg_bytes"] / 1e9
        fit = "yes" if pd["arg_bytes"] < HBM_BYTES else f"~{args_gb:.0f}G*"
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['kind']} | "
            f"{r['compute']:.2e} | {r['memory']:.2e} | "
            f"{r['collective']:.2e} | {dom} | {frac:.1%} | "
            f"{d['model_flops_ratio']:.2f} | {fit} |")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(render(args.results, args.mesh))


if __name__ == "__main__":
    main()
