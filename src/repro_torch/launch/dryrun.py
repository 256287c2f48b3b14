"""Dry run of every (arch x shape x mesh) cell on ``meta``, with the
roofline of an H100 mesh.

The port of the reference's ``src/repro/launch/dryrun.py``.  The
reference lowers and compiles each cell's jitted step for the 16 x 16 and
2 x 16 x 16 production meshes on forced host devices; the port builds
each cell on ``meta`` (``launch.specs.build_cell``: shapes only, nothing
allocated) and runs its step there once under ``analyze_step``, which
proves the step runs at the cell's full shapes and counts its work:

  * FLOPs and bytes: ``analyze_step``'s counts of the whole (one-device)
    step, divided by the mesh's chip count: the specs split every
    product's work evenly over DP x TP (and FSDP), so each chip does
    1 / n_chips of it.  ``bytes_accessed`` is ``roofline.model_bytes``,
    the analytic HBM traffic; the analyzer's output-bytes proxy is kept
    beside it as a diagnostic.
  * collectives: ``planned_moves``, the bytes the port's sharded
    execution moves between mesh positions in one step, by kind: the
    FSDP all-gather of the parameters to each DP block of the batch, and
    for train cells the gradient reduce-scatter of every block of every
    microbatch and the gradient norm's all-reduce (the moves of
    ``make_train_step(grad_shardings=)``, which
    ``tests/test_torch_launch.py`` holds to ``analyze_step`` of that
    step).  Prefill and decode cells are charged the parameters' gather
    (the port has no sharded serving step; the split-KV decode keeps
    the cache where ``cache_specs`` puts it).  Divided by the chips.
  * per-device memory: the argument bytes of the largest mesh position,
    from the specs (``distributed.sharding.device_bytes``).  Temp and
    peak bytes are not measured on meta (``None``).

Roofline terms, against the sheet figures of an NVIDIA H100 80GB HBM3
(SXM5, 700 W): bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s a
direction within a pod (``data``, ``model``), 50 GB/s (400 Gb/s
InfiniBand) across pods; on the 2 x 16 x 16 mesh the share (pods - 1) /
pods of every collective crosses the ``pod`` axis.  HBM fit is against
80 GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
        --shape train_4k --both-meshes

``--part I/N`` keeps the cells ``I, I + N, ...`` of ``--all``'s list
(train cells first), so N processes can share the dry run.

Results go to ``results/dryrun_torch.json`` (one record per cell x mesh).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, skip_shapes
from repro_torch.distributed.ctx import (activation_rules,
                                         default_decode_rules,
                                         default_train_rules)
from repro_torch.distributed.sharding import (DP, NamedSharding, P,
                                              _div_ok, batch_specs,
                                              cache_specs, device_bytes,
                                              param_specs, shard_blocks,
                                              state_specs)
from repro_torch.launch.cost_analysis import StepCost, analyze_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_bytes, model_flops
from repro_torch.launch.specs import CellSpec, build_cell
from repro_torch.train.steps import row_blocks
from repro_torch.tree import tree_items

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS", "POD_BW",
           "TRAIN_MICROBATCHES", "append_result", "cell_cost", "main",
           "planned_moves", "run_cell"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch.json")

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), data-sheet figures
PEAK_FLOPS = 989e12          # bf16 dense, per chip
HBM_BW = 3.35e12             # bytes/s, per chip
NVLINK_BW = 450e9            # bytes/s a direction, within a pod
POD_BW = 50e9                # bytes/s, 400 Gb/s InfiniBand across pods
HBM_BYTES = 80e9

# per-arch microbatch counts for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "command_r_plus_104b": 4,
    "chameleon_34b": 4,
    "deepseek_moe_16b": 2,
    "zamba2_7b": 2,
    "minicpm3_4b": 2,
    "seamless_m4t_large_v2": 2,
}


def _rules(mesh, kind: str, sp: bool) -> dict:
    rules = default_train_rules(mesh, sp=sp)
    if kind == "decode":
        rules.update(default_decode_rules(mesh))
    return rules


def cell_cost(cell: CellSpec, mesh, *, sp: bool = True) -> StepCost:
    """``analyze_step`` of the cell's step on its stand-ins, under the
    activation rules (which change no count)."""
    with activation_rules(_rules(mesh, cell.kind, sp)):
        return analyze_step(cell.step_fn, *cell.args)


def _nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def planned_moves(cell: CellSpec, mesh, microbatches: int = 1
                  ) -> dict[str, float]:
    """Bytes the port's sharded execution of one step moves between mesh
    positions, by kind (module docstring)."""
    if cell.kind == "train":
        params, batch = cell.args[0]["params"], cell.args[1]
    elif cell.kind == "prefill":
        params, batch = cell.args
    else:
        params, batch = cell.args[0], {"tokens": cell.args[1]}
    leaves = [leaf for _, leaf in tree_items(params)]
    blocks = row_blocks(batch, mesh)
    moves = {"all-gather": float(len(blocks) * sum(map(_nbytes, leaves)))}
    if cell.kind != "train":
        return moves
    m = max(microbatches, 1)
    rows = batch["tokens"].shape[0] // m
    parts = sum(1 for i in range(m) for a, b, _ in blocks
                if max(a, i * rows) < min(b, (i + 1) * rows))
    moves["reduce-scatter"] = float(parts * 4 * sum(x.numel()
                                                    for x in leaves))
    n_blocks = sum(len(shard_blocks(tuple(leaf.shape), sh))
                   for (_, leaf), (_, sh) in zip(
                       tree_items(params),
                       tree_items(param_specs(params, mesh))))
    moves["all-reduce"] = float(4 * n_blocks)
    return moves


def _arg_shardings(cell: CellSpec, mesh) -> tuple:
    if cell.kind == "train":
        return (state_specs(cell.args[0], mesh),
                batch_specs(cell.args[1], mesh))
    if cell.kind == "prefill":
        return (param_specs(cell.args[0], mesh),
                batch_specs(cell.args[1], mesh))
    params, tokens, cache = cell.args
    dp = DP(mesh)
    tsh = NamedSharding(mesh, P(dp) if _div_ok(tokens.shape[0], mesh, dp)
                        else P())
    return param_specs(params, mesh), tsh, cache_specs(cache, mesh)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             sp: bool = True, remat: str = "full", microbatches: int = 1,
             commit: bool = False, verbose: bool = True,
             cell: CellSpec | None = None,
             cost: StepCost | None = None) -> dict:
    """One cell on one production mesh -> its record.  ``cell`` and
    ``cost`` (the same cell's, from another mesh) are reused when given:
    neither depends on the mesh."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    if cell is None:
        cell = build_cell(arch, shape_name, remat=remat,
                          microbatches=microbatches, commit=commit)
    if cost is None:
        cost = cell_cost(cell, mesh, sp=sp)
    t_analyze = time.time() - t0
    n_chips = mesh.size
    args_per_device = [0] * n_chips
    for args, sh in zip(cell.args, _arg_shardings(cell, mesh)):
        for i, nb in enumerate(device_bytes({"a": args}, {"a": sh})):
            args_per_device[i] += nb
    moves = planned_moves(cell, mesh, microbatches)
    coll = {k: v / n_chips for k, v in moves.items()}
    coll_total = sum(coll.values())
    pods = mesh.shape.get("pod", 1)
    cross = (pods - 1) / pods
    flops = cost.flops / n_chips
    bytes_acc = model_bytes(cell.cfg, cell.shape, n_chips, remat=remat,
                            sp=sp)
    mf = model_flops(cell.cfg, cell.shape) / n_chips
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": cell.kind, "sp": sp, "remat": remat,
        "microbatches": microbatches, "commit": commit,
        "n_chips": n_chips, "device": "meta",
        "per_device": {
            "flops": flops,
            "bytes_accessed": bytes_acc,
            "bytes_analyzer_proxy": cost.bytes / n_chips,
            "collective_bytes": coll_total,
            "collectives": coll,
            "kernel_op_calls": cost.while_trip_counts,
            "model_flops": mf,
            "arg_bytes": max(args_per_device),
            "temp_bytes": None,
            "output_bytes": None,
            "peak_bytes": None,
        },
        "memory_note": "temp and peak bytes are not measured on meta",
        "roofline_s": {
            "compute": flops / PEAK_FLOPS,
            "memory": bytes_acc / HBM_BW,
            "collective": (coll_total * (1 - cross) / NVLINK_BW
                           + coll_total * cross / POD_BW),
        },
        "model_flops_ratio": mf / flops if flops else 0.0,
        "hbm_fit": max(args_per_device) < HBM_BYTES,
        "analyze_s": round(t_analyze, 2),
        "peaks": "NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet",
        "ok": bool(math.isfinite(flops) and flops > 0),
    }
    if verbose:
        _print(rec)
    return rec


def _print(rec: dict) -> None:
    r, pd = rec["roofline_s"], rec["per_device"]
    dom = max(r, key=r.get)
    print(f"[{'OK' if rec['ok'] else 'FAIL'}] {rec['arch']} x {rec['shape']} "
          f"x {rec['mesh']}: compute {r['compute']:.3e}s, memory "
          f"{r['memory']:.3e}s, collective {r['collective']:.3e}s -> "
          f"{dom}-bound; args {pd['arg_bytes'] / 1e9:.2f} GB a chip (fit "
          f"{rec['hbm_fit']}); analyzed in {rec['analyze_s']} s")


def append_result(rec: dict, path: str = RESULTS) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = []
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data = [d for d in data
            if not (d["arch"] == rec["arch"] and d["shape"] == rec["shape"]
                    and d["mesh"] == rec["mesh"]
                    and d.get("tag") == rec.get("tag"))]
    data.append(rec)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch auto (TRAIN_MICROBATCHES)")
    ap.add_argument("--commit-cache", action="store_true",
                    help="in-place cache update (baseline decode)")
    ap.add_argument("--tag", default=None,
                    help="label for variants")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--part", default="0/1",
                    help="I/N: only cells I, I + N, ... of --all's list")
    args = ap.parse_args(argv)
    part, n_parts = (int(x) for x in args.part.split("/"))

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCH_IDS:
            skips = skip_shapes(a)
            cells += [(a, s) for s in SHAPES if s not in skips]
        # train cells first, so the parts share the long ones evenly
        cells.sort(key=lambda c: SHAPES[c[1]].kind != "train")
        cells = cells[part::n_parts]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures, records = [], []
    for arch, shape in cells:
        mb = args.microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        cell = cost = None
        for mp in meshes:
            try:
                if cell is None:
                    cell = build_cell(arch, shape, remat=args.remat,
                                      microbatches=mb,
                                      commit=args.commit_cache)
                    t0 = time.time()
                    cost = cell_cost(cell, make_production_mesh(
                        multi_pod=mp, device="meta"), sp=not args.no_sp)
                    t_analyze = time.time() - t0
                rec = run_cell(arch, shape, multi_pod=mp,
                               sp=not args.no_sp, remat=args.remat,
                               microbatches=mb, commit=args.commit_cache,
                               cell=cell, cost=cost, verbose=False)
                rec["analyze_s"] = round(t_analyze, 2)
                _print(rec)
                if args.tag:
                    rec["tag"] = args.tag
                append_result(rec, args.results)
                records.append(rec)
            except Exception as e:  # noqa: BLE001 - recorded, reported, exit 1
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
                append_result({"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if mp else "16x16",
                               "ok": False, "error": repr(e),
                               "tag": args.tag}, args.results)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} dry-run cells ran on meta")
    return records


if __name__ == "__main__":
    main()
