"""The harness: driven by the files it finds by name, its result line, its
refusals, and what it may import."""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench import bench
from portbench.drivers import serve_closed_loop
from portbench.run import FORBIDDEN, loaded_forbidden, run_cell
from portbench.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
PB = tiny.REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_result_line_keys_in_order(tmp_path):
    root = tiny.make_tree(tmp_path)
    out = run_cell(root, "tiny-dense.tiny", 2**33 + 1, 1.0, False, "cpu",
                   time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    json.dumps(out)


def test_traced_line_has_per_layer_metrics_and_breakdown(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(serve_closed_loop, "TRACE_SECONDS", 1.0)
    root = tiny.make_tree(tmp_path)
    out = run_cell(root, "tiny-moe.tiny", 5, 1.0, True, "cpu",
                   time.perf_counter())
    assert list(out)[-2:] == ["breakdown", "compared"]
    assert {"decode_step_ms", "rebalance_ms", "serve_mfu"} <= set(
        out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    """A configuration, a mix, a cell and a metric added as files and
    entries, with no file of the harness edited."""
    before = {p: p.read_bytes() for p in PB.rglob("*.py")}
    root = tiny.make_tree(tmp_path, configs=(dict(tiny.DENSE, name="other"),),
                          mix=dict(tiny.MIX, clients=3))
    (root / "portbench" / "metrics" / "tokens_done.py").write_text(
        'UNIT, BETTER, SOURCE = "tokens", "higher", "host_clock"\n'
        "def read(run):\n    return run.window_tokens()\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "tokens_done", "unit": "tokens",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(root, "other.tiny", 3, 1.0, False, "cpu",
                   time.perf_counter())
    assert out["metrics"]["tokens_done"]["value"] > 0
    assert {p: p.read_bytes() for p in PB.rglob("*.py")} == before


PLUG_FAMILY = """from portbench.families import gqa
from portbench.families.gqa import (decode_bound_s, engine_kwargs,
                                    make_params, model_config, model_flops,
                                    pool_layout)


def prefill_bound_s(cfg, padded):
    return {**gqa.prefill_bound_s(cfg, padded), "plug_kernel": 1e-3}
"""

PLUG_REFERENCE = """import pathlib

from portbench.reference import gqa


def served_logits(*a, **k):
    pathlib.Path(__file__).with_suffix(".called").touch()
    return gqa.served_logits(*a, **k)
"""


def _files(root: pathlib.Path) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and "_cache" not in p.parts}


def test_new_family_and_reference_found_by_name(tmp_path, monkeypatch):
    """A model family and its reference added as files that exist only in
    the tree, with a kernel bound the harness has never heard of reaching
    a metric, and no file of the harness edited."""
    monkeypatch.setattr(serve_closed_loop, "TRACE_SECONDS", 1.0)
    before = _files(PB)
    root = tiny.make_tree(
        tmp_path, configs=(dict(tiny.DENSE, name="plug", family="plug"),))
    pb = root / "portbench"
    (pb / "families" / "plug.py").write_text(PLUG_FAMILY)
    (pb / "reference" / "plug.py").write_text(PLUG_REFERENCE)
    (pb / "metrics" / "plug_bound_ms.py").write_text(
        'UNIT, BETTER, SOURCE = "ms", "lower", "program_counter"\n'
        'LAYER, MOVES = "plug kernel", "tokens_per_s"\n'
        "def read(run):\n"
        '    b = run.bound_s.get("plug_kernel")\n'
        "    return 1e3 * b if b else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "plug_bound_ms", "unit": "ms",
                              "better": "lower",
                              "source": "program_counter",
                              "layer": "plug kernel",
                              "moves": "tokens_per_s",
                              "workloads": ["plug.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(root, "plug.tiny", 2**36 + 5, 1.0, True, "cpu",
                   time.perf_counter())
    assert out["correct"] is True, out["compared"]
    # one millisecond a prefill of the traced tail
    n = out["metrics"]["plug_bound_ms"]["value"]
    assert n >= 1 and n == pytest.approx(round(n))
    assert (pb / "reference" / "plug.called").exists()
    assert _files(PB) == before


def test_configuration_without_a_family_is_refused(tmp_path):
    cfg = {k: v for k, v in tiny.DENSE.items() if k != "family"}
    root = tiny.make_tree(tmp_path, configs=(cfg,))
    with pytest.raises(ValueError, match='"family"'):
        bench.Cell(root, bench.load(root), "tiny-dense.tiny")
    with pytest.raises(ValueError, match='"family"'):
        run_cell(root, "tiny-dense.tiny", 1, 1.0, False, "cpu",
                 time.perf_counter())


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_files_agree_with_benchmark_json(kind):
    for m in SPEC[kind]:
        mod = bench.metric_module(tiny.REPO, m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"]), m["name"]
        if kind == "per_layer":
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in cells.values():
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "limits" / f"{w['name']}.json").exists()
        reported = [m["name"] for m in e2e.values()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])
    used = {w["config"] for w in cells.values()}
    for c in configs.values():
        assert (tiny.REPO / c["file"]).exists() and len(c["why"]) <= 200
        assert c["name"] in used
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    assert len((tiny.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of the modules ``path`` imports (a relative import
    as ``.``)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module.split(".")[0] if node.level == 0 else ".")
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    """Every file under ``portbench/reference/``: not the port, and not
    the rest of the harness or a relative import, through which the port
    (the families, the drivers) could be reached."""
    paths = [p for p in (PB / "reference").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    assert {p.name for p in paths} >= {"__init__.py", "gqa.py"}
    for path in paths:
        assert path.suffix == ".py", path
        assert not _imports(path) & {"repro_torch", "portbench", "."}, path


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    import repro_torch  # noqa: F401  (the port is not the JAX package)
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert loaded_forbidden() == ["repro.models"]


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, **(env or {})))


def test_cli_refuses_without_a_card():
    r = _cli(tiny.REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "{" not in r.stdout


def test_cli_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    r = _cli(tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout
