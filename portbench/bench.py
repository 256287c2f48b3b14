"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under the checkout's ``portbench/``:

* ``configs/<config>.json`` (the path in ``configs[].file``),
* ``traffic/<traffic>.json``, whose ``driver`` names the module of
  ``portbench/drivers/`` that runs it,
* ``metrics/<metric>.py``, with ``UNIT``, ``BETTER``, ``SOURCE``,
  ``LAYER`` (per-layer metrics), ``MOVES`` (per-layer metrics) and
  ``read(run) -> float | None``,
* ``limits/<workload>.json``, the correctness limits of a cell,
* ``families/<family>.py`` and ``reference/<family>.py``, for the
  ``family`` a configuration file names: what depends on the model's
  architecture (``portbench/families/__init__.py``) and its plain
  reference.

So a later change adds a configuration, a model family, a mix, a cell or
a metric by adding files and entries, and edits no file that is there.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

__all__ = ["Cell", "file_module", "load", "metric_module",
           "metrics_for"]


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, root: pathlib.Path, spec: dict, name: str):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(by_name)})")
        self.root, self.spec, self.name = root, spec, name
        self.entry = by_name[name]
        cfg_entry = {c["name"]: c for c in spec["configs"]}[
            self.entry["config"]]
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        if "family" not in self.config:
            raise ValueError(
                f"{cfg_entry['file']} has no \"family\" key: it names "
                "portbench/families/<family>.py, which builds, sizes and "
                "weighs the model, and portbench/reference/<family>.py")
        self.traffic = json.loads((root / "portbench" / "traffic"
                                   / f"{self.entry['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((root / "portbench" / "limits"
                                  / f"{name}.json").read_text())
        self.chips = int(self.entry["chips"])

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")

    def run(self, **kw):
        """One run of the cell by its driver: its configuration, mix,
        limits, family and reference, and ``kw``."""
        family = self.config["family"]
        return self.driver().run(
            self.config, self.traffic, limits=self.limits,
            family=file_module(self.root, "families", family),
            reference=file_module(self.root, "reference", family), **kw)


def load(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones untraced, the per-layer ones traced.  An entry without a
    ``workloads`` key is reported in every cell (a per-layer one, in every
    cell that reports what it ``moves``)."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in e2e_names]


def file_module(root: pathlib.Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` of the checkout, loaded from its
    file."""
    path = root / "portbench" / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_module(root: pathlib.Path, name: str):
    """``portbench/metrics/<name>.py`` of the checkout."""
    return file_module(root, "metrics", name)
