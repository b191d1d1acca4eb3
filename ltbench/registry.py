"""Where the benchmark finds its parts: every configuration, traffic mix,
cell, metric, shape, span, entry and reference is a file of its own,
found by its name under ``<root>/ltbench/``, so that a new one is a new
file and no file is edited.

- ``BENCHMARK.json`` at the root names the cells, configurations and
  metrics;
- ``configs/<config>.json``: a configuration's scene and frame size (the
  ``file`` that ``BENCHMARK.json`` gives);
- ``traffic/<traffic>.json``: a traffic mix's entry, depth, flags and loop;
- ``workloads/<cell>.json``: a cell's output check (its sample and the
  limits of the numbers compared);
- ``metrics/<metric>.py``: ``read(record)``, the metric's value or None;
- ``shapes/<shape>.py``: ``triangles(spec)``, a shape's (T, 3, 3)
  vertices;
- ``spans/<span>.json``: the module attributes a traced run wraps in a
  profiler range, and the span's group;
- ``entries/<entry>.py``: how a traffic mix drives the program;
- ``reference/<reference>.py``: a configuration's plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PACKAGE = "ltbench"


class Registry:
    """The benchmark's files under one checkout root."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self.base = self.root / PACKAGE
        self.benchmark = json.loads(
            (self.root / "BENCHMARK.json").read_text())

    # --- BENCHMARK.json entries -------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics_of(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        whose ``workloads`` list it, or without the key, every cell."""
        return [m for m in self.benchmark[kind]
                if "workloads" not in m or cell in m["workloads"]]

    # --- files found by name ----------------------------------------------
    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.base / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.config_entry(name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def spans(self) -> dict:
        return {p.stem: json.loads(p.read_text())
                for p in sorted((self.base / "spans").glob("*.json"))}

    def module(self, kind: str, name: str):
        """``<root>/ltbench/<kind>/<name>.py`` loaded as a module of its
        own (``ltbench_<kind>_<name>``)."""
        path = self.base / kind / f"{name}.py"
        key = f"{PACKAGE}_{kind}_{name}".replace(".", "_").replace("-", "_")
        cached = sys.modules.get(key)
        if cached is not None and Path(cached.__file__) == path:
            return cached
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod
