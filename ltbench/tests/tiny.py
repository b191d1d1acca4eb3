"""A benchmark root of small cuts of the benchmark's own cells, for CPU
tests: the ltbench files copied beside a BENCHMARK.json whose cells name
configurations cut to a few hundred triangles and 16x16 frames."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "ltbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

# (configuration, frame edge, spp, sphere bands, sphere segments)
CUTS = {"soft_shadow_123k": (16, 2, 22, 44)}


def tiny_config(name: str) -> dict:
    cfg = json.loads((SRC / "configs" / f"{name}.json").read_text())
    edge, spp, n_theta, n_phi = CUTS[name]
    for shape in cfg["shapes"]:
        if shape["shape"] == "uv_sphere":
            shape.update(n_theta=n_theta, n_phi=n_phi)
    cfg["render"].update(width=edge, height=edge, spp=spp)
    cfg["reduced"] = ["shapes", "render"]
    return cfg


def make_root(tmp: Path) -> Path:
    """``tmp`` as a checkout root: ``ltbench/`` without its tests, its
    configurations cut by :data:`CUTS`, and a BENCHMARK.json of the same
    cells and metrics over them."""
    root = Path(tmp)
    shutil.copytree(SRC, root / "ltbench", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        (root / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
