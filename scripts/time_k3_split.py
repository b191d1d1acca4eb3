#!/usr/bin/env python3
"""Split K3's cluster queries into their parts and time the glass render,
for this tree's intersector and, in turns, an older tree's, inside one
run on an NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/time_k3_split.py [PARENT]

PARENT is a directory holding an older commit's
``light_transport_tpu_torch/`` (e.g. unpacked by ``git archive`` into a
git-ignored directory); its ``ops/intersect_kernel.py`` and its
``csrc/intersect_kernel.cu`` (built with the package's nvcc flags) take
the place of this tree's for its turns.  The turns run parent, this,
this, parent (this tree alone without PARENT).  In each turn:

* the glass preset (100x100, 4 spp, depth 3) from a fresh scene: the
  first and second call's host-clock walls, K3's launches a render, and
  the device's busy share of the second call under torch.profiler
  (``chip_smoke.glass_walls``);
* each cluster query the dispatch makes (nearest, any hit) for the glass
  preset's camera and bounce-1 rays and for 16,384 camera and 16,384
  interior rays of the 15-cluster soft-shadow layout: the query, K3's
  kernel and each function of ``ops/intersect_kernel`` it calls, under
  torch.profiler and by CUDA events (``chip_smoke.log_split``).

The last line is one JSON object with the card and the walls.
"""

import ctypes
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import light_transport_tpu_torch.ops as ops_pkg  # noqa: E402
from light_transport_tpu_torch.models.presets import glass_scene  # noqa: E402
from light_transport_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from time_k5r_parts import nvcc_variant  # noqa: E402

KEY = "light_transport_tpu_torch.ops.intersect_kernel"


def parent_intersect(parent):
    """PARENT's intersector module, launching PARENT's kernels (the C
    interface of its own source, whatever this tree's is)."""
    spec = importlib.util.spec_from_file_location(
        "intersect_kernel_parent",
        parent / "light_transport_tpu_torch/ops/intersect_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    path, _ = nvcc_variant(
        "intersect_parent",
        parent / "light_transport_tpu_torch/csrc/intersect_kernel.cu", [])
    cs.log("k3", f"built {path.name}", t0)
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.intersect_dense_launch.argtypes = [vp] * 4 + [i] * 3 + [vp] * 3
    lib.tile_cull_launch.argtypes = [vp] * 4 + [i] * 2 + [vp] * 3
    lib.intersect_gather_launch.argtypes = [vp] * 5 + [i] * 4 + [vp] * 2

    def run(name, dev, *args):
        rc = getattr(lib, f"{name}_launch")(
            *args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name}_launch failed: CUDA error {rc}")
        mod.LAUNCHES[name] += 1

    mod._run = run
    return mod


def main(argv):
    if argv[:1] and argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_k3_split: no CUDA device", file=sys.stderr)
        return 1
    card = cs.smi()
    cs.log("k3", f"{card}; torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}")
    cs._build.build("intersect_kernel")
    mods = {"this": ik}
    turns = ["this"]
    if argv:
        mods["parent"] = parent_intersect(Path(argv[0]).resolve())
        turns = ["parent", "this", "this", "parent"]
    result = {"card": card, "walls": {}}
    for name in turns:
        mod = mods[name]
        sys.modules[KEY], ops_pkg.intersect_kernel = mod, mod
        try:
            tag = f"[{name}] "
            glass = glass_scene(device=cs.DEV)
            walls, busy, _ = cs.glass_walls(mod, glass, "k3", tag)
            result["walls"].setdefault(name, []).append(
                {"first_s": walls[0], "second_s": walls[1],
                 "busy_ms": busy})
            cs.log_split("k3", mod, glass[0], cs.glass_batches(glass), tag)
            mid = cs.soft_shadow_scene(n_theta=44, n_phi=88)
            cs.log_split("k3", mod, mid,
                         cs.shadow_batches(mid, "15-cluster"), tag)
        finally:
            sys.modules[KEY], ops_pkg.intersect_kernel = ik, ik
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
