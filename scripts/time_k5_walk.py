#!/usr/bin/env python3
"""Time K5, the treelet walk from the root, against an older tree's K5,
and the big-mesh route on the older tree, inside one run on an NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/time_k5_walk.py [--check] PARENT

PARENT is a directory holding an older commit's
``light_transport_tpu_torch/`` (e.g. unpacked by ``git archive`` into a
git-ignored directory) whose K5 reads the 64-byte fused node records
(``treelet_walk<any_hit, false, false>``).  On the big-mesh scene of
``chip_smoke.py``:

* the route on PARENT's treelet module and kernels: the render through
  the wavefront and through the sorted single launch in turns (wavefront,
  single, single, wavefront), by ``chip_smoke.route_turn`` (second-call
  wall, device busy, launches, host syncs and device time by kernel, the
  images bitwise this tree's);
* the six K5 launches of a single-route render (their operands captured
  on this tree): each held bitwise (best_t, best_tri, visits) through
  PARENT's kernel and this tree's, then timed in turns (PARENT, this
  tree, this tree, PARENT) by CUDA events and under the profiler, with
  its node visits, the share of them whose next node is the adjacent
  record and its largest per-ray visits; the heaviest launch's slowest
  ray timed alone through each;
* the single-route render through PARENT and this tree, in turns.

With --check the launches are only held, not timed.  The last line is one
JSON object with every number and the card.
"""

import contextlib
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import light_transport_tpu_torch as lt  # noqa: E402
import light_transport_tpu_torch.ops as ops_pkg  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402
from light_transport_tpu_torch.ops import treelet_kernel as tk  # noqa: E402

REPS = 5
PARENT_COUNTS = 5  # the older K5's counters
TURNS = ("parent", "ship", "ship", "parent")


def build_parent(parent):
    """PARENT's treelet module (its counts are this tree's
    ``tk.LAUNCHES``, so ``chip_smoke.check_route`` reads them) and its
    kernel library, built with the package's nvcc flags: K5 over the
    64-byte records (with T), K5r as this tree's."""
    spec = importlib.util.spec_from_file_location(
        "treelet_parent",
        parent / "light_transport_tpu_torch/ops/treelet_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    mod.LAUNCHES = tk.LAUNCHES
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "parent_treelet.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path),
         str(parent / "light_transport_tpu_torch/csrc/treelet_kernel.cu")],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for PARENT:\n{res.stdout}\n"
                           f"{res.stderr}")
    lib = _build.bind_treelet_kernel(ctypes.CDLL(str(path)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.treelet_walk_launch.argtypes = [vp, i, vp, vp] + [i] * 5 + [vp] * 5
    return mod, lib


def parent_walk(lib, feats, tables, any_hit):
    """One launch of PARENT's K5; returns (best_t, best_tri, visits)."""
    n = feats.shape[1]
    best_t = torch.empty((n,), dtype=torch.float32, device=cs.DEV)
    best_tri = torch.empty((n,), dtype=torch.int32, device=cs.DEV)
    visits = torch.empty((n,), dtype=torch.int32, device=cs.DEV)
    counts = torch.zeros((PARENT_COUNTS,), dtype=torch.int64, device=cs.DEV)
    ptr = tk._ptr
    rc = lib.treelet_walk_launch(
        ptr(feats), n, ptr(tables.node), ptr(tables.leaf),
        tables.leaf.shape[1], tables.max_leaf, tables.num_nodes, tables.T,
        int(any_hit), ptr(best_t), ptr(best_tri), ptr(visits), ptr(counts),
        tk._stream(cs.DEV))
    cs.check(rc == 0, f"parent treelet_walk_launch: CUDA error {rc}")
    return best_t, best_tri, visits


@contextlib.contextmanager
def parent_code(mod, lib):
    """The dispatch (which imports the treelet module at each query) on
    PARENT's module and library; PARENT's K5 profiled apart from K5r."""
    ship_lib = _build.load_treelet_kernel()
    category = cs.kernel_category

    def parent_category(key):
        if "treelet_walk<" in key:
            args = key.split("treelet_walk<")[1].split(">")[0].split(",")
            if len(args) == 3 and args[1].strip() == "false":
                return "K5 (parent)"
        return category(key)
    _build._loaded["treelet_kernel"] = lib
    sys.modules["light_transport_tpu_torch.ops.treelet_kernel"] = mod
    ops_pkg.treelet_kernel = mod
    cs.kernel_category = parent_category
    try:
        yield
    finally:
        _build._loaded["treelet_kernel"] = ship_lib
        sys.modules["light_transport_tpu_torch.ops.treelet_kernel"] = tk
        ops_pkg.treelet_kernel = tk
        cs.kernel_category = category


def lone_ray(feats, slow):
    """The lane ``slow`` of ``feats`` alone in one block, every other lane
    dead as ``_make_feats`` pads."""
    lone = torch.zeros((16, tk.DEFAULT_R), dtype=torch.float32, device=cs.DEV)
    lone[:, 0] = feats[:, slow]
    lone[5, 1:] = 1.0
    lone[6:8, 1:] = 1e20
    lone[8, 1:] = 1.0
    lone[10, 1:] = float("-inf")
    return lone


def main(argv):
    check_only = argv[:1] == ["--check"]
    argv = argv[check_only:]
    if len(argv) != 1 or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_k5_walk: no CUDA device", file=sys.stderr)
        return 1
    card = cs.smi()
    cs.log("k5", f"{card}; torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_treelet_kernel()
    mod, lib = build_parent(Path(argv[0]).resolve())
    cs.log("k5", "built this tree's and PARENT's treelet libraries", t0)
    scene, cfg, _ = cs.big_mesh_scene()
    tables = scene.treelet
    result = {"card": card}
    # the single-route render's K5 launches, on this tree
    with cs.treelet_route("single"), \
            cs.TreeletRecorder("treelet_walk") as rec:
        ref_img = lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
    _, _, counts = rec.summary()
    # the route on PARENT's code
    if not check_only:
        with parent_code(mod, lib):
            turns = [(f"parent, {r}", cs.route_turn(scene, cfg, r, ref_img))
                     for r in cs.ROUTE_TURNS]
        result["route_parent"] = cs.log_routes(turns)
    launches = []
    for k, ((feats, _, any_hit), c) in enumerate(zip(rec.launched, counts)):
        ref = parent_walk(lib, feats, tables, any_hit)
        got = tk.treelet_walk(feats, tables, any_hit)
        for what, a, b in zip(("best_t", "best_tri", "visits"), got, ref):
            cs.check(torch.equal(a, b), f"launch {k}: {what} differs in "
                                        f"{int((a != b).sum())} rays")
        launches.append({"rays": feats.shape[1], "any_hit": bool(any_hit),
                         "nodes": c[0], "leaves": c[1], "tris": c[2],
                         "adjacent": c[5], "max_visits": int(ref[2].max()),
                         "slowest": int(torch.argmax(ref[2]))})
        cs.log("k5", f"launch {k} ({'any hit' if any_hit else 'nearest'}, "
                     f"{feats.shape[1]} rays): {c[0]} node visits, "
                     f"{c[5] / max(c[0], 1):.3f} to the adjacent record, "
                     f"{c[1]} leaf visits, {c[2]} triangle tests, largest "
                     f"per-ray visits {launches[-1]['max_visits']}; bitwise "
                     f"PARENT's")
    result["launches"] = launches
    if check_only:
        print(json.dumps(result, default=str))
        return 0

    def walks(feats, any_hit):
        return {"parent": lambda: parent_walk(lib, feats, tables, any_hit),
                "ship": lambda: tk.treelet_walk(feats, tables, any_hit)}
    for k, ((feats, _, any_hit), lw) in enumerate(zip(rec.launched,
                                                      launches)):
        fns = walks(feats, any_hit)
        lw["ms"] = {name: {"events": [], "device": []} for name in fns}
        for name in TURNS:
            lw["ms"][name]["events"].append(
                cs.cuda_ms_each(lambda: None, fns[name], REPS))
            lw["ms"][name]["device"].append(cs.device_profile(
                lambda: [fns[name]() for _ in range(REPS)])[0] / REPS)
        cs.log("k5", f"launch {k}: ms by CUDA events / under the profiler: "
                     + "; ".join(
                         f"{name} " + "/".join(
                             ", ".join(f"{x:.4f}" for x in t[key])
                             for key in ("events", "device"))
                         for name, t in lw["ms"].items()))
    # the heaviest launch's slowest ray alone
    h = max(range(len(launches)), key=lambda i: launches[i]["nodes"])
    feats, _, any_hit = rec.launched[h]
    fns = walks(lone_ray(feats, launches[h]["slowest"]), any_hit)
    lone_ms = {name: [] for name in fns}
    for name in TURNS:
        lone_ms[name].append(cs.cuda_ms_each(lambda: None, fns[name], REPS))
    v = launches[h]["max_visits"]
    cs.log("k5", f"launch {h}'s slowest ray ({v} visits) alone, ms: "
                 + "; ".join(f"{n_} {', '.join(f'{x:.4f}' for x in ms)} "
                             f"({min(ms) / v * 1e6:.1f} ns a visit)"
                             for n_, ms in lone_ms.items()))
    result["lone"] = {"launch": h, "visits": v, "ms": lone_ms}
    # the single-route render through PARENT and this tree, in turns
    turns = []
    for name in TURNS:
        with parent_code(mod, lib) if name == "parent" \
                else contextlib.nullcontext():
            turns.append((f"{name}, single",
                          cs.route_turn(scene, cfg, "single", ref_img)))
    result["render_single"] = cs.log_routes(turns)
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
