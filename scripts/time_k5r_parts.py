#!/usr/bin/env python3
"""Time K5r's redesign part by part against the treelet code it started
from, inside one run on an NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/time_k5r_parts.py [--check] PARENT \
        NAME=[SRC.cu][:FLAG,...] ...

PARENT is a directory holding an older commit's
``light_transport_tpu_torch/`` (e.g. unpacked by ``git archive`` into a
git-ignored directory), whose K5r took sorted copies of the lane state
and returned new tensors.  Each NAME is a build of this tree's
``light_transport_tpu_torch/csrc/treelet_kernel.cu`` (or SRC.cu, a version
of it with the same C interface) with the package's nvcc flags and the
given extra FLAGs, e.g. ``ship=`` for this tree's kernel as it is; all
builds run at once.  On the big-mesh scene of ``chip_smoke.py`` phase 11
it times one wavefront query (bounce-1 rays, nearest hit; shadow rays,
any hit):

* part 0: PARENT's driver, split into sort, gathers, K5r and host checks
  (CUDA events, ``torch.profiler`` and the host clock), with each
  launch's live lanes and largest per-ray visits;
* for each build: part 1 (the new kernel behind the old driver's sorted
  copies and host checks), part 2 (lane state in place, a host check a
  pass), part 3 (the package's driver, gated on the device), the queued
  driver and one K5 launch; K5r's counters per launch;
* the big-mesh render through PARENT and each build, in turns.

Every result is held bitwise against part 0's.  With --check the builds
are only held, not timed.  The last line is one JSON object with every
number and the card.
"""

import ctypes
import functools
import inspect
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import light_transport_tpu_torch as lt  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402
from light_transport_tpu_torch.ops import treelet_kernel as tk  # noqa: E402

# the wavefront driver's schedule: its keyword defaults
_WAVE = inspect.signature(tk.intersect_bvh_treelet_wavefront).parameters
LOADS_PER_PASS = _WAVE["loads_per_pass"].default
MAX_PASSES = _WAVE["max_passes"].default


def nvcc_variant(name, src, flags):
    """``src`` built with the package's nvcc flags and ``flags`` into a
    library of its own; returns its path and ptxas's report."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
           str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                           f"{res.stderr}")
    return lib, res.stdout + res.stderr


def parent_treelet(parent):
    """PARENT's treelet driver module, and a loader of its kernel library
    (the C interface before lane state in place)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "treelet_parent",
        parent / "light_transport_tpu_torch/ops/treelet_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look themselves up
    spec.loader.exec_module(mod)

    def bind(path):
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.treelet_walk_launch.argtypes = ([vp, i, vp, vp] + [i] * 7
                                            + [vp] * 9)
        lib.treelet_walk_launch.restype = ctypes.c_int
        lib.treelet_kernel_error_string.argtypes = [ctypes.c_int]
        lib.treelet_kernel_error_string.restype = ctypes.c_char_p
        return lib
    return mod, bind


def wall_ms(fn):
    """Host-clock ms of ``fn()`` from an idle card to its end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def device_split(fn):
    """Device ms and launches by kernel_category of one ``fn()`` under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            cat = cs.kernel_category(e.key)
            if cat == "K5r":  # by staging mode, the template's last flag
                args = e.key.split("treelet_walk<")[1].split(">")[0]
                cat += " " + args.split(",")[-1].strip()
            ms, c = out.get(cat, (0.0, 0))
            out[cat] = (ms + e.self_device_time_total / 1e3, c + e.count)
    return out


def split_parent(tko, feats, tables, any_hit, stats=False):
    """PARENT's wavefront driver step by step (its _wave_pass and
    _wave_live, 12 passes of one treelet and the unbounded one), CUDA
    events around its sort, its gathers and K5r, the host clock around its
    checks.  With ``stats``, also each launch's live lanes and largest
    per-ray visits (read back, so not timed)."""
    m = tables.num_nodes
    w = tko._wave_init(feats)
    ev = []
    check_ms, rows = 0.0, []

    def one(ml):
        nonlocal w
        e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        live = int((w.cursor < m).sum()) if stats else None
        e[0].record()
        key = torch.where(w.cursor < m, w.cursor, tko._DONE)
        perm = torch.argsort(key, stable=True)
        e[1].record()
        fs = w.feats[:, perm].contiguous()
        cur, bt, bi = w.cursor[perm], w.best_t[perm], w.best_tri[perm]
        e[2].record()
        cursor, best_t, best_tri, visits = tko.treelet_resume(
            fs, tables, cur, bt, bi, ml, any_hit)
        e[3].record()
        w = tko._Wave(fs, best_t, cursor, best_tri, w.orig[perm],
                      w.visits[perm] + visits)
        e[4].record()
        ev.append(e)
        if stats:
            rows.append((live, int(visits.max())))

    for _ in range(MAX_PASSES):
        t0 = time.perf_counter()
        live = tko._wave_live(w, tables)
        check_ms += (time.perf_counter() - t0) * 1e3
        if not live:
            break
        one(LOADS_PER_PASS)
    one(0)
    torch.cuda.synchronize()
    span = [[e[k].elapsed_time(e[k + 1]) for e in ev] for k in range(4)]
    return {"sort": sum(span[0]), "gather": sum(span[1]) + sum(span[3]),
            "k5r_events": sum(span[2]), "k5r_each": span[2],
            "check_host_ms": check_ms, "passes": len(ev), "rows": rows}


def copy_driver(o, d, t_max, tables, any_hit):
    """Part 1: the new K5r behind the old driver's data movement (sorted
    copies of the features and lane state, identity perm, a host check a
    pass, the inverse permutation at the end); returns (hit, stats) as
    the drivers do."""
    m = tables.num_nodes
    feats, n = tk._make_feats(o, d, tk.T_EPS, t_max, tk.DEFAULT_R)
    ident = torch.arange(n, device=cs.DEV)
    lanes, orig = tk.Lanes.start(feats), ident

    def one(ml):
        nonlocal feats, lanes, orig
        key = torch.where(lanes.cursor < m, lanes.cursor,
                          torch.iinfo(torch.int32).max)
        perm = torch.argsort(key, stable=True)
        feats = feats[:, perm].contiguous()
        sl = tk.Lanes(lanes.cursor[perm], lanes.best_t[perm],
                      lanes.best_tri[perm], lanes.visits[perm])
        tk.treelet_resume(feats, tables, ident, sl, ml, any_hit)
        lanes, orig = sl, orig[perm]

    for _ in range(MAX_PASSES):
        if not bool((lanes.cursor < m).any()):
            break
        one(LOADS_PER_PASS)
    one(0)
    inv = torch.empty_like(orig)
    inv[orig] = ident
    return tk._result(lanes.best_t[inv], lanes.best_tri[inv],
                      lanes.visits[inv], o.shape[0], any_hit, True, None)


def host_checked_driver(o, d, t_max, tables, any_hit):
    """Part 2: lane state in place behind a sorted permutation, with the
    old driver's host check before each bounded pass and no gate."""
    m = tables.num_nodes
    feats, _ = tk._make_feats(o, d, tk.T_EPS, t_max, tk.DEFAULT_R)
    lanes = tk.Lanes.start(feats)
    for p in range(MAX_PASSES):
        if not bool((lanes.cursor < m).any()):
            break
        tk.treelet_resume(feats, tables, tk._sorted_lanes(lanes, p == 0),
                          lanes, LOADS_PER_PASS, any_hit)
    tk.treelet_resume(feats, tables, tk._sorted_lanes(lanes, False), lanes,
                      0, any_hit)
    return tk._result(lanes.best_t, lanes.best_tri, lanes.visits,
                      o.shape[0], any_hit, True, None)


def main(argv):
    check_only = argv[:1] == ["--check"]
    argv = argv[check_only:]
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_k5r_parts: no CUDA device", file=sys.stderr)
        return 1
    parent = Path(argv[0]).resolve()
    variants = []  # (name, source, flags)
    for a in argv[1:]:
        name, spec = a.split("=", 1)
        src = _build.CSRC / "treelet_kernel.cu"
        if spec.split(":", 1)[0].endswith(".cu"):
            src, _, spec = spec.partition(":")
            src = Path(src).resolve()
        variants.append((name, src, [f for f in spec.split(",") if f]))
    card = cs.smi()
    cs.log("parts", f"{card}; torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}")
    tko, bind_parent = parent_treelet(parent)
    t0 = time.perf_counter()
    jobs = [("parent", parent / "light_transport_tpu_torch/csrc/"
             "treelet_kernel.cu", [])]
    jobs += variants
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: nvcc_variant(*j), jobs))
    cs.log("parts", f"built {len(jobs)} libraries", t0)
    libs = {"parent": bind_parent(built[0][0])}
    for (name, _, _), (path, report) in zip(variants, built[1:]):
        libs[name] = _build.bind_treelet_kernel(ctypes.CDLL(str(path)))
        print(f"  [{name}] ptxas:", flush=True)
        for line in report.splitlines():
            if "treelet_walk" in line or "registers" in line or \
                    "stack" in line:
                print("    " + line.strip()[:150], flush=True)

    def install(name):
        _build._loaded["treelet_kernel"] = libs[name]

    scene, cfg, _ = cs.big_mesh_scene()
    tables = scene.treelet
    _, batches = cs.big_mesh_batches(scene, cfg)
    queries = []
    for label, any_hit in (("bounce-1 rays", False), ("shadow rays", True)):
        _, bo, bd, t_near, t_any, act = next(b for b in batches
                                             if b[0] == label)
        t_hi = torch.where(act, t_any if any_hit else t_near, float("-inf"))
        feats, _ = tk._make_feats(bo, bd, tk.T_EPS, t_hi, tk.DEFAULT_R)
        queries.append((f"{label}, {'any hit' if any_hit else 'nearest'}",
                        bo, bd, t_hi, any_hit, feats))
    result = {"card": card, "queries": {}}
    reps = 5
    for label, bo, bd, t_hi, any_hit, feats in queries:
        q = result["queries"][label] = {}
        # part 0: PARENT's driver, its result the yardstick
        install("parent")
        wave0 = functools.partial(
            tko.intersect_bvh_treelet_wavefront, bo, bd, tables, t_max=t_hi,
            any_hit=any_hit, with_stats=True)
        ref = wave0()
        split = split_parent(tko, feats, tables, any_hit)
        stats = split_parent(tko, feats, tables, any_hit, stats=True)
        dev0 = device_split(wave0)
        syncs0 = cs.count_syncs(wave0)
        cs.log("parts", f"{label}, part 0 (parent): {split['passes']} K5r "
                     f"launches; device ms by kernel: "
                     + ", ".join(f"{k} {v[0]:.3f} (x{v[1]})"
                                 for k, v in sorted(dev0.items()))
                     + f"; by CUDA events: sort {split['sort']:.3f}, "
                     f"gathers {split['gather']:.3f}, K5r "
                     f"{split['k5r_events']:.3f} (per launch "
                     f"{[round(x, 4) for x in split['k5r_each']]}); host "
                     f"checks {split['passes'] - 1} blocking "
                     f"{split['check_host_ms']:.3f} ms; host syncs "
                     f"{syncs0}; per launch (live lanes, largest per-ray "
                     f"visits) {stats['rows']}")
        q["part0"] = {"split": {k: v for k, v in split.items()
                                if k != "rows"},
                      "rows": stats["rows"], "device": dev0,
                      "syncs": syncs0}
        wave = functools.partial(
            tk.intersect_bvh_treelet_wavefront, bo, bd, tables, t_max=t_hi,
            any_hit=any_hit, with_stats=True)
        single = functools.partial(
            tk.intersect_bvh_treelet, bo, bd, tables, t_max=t_hi,
            any_hit=any_hit, with_stats=True)
        parts = {
            "part1": lambda: copy_driver(bo, bd, t_hi, tables, any_hit),
            "part2": lambda: host_checked_driver(bo, bd, t_hi, tables,
                                                 any_hit),
            "part3": wave,
        }
        for name in libs:
            if name == "parent":
                continue
            install(name)
            for part, fn in {**parts, "K5": single}.items():
                cs.same_hits(f"{label}, {name} {part} against part 0", fn(),
                          ref)
            q[name] = {}
            with cs.TreeletRecorder("treelet_resume") as rec:
                wave()
            _, _, counts = rec.summary()
            q[name]["counts"] = counts
            cs.log("parts", f"{label}, {name}: parts 1-3 bitwise equal to "
                         f"part 0; K5r launches (node visits/share from "
                         f"shared memory/treelets staged): "
                + " ".join(f"{c[0]}/{c[3] / max(c[0], 1):.3f}/{c[4]}"
                           for c in counts))
            if check_only:
                continue
            q[name]["device"] = {part: device_split(fn)
                                 for part, fn in parts.items()}
            q[name]["k5"] = cs.cuda_ms_each(
                lambda: None, lambda: tk.treelet_walk(feats, tables,
                                                      any_hit), reps)
            q[name]["syncs"] = {part: cs.count_syncs(fn)
                                for part, fn in parts.items()}
        if check_only:
            continue
        install("parent")
        q["k5_parent"] = cs.cuda_ms_each(
            lambda: None, lambda: tko.treelet_walk(feats, tables, any_hit),
            reps)
        # host-clock walls in turns: parent, builds..., builds reversed,
        # parent; each part of a build one after the other
        walls = {}
        order = [n_ for n_ in libs if n_ != "parent"]
        for name in ["parent"] + order + order[::-1] + ["parent"]:
            install(name)
            fns = {"part0": wave0} if name == "parent" else {
                **parts,
                "queued": functools.partial(
                    tk.intersect_bvh_treelet_queued, bo, bd, tables,
                    t_max=t_hi, any_hit=any_hit),
                "single": single}
            for part, fn in fns.items():
                fn()
                walls.setdefault(f"{name} {part}", []).extend(
                    wall_ms(fn)[0] for _ in range(reps))
        q["walls"] = walls
        for key, ms in walls.items():
            cs.log("parts", f"{label}, {key}: wall {sum(ms) / len(ms):.3f} ms "
                         f"(min {min(ms):.3f}, {len(ms)} runs)")
        for name in order:
            d = q[name]["device"]
            cs.log("parts", f"{label}, {name}: device ms by part and kernel: "
                + "; ".join(f"{part} " + ", ".join(
                    f"{k} {v[0]:.3f} (x{v[1]})" for k, v in sorted(
                        dd.items())) for part, dd in d.items())
                + f"; K5 {q[name]['k5']:.4f} ms (parent's "
                  f"{q['k5_parent']:.4f}); host syncs {q[name]['syncs']}")
    if not check_only:
        result["render"] = render_turns(scene, cfg, tko, install,
                                        [n for n in libs if n != "parent"])
    print(json.dumps(result, default=str))
    return 0


def render_turns(scene, cfg, tko, install, names, reps=5):
    """The big-mesh render (phase 12's) through PARENT's treelet module
    and kernel and through each build, in turns (parent, builds, builds
    reversed, parent): host-clock walls, host syncs, and device busy and
    launches under the profiler.  The dispatch imports the treelet module
    at each query, so swapping the module swaps the driver."""
    import light_transport_tpu_torch.ops as ops_pkg
    key = "light_transport_tpu_torch.ops.treelet_kernel"
    out = {}
    ref = None
    for name in ["parent"] + names + names[::-1] + ["parent"]:
        mod = tko if name == "parent" else tk
        install(name)
        sys.modules[key], ops_pkg.treelet_kernel = mod, mod
        try:
            img = lt.render(scene, cfg, seed=0)
            if ref is None:
                ref = img
            cs.check(torch.equal(img, ref), f"render through {name} differs")
            r = out.setdefault(name, {"walls": []})
            r["walls"] += [wall_ms(lambda: lt.render(scene, cfg, seed=0))[0]
                           for _ in range(reps)]
            if "syncs" not in r:
                r["syncs"] = cs.count_syncs(lambda: lt.render(scene, cfg,
                                                           seed=0))
                dev = device_split(lambda: lt.render(scene, cfg, seed=0))
                r["busy_ms"] = sum(v[0] for v in dev.values())
                r["launches"] = sum(v[1] for v in dev.values())
        finally:
            sys.modules[key], ops_pkg.treelet_kernel = tk, tk
    for name, r in out.items():
        ms = sorted(r["walls"])
        cs.log("parts", f"render through {name}: wall {sum(ms) / len(ms):.2f} "
                     f"ms (median {ms[len(ms) // 2]:.2f}, {len(ms)} runs), "
                     f"device busy {r['busy_ms']:.2f} ms, {r['launches']} "
                     f"launches, {r['syncs']} host syncs; images equal")
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
