"""The traced run's readings, taken from the benchmark's own files.

- Spans: each ``spans/<name>.json`` names the module attributes (``module:
  attribute``) through which callers reach one layer; a traced frame runs
  with each wrapped in a ``torch.profiler.record_function`` range of the
  span's name.  A span's ``group`` says which metric reads it, and its
  ``kernels`` the hand-written kernels it launches (their function names
  as the profiler gives them).  A span with a ``query`` (``nearest`` or
  ``any``) is an intersection query: a counting run adds up its active
  rays on the device.
- The profile: frames under ``torch.profiler`` (CPU and CUDA), exported
  as a Chrome trace into a temporary directory of ``TMPDIR`` and read
  back; each device operation is tied to the spans around its launch by
  the launch's correlation id.
- Host syncs: torch's sync debug mode ``"warn"``, counted by file and
  line.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import json
import os
import tempfile
import time
import warnings
from pathlib import Path

import torch

JOB_SPAN = "ltbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _targets(spans: dict):
    for name, spec in spans.items():
        for target in spec["targets"]:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            yield name, spec, mod, attr


@contextlib.contextmanager
def patched(spans: dict, make):
    """Each target attribute replaced by ``make(name, spec, original)``
    while the block runs.  Every wrapper calls the original it replaced,
    so a call through any one binding makes one span."""
    saved = []
    try:
        for name, spec, mod, attr in _targets(spans):
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))
            setattr(mod, attr, make(name, spec, orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def _ranged(name, spec, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return wrapper


class QueryCounter:
    """Active rays of every intersection query, added up on the device
    (no readback until :meth:`totals`)."""

    def __init__(self):
        self.counts = {}

    def make(self, name, spec, fn):
        kind = spec.get("query")
        if kind is None:
            return fn
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            bound = sig.bind(*args, **kw)
            o = bound.arguments["origins"]
            active = bound.arguments.get("active")
            rays = (active.sum() if active is not None
                    else torch.tensor(o.shape[0], device=o.device))
            q, r = self.counts.get(kind, (0, 0))
            self.counts[kind] = (q + 1, r + rays)
            return fn(*args, **kw)
        return wrapper

    def totals(self) -> dict:
        return {k: {"queries": q, "rays": int(r)}
                for k, (q, r) in self.counts.items()}


def count_syncs(fn, where: dict) -> int:
    """Host syncs torch reports (sync debug mode "warn") while ``fn()``
    runs, also added up by file and line in ``where``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    for w in syncs:
        key = f"{Path(w.filename).name}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return len(syncs)


def profile(jobs, sync, spans: dict) -> dict:
    """Run each of ``jobs`` under the profiler inside a ``JOB_SPAN``
    range, with ``spans`` wrapped; returns the trace's events read back
    (see :func:`parse`)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with patched(spans, _ranged):
        with torch.profiler.profile(activities=acts) as prof:
            for job in jobs:
                with torch.profiler.record_function(JOB_SPAN):
                    job()
                    sync()
    with tempfile.TemporaryDirectory(prefix="ltbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, spans)


def parse(events: list, spans: dict) -> dict:
    """The trace's device operations, each with the names and groups of
    the spans around its launch, the traced window (the ``JOB_SPAN``
    ranges, first start to last end), the device's busy seconds in it
    and the host events (for what the host did in each idle gap)."""
    xs = [e for e in events if e.get("ph") == "X"]
    anns = [e for e in xs if e.get("cat") == "user_annotation"]
    jobs = [e for e in anns if e["name"] == JOB_SPAN]
    if not jobs:
        raise ValueError("the trace holds no job range")
    t0 = min(e["ts"] for e in jobs)
    t1 = max(e["ts"] + e["dur"] for e in jobs)
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["tid"], e["name"])
              for e in anns if e["name"] in spans]
    ops = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        names = set()
        if launch is not None:
            ts, tid = launch["ts"], launch["tid"]
            names = {n for a, b, t, n in ranges if t == tid and a <= ts <= b}
        ops.append({"name": e["name"], "cat": e["cat"], "ts": e["ts"],
                    "kernel": kernel_id(e["name"]),
                    "dur": e["dur"], "spans": names,
                    "groups": {spans[n]["group"] for n in names}})
    busy = _union(ops, t0, t1)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
            if e.get("cat") in HOST_CATS]
    return {"ops": ops, "t0": t0, "t1": t1, "window_s": (t1 - t0) / 1e6,
            "busy_s": busy / 1e6, "host": host}


def kernel_id(name: str) -> str:
    """A device operation's function name without its namespaces, template
    arguments and parameters: ``void (anonymous namespace)::f<...>(...)``
    -> ``f``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    for stop in "(<":
        name = name.split(stop, 1)[0]
    return name.strip().rsplit("::", 1)[-1]


def _merged(ops, t0, t1):
    iv = sorted((max(o["ts"], t0), min(o["ts"] + o["dur"], t1))
                for o in ops)
    out = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union(ops, t0, t1) -> float:
    return sum(b - a for a, b in _merged(ops, t0, t1))


BREAKDOWN_TOP = 10  # entries of each list of the breakdown
HOST_MIN_S = 0.5  # host-clocked frames run until their sum passes this
HOST_MIN_FRAMES, HOST_MAX_FRAMES = 3, 50


def breakdown(trace: dict) -> dict:
    """The device operations that took the most time, and the longest
    idle gaps of the device in the traced window, each named by the
    innermost host event running at its middle."""
    by_name = {}
    for o in trace["ops"]:
        by_name[o["name"]] = by_name.get(o["name"], 0.0) + o["dur"] / 1e6
    dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    busy = _merged(trace["ops"], trace["t0"], trace["t1"])
    edges = [trace["t0"]] + [x for iv in busy for x in iv] + [trace["t1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_TOP]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [h for h in trace["host"] if h[0] <= mid <= h[1]]
        label = max(inner, key=lambda h: h[0])[2] if inner else "(none)"
        named.append([label, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in dev], "idle_gaps": named}


def host_ms_per_frame(job, sync) -> float:
    """Host clock from a job's call to its return, before the sync that
    follows, averaged over frames until their sum passes
    ``HOST_MIN_S``."""
    times = []
    while (len(times) < HOST_MIN_FRAMES
           or (sum(times) < HOST_MIN_S and len(times) < HOST_MAX_FRAMES)):
        sync()
        t0 = time.perf_counter()
        job(len(times))
        times.append(time.perf_counter() - t0)
        sync()
    return 1e3 * sum(times) / len(times)
