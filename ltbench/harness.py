"""One run of one cell: set-up, the timed window, the traced readings
(``--trace 1``), the output check, and the result line.

The loop is closed with one client: each job starts when the one before
it has returned and the device has finished it.  Set-up (imports, the
kernels loaded or built, the scene built, ``warmup`` jobs of the cell's
own shapes) runs before the window.  A job's time runs on the host clock
from its call to the end of the ``torch.cuda.synchronize()`` after it.
The window runs from its first job's start to the end of the last job
started before ``seconds`` ran out; only whole jobs count.

After the window the device's peak memory is read, the program's state is
dropped, and the configuration's reference works the checked pixels of
sampled frames out again (``entries/<entry>.py``); each number compared
must be at most its limit in ``workloads/<cell>.json``."""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from ltbench import seeds, tracing
from ltbench.registry import Registry

TRACE_FRAMES = 2  # frames under the profiler, and counted, in a traced run


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _device_info(dev, chips: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    dev))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def _metrics(reg, cell: str, kind: str, record: dict) -> dict:
    out = {}
    for m in reg.metrics_of(cell, kind):
        value = reg.module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _traced(reg, cell, sess, seed, sync, dev) -> tuple:
    """The per-layer record of a traced run (see ``metrics/``) and its
    profile."""
    spans = reg.spans()
    record = {"frames": TRACE_FRAMES, "scene_build_s": sess.scene_build_s,
              "num_triangles": sess.num_triangles,
              "samples_per_job": sess.samples_per_job,
              "isect_kernels": sorted({k for s in spans.values()
                                       if s["group"] == "isect_kernel"
                                       for k in s.get("kernels", ())})}
    peaks = json.loads((reg.base / "peaks.json").read_text())
    record["peaks"] = peaks.get(_device_info(dev, 1)["kind"])
    record["host_ms_per_frame"] = tracing.host_ms_per_frame(
        lambda k: sess.job(seeds.part_seed(seed, seeds.TRACE, 100 + k)),
        sync)
    if dev.type == "cuda":
        where = {}
        record["syncs_per_frame"] = tracing.count_syncs(
            lambda: sess.job(seeds.part_seed(seed, seeds.TRACE, 99)), where)
        log("host syncs of one frame by place: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(where.items(),
                                            key=lambda kv: -kv[1])))
    frame_seeds = [seeds.part_seed(seed, seeds.TRACE, k)
                   for k in range(TRACE_FRAMES)]
    prof = tracing.profile([lambda s=s: sess.job(s) for s in frame_seeds],
                           sync, spans)
    counter = tracing.QueryCounter()
    with tracing.patched(spans, counter.make):
        for s in frame_seeds:
            sess.job(s)
            sync()
    record["queries"] = counter.totals()
    record["trace"] = prof
    return record, prof


def run(root, cell: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start=None) -> dict:
    """Run ``cell`` once; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = Registry(root)
    spec = reg.cell(cell)
    config = reg.config(spec["config"])
    traffic = reg.traffic(spec["traffic"])
    work = reg.workload(cell)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError("the harness drives a closed loop of one client")
    sess = reg.module("entries", traffic["entry"]).Session(reg, config, traffic, dev)
    n_pix = min(int(work["check"]["pixels"]), sess.pixels)
    ids = torch.as_tensor(np.sort(seeds.rng(seed, seeds.SAMPLE).choice(
        sess.pixels, n_pix, replace=False)), device=dev)
    for k in range(int(traffic["warmup"])):
        sess.job(seeds.part_seed(seed, seeds.WARMUP, k))
        sync()

    times, picks = [], []
    first = time.perf_counter()
    deadline = first + seconds
    last = first
    while not times or last < deadline:
        t0 = time.perf_counter()
        out = sess.job(seeds.part_seed(seed, seeds.JOB, len(times)))
        sync()
        last = time.perf_counter()
        times.append(last - t0)
        picks.append(sess.pick(out, ids))
        del out
    window = {"job_s": times, "window_s": last - first,
              "samples_per_job": sess.samples_per_job,
              "setup_s": first - t_start}
    device = _device_info(dev, int(spec["chips"]))
    log(f"{cell}: {len(times)} jobs in {window['window_s']:.4f} s, median "
        f"{1e3 * statistics.median(times):.4f} ms, setup "
        f"{window['setup_s']:.4f} s (scene build "
        f"{sess.scene_build_s:.4f} s), device peak "
        f"{device['memory_peak_bytes']} B")

    result = {"correct": False, "attempted": len(times), "failed": 0}
    if trace:
        record, prof = _traced(reg, cell, sess, seed, sync, dev)
        result["metrics"] = _metrics(reg, cell, "per_layer", record)
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["device"] = device
        result["breakdown"] = tracing.breakdown(prof)
    else:
        result["metrics"] = _metrics(reg, cell, "end_to_end", window)
        result["device"] = device

    # the output check, once the program's state is dropped
    sess.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = torch.stack(picks)
    result["failed"] = sess.failed(got)
    n_frames = min(int(work["check"]["frames"]), len(times))
    frames = np.sort(seeds.rng(seed, seeds.JOB).choice(
        len(times), n_frames, replace=False))
    t0 = time.perf_counter()
    want = sess.reference_pixels(
        [seeds.part_seed(seed, seeds.JOB, int(f)) for f in frames], ids)
    numbers = sess.compare(got[torch.as_tensor(frames, device=dev)], want)
    log(f"reference: frames {frames.tolist()}, {n_pix} pixels each, "
        f"{time.perf_counter() - t0:.4f} s")
    limits = work["limits"]
    result["correct"] = bool(result["failed"] == 0 and all(
        numbers[k] <= limits[k] for k in numbers))
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in numbers}
    log(f"failed jobs {result['failed']} limit 0")
    for k in numbers:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return result
