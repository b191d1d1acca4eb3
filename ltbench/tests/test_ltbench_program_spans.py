"""The seven metrics that read the program's own spans and counters
(``program_spans.py``), on a synthetic trace and a stub frame log:
device time by span, idle time by the innermost span at each gap's
middle, the counters' ratios, and None where the spans or counters are
absent (an older program, or a route without the cull)."""

import pytest

import tiny
from light_transport_tpu_torch.utils import profiling
from ltbench import program_spans, tracing
from ltbench.registry import Registry

REG = Registry(tiny.REPO)
FRAMES = 2


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _launch(corr, at, cat, name, ts, dur):
    """A launch on the host at ``at`` and its device operation."""
    return [_ev("cuda_runtime", "cudaLaunchKernel", at, 2, corr=corr),
            _ev(cat, name, ts, dur, tid=7, corr=corr)]


# host ranges (us): the job 0-1000, lt.frame 10-940 around a camera, a
# bounce (a nearest query, an NEE with an any-hit query), a compaction
# and the record stack; a device operation in each
SPANS = [("lt.frame", 10, 930), ("lt.camera", 20, 40), ("lt.bounce", 100, 700),
         ("lt.query.nearest", 200, 200), ("lt.sort", 210, 180),
         ("lt.isect", 260, 120), ("lt.nee", 450, 250),
         ("lt.query.any", 500, 150), ("lt.sort", 510, 130),
         ("lt.isect", 520, 110), ("lt.compact", 820, 80),
         ("lt.record", 910, 25)]
OPS = [(1, 30, "kernel", "camera_kernel", 40, 10),
       (2, 110, "kernel", "elementwise_kernel", 120, 30),
       (3, 220, "kernel", "sort_kernel", 230, 20),
       (4, 270, "kernel", "intersect_gather_kernel", 280, 60),
       (5, 460, "gpu_memcpy", "Memcpy HtoD", 470, 10),
       (6, 530, "kernel", "intersect_gather_kernel", 540, 40),
       (7, 830, "kernel", "index_kernel", 840, 20),
       (8, 915, "kernel", "cat_kernel", 920, 10)]
# idle gaps by the innermost span at their middle
IDLE = {"lt.camera": 40, "lt.frame": 70, "lt.bounce": 80 + 130 + 260,
        "lt.isect": 30, "lt.sort": 60, "lt.compact": 60, None: 70}


def _record(with_spans=True):
    events = [_ev("user_annotation", tracing.JOB_SPAN, 0, 1000)]
    if with_spans:
        events += [_ev("user_annotation", n, ts, dur) for n, ts, dur in SPANS]
    for op in OPS:
        events += _launch(*op)
    return {"frames": FRAMES, "trace": tracing.parse(events, REG.spans())}


def read(name, record):
    return REG.module("metrics", name).read(record)


def test_span_files_name_the_program_spans():
    spans = REG.spans()
    lt = {n for n in spans if n.startswith("lt.")}
    assert lt == set(program_spans.LOOP + program_spans.QUERY
                     + program_spans.COMPACT)
    old = {s["group"] for n, s in spans.items() if not n.startswith("lt.")}
    for n in lt:
        assert spans[n]["targets"] == [] and spans[n]["group"] not in old


def test_device_time_by_span():
    rec = _record()
    # the bounce's own: the elementwise kernel and the NEE's copy, not
    # the queries' sort and intersector
    assert read("bounce_ms_per_frame", rec) == pytest.approx(40e-3 / FRAMES)
    # the sort's own: not the intersector inside it
    assert read("sort_ms_per_frame", rec) == pytest.approx(20e-3 / FRAMES)


def test_idle_by_innermost_span():
    rec = _record()
    assert program_spans.idle_by_span(rec["trace"]) == pytest.approx(IDLE)
    loop = read("loop_idle_ms_per_frame", rec)
    query = read("query_idle_ms_per_frame", rec)
    compact = read("compact_idle_ms_per_frame", rec)
    assert loop == pytest.approx(
        (40 + 70 + 80 + 130 + 260) / 1e3 / FRAMES)
    assert query == pytest.approx((30 + 60) / 1e3 / FRAMES)
    assert compact == pytest.approx(60 / 1e3 / FRAMES)
    # together: the idle inside lt.frame, which is the window's idle but
    # the gap after the frame closed
    window_idle = (1.0 - rec["trace"]["busy_s"] / rec["trace"]["window_s"]
                   ) * rec["trace"]["window_s"] * 1e3 / FRAMES
    assert loop + query + compact == pytest.approx(
        window_idle - 70 / 1e3 / FRAMES)


def _stub(monkeypatch, log):
    monkeypatch.setattr(profiling, "frames", lambda: list(log))


FRAME = {"pairs.nearest": 100, "pairs.any": 50, "live_rays.nearest": 1000,
         "live_rays.any": 600, "bounce_lanes": 2000}


def test_counters(monkeypatch):
    old = dict(FRAME, **{"pairs.nearest": 10**6})
    second = dict(FRAME, **{"pairs.any": 70, "live_rays.nearest": 1200})
    _stub(monkeypatch, [old, FRAME, second])
    rec = _record()
    assert read("isect_tests_per_ray", rec) == pytest.approx(
        (100 + 50 + 100 + 70) * 128 * 512 / (1000 + 600 + 1200 + 600))
    assert read("live_lane_pct", rec) == pytest.approx(
        100 * (1000 + 1200) / 4000)


def test_absent_reads_none(monkeypatch):
    rec = _record(with_spans=False)
    for name in ("bounce_ms_per_frame", "sort_ms_per_frame",
                 "loop_idle_ms_per_frame", "query_idle_ms_per_frame",
                 "compact_idle_ms_per_frame"):
        assert read(name, rec) is None, name
    counters = ("isect_tests_per_ray", "live_lane_pct")
    # a route without the cull (K3, K5): frames logged, nothing counted
    zero = dict.fromkeys(FRAME, 0)
    _stub(monkeypatch, [dict(zero, bounce_lanes=64)] * FRAMES)
    assert [read(n, rec) for n in counters] == [None, None]
    # fewer frames logged than traced, and a program without the log
    _stub(monkeypatch, [FRAME])
    assert [read(n, rec) for n in counters] == [None, None]
    monkeypatch.delattr(profiling, "frames")
    assert [read(n, rec) for n in counters] == [None, None]
