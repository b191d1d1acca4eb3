"""Readings of the program's own spans and counters in a traced run's
record (see ``metrics/``).

- Spans: while the profiler records, the program opens ``record_function``
  ranges named ``lt.*`` itself (``light_transport_tpu_torch.utils.
  profiling``); ``spans/lt.*.json`` name them, with no targets, so each
  device operation of the trace carries the ``lt.*`` spans around its
  launch, and the host events hold their ranges.
- Counters: the program logs each traced frame's counters;
  ``profiling.frames()`` reads the log back, of which the last
  ``record["frames"]`` are the profiled frames.

A program without them (an older checkout) reads None."""

from __future__ import annotations

import bisect
import importlib

from ltbench import tracing

PREFIX = "lt."
# the innermost span at an idle gap's middle names the gap's stage
LOOP = ("lt.frame", "lt.camera", "lt.bounce", "lt.nee", "lt.record")
QUERY = ("lt.query.nearest", "lt.query.any", "lt.sort", "lt.isect")
COMPACT = ("lt.compact",)


def device_ms_per_frame(record, inside, outside=()):
    """Device ms a frame of the operations launched inside a span of
    ``inside`` and inside none of ``outside``; None when no operation was
    launched inside ``inside``."""
    inside, outside = set(inside), set(outside)
    total, seen = 0.0, False
    for o in record["trace"]["ops"]:
        if not inside & o["spans"]:
            continue
        seen = True
        if not outside & o["spans"]:
            total += o["dur"]
    return total / 1e3 / record["frames"] if seen else None


def idle_by_span(trace) -> dict:
    """The device's idle time (us) in the traced window, by the innermost
    ``lt.*`` span open on the host at each idle gap's middle (the key None:
    outside every one)."""
    spans = sorted((a, -b, n) for a, b, n in trace["host"]
                   if n.startswith(PREFIX))
    starts = [s[0] for s in spans]
    busy = tracing._merged(trace["ops"], trace["t0"], trace["t1"])
    edges = [trace["t0"]] + [x for iv in busy for x in iv] + [trace["t1"]]
    out = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = None
        # the latest span started by mid that is still open is the
        # innermost (the ranges nest)
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if -spans[k][1] >= mid:
                label = spans[k][2]
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def idle_ms_per_frame(record, labels):
    """Device idle ms a frame in the gaps whose innermost ``lt.*`` span is
    one of ``labels``; None when the trace holds none of them."""
    trace = record["trace"]
    if not any(n in labels for _, _, n in trace["host"]):
        return None
    by = idle_by_span(trace)
    return sum(by.get(n, 0.0) for n in labels) / 1e3 / record["frames"]


def frame_counts(record):
    """The program's counters summed over the profiled frames; None where
    the program logs no frames."""
    try:
        profiling = importlib.import_module(
            "light_transport_tpu_torch.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "frames", None)
    if read is None:
        return None
    n = record["frames"]
    log = read()[-n:]
    if len(log) < n:
        return None
    return {k: sum(f[k] for f in log) for k in log[0]}
