"""Profiling: step timers, throughput counters, and the render's own spans
and counters.

The counterpart of ``light_transport_tpu.utils.profiling``: a per-step
wall timer, ``timed`` (which waits for the result's devices before it
stops the clock), the first-call / best-steady split, and a
``torch.profiler`` trace scope.

Spans and counters.  Tracing is on exactly while a ``torch.profiler``
records (:func:`tracing`); :func:`trace` is the operator's way to turn it
on around a render and keep the Chrome trace.  While it is on, the render
opens ``record_function`` ranges of fixed names, on the profiler's clock
beside the device's events:

- ``lt.frame``: the whole of ``api.render``;
- ``lt.camera``: the camera lanes and their uniforms;
- ``lt.bounce``: each bounce of a path tracer (``_bounce``);
- ``lt.nee``: the bounce's next-event estimate, its shadow queries
  included;
- ``lt.record``: ``trace_paths``'s stack of the per-bounce records;
- ``lt.compact``: ``trace_paths_compact``'s live-count readback and its
  shrink to the new width;
- ``lt.query.nearest``, ``lt.query.any``: the dispatch's nearest-hit and
  any-hit queries;
- ``lt.sort``: the coherence sort and the intersector call it wraps;
- ``lt.isect``: each intersector call of the dispatch.

``lt.frame`` also opens a counter record, which is added to the frame log
(the last :data:`FRAME_LOG_LEN` frames) when the frame closes;
:func:`frames` reads the log back.  Its counters, per frame:

- ``pairs.nearest``, ``pairs.any``: the (128-ray tile, 512-triangle
  cluster) pairs the cull admitted, over the cluster intersector's
  nearest-hit and any-hit queries;
- ``live_rays.nearest``, ``live_rays.any``: the rays of those queries with
  a non-empty interval (``t_max > t_min``);
- ``bounce_lanes``: the lane width of each bounce, added up.

The cull kernel adds its counts to a device accumulator itself, so a
traced frame launches no extra kernel and reads nothing back; counts
made outside a frame are dropped.  With tracing off a span or counter
site costs one read of the profiler's flag: no range, no tensor, no
launch, no readback.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """Accumulates per-step wall times; reports steps/sec.

    CUDA launches are asynchronous: ``step()`` times whatever runs inside
    the with-block, so the caller must wait for the device work
    themselves (``torch.cuda.synchronize()`` inside the block, or wrap
    the call in :func:`timed`); otherwise only the launch latency is
    recorded and the reported throughput is meaninglessly inflated."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.times)

    def steps_per_sec(self, units_per_step: float = 1.0) -> float:
        return len(self.times) * units_per_step / max(self.total, 1e-12)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists, dicts
    and named tuples."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def timed(fn: Callable, *args, **kwargs):
    """Run fn, wait for the devices of every CUDA tensor in its result
    (JAX's ``block_until_ready``; a CPU result waits for nothing), return
    (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def compile_and_steady(fn: Callable, *args, repeats: int = 3):
    """First-call time (kernel builds and caches included) and the best
    steady-state time of ``repeats`` further calls."""
    _, t_compile = timed(fn, *args)
    best = float("inf")
    for _ in range(repeats):
        _, t = timed(fn, *args)
        best = min(best, t)
    return t_compile, best


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` scope over the CPU and, when CUDA is available,
    the card; writes a Chrome trace into ``logdir`` (no-op when
    ``logdir`` is None).  Yields the profiler (None when off).  Inside
    it the render records its ``lt.*`` spans and logs its frames'
    counters (see the module's docstring)."""
    if logdir is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# the render's spans and counters
# ---------------------------------------------------------------------------

FRAME_LOG_LEN = 64  # frames the log keeps
QUERY_KINDS = ("nearest", "any")  # rows of the cull's accumulator

_NO_SPAN = contextlib.nullcontext()
_frame_log = collections.deque(maxlen=FRAME_LOG_LEN)
_open_frame = None  # the counter record of the frame being rendered
_accumulators = {}  # device -> the cull's (2, 2) int64 accumulator


def tracing() -> bool:
    """True while a ``torch.profiler`` records.  The flag is read from its
    module at each call: an imported copy would keep its first value."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while tracing, else a
    shared no-op context."""
    if tracing():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function runs inside :func:`span`
    ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not tracing():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _FrameCounts:
    """One frame's counters: host ints, and the cull's accumulator with its
    snapshots at the frame's first cluster query and at its close (the
    accumulator is never zeroed: a frame's counts are the difference,
    modulo 2^64, so counting costs no fill kernel)."""

    def __init__(self):
        self.bounce_lanes = 0
        self.acc = self.start = self.end = None

    def close(self):
        if self.acc is not None:
            self.end = self.acc.clone()

    def read(self) -> dict:
        out = {"bounce_lanes": self.bounce_lanes}
        diff = [[0, 0], [0, 0]]
        if self.acc is not None:
            s, e = self.start.tolist(), self.end.tolist()
            diff = [[(e[k][i] - s[k][i]) % (1 << 64) for i in range(2)]
                    for k in range(2)]
        for k, kind in enumerate(QUERY_KINDS):
            out[f"pairs.{kind}"], out[f"live_rays.{kind}"] = diff[k]
        return out


@contextlib.contextmanager
def frame():
    """The ``lt.frame`` span and the frame's counter record, logged when
    the frame closes; nothing while tracing is off."""
    global _open_frame
    if not tracing():
        yield
        return
    outer, _open_frame = _open_frame, _FrameCounts()
    try:
        with torch.profiler.record_function("lt.frame"):
            yield
        _open_frame.close()
        _frame_log.append(_open_frame)
    finally:
        _open_frame = outer


def cull_counts(kind: str, device) -> Optional[torch.Tensor]:
    """The ``(2,)`` int64 accumulator (admitted pairs, live rays) of the
    open frame's ``kind`` queries on ``device``, for the cull to add to;
    None while tracing is off, outside a frame, or on a second device."""
    if not tracing() or _open_frame is None:
        return None
    rec = _open_frame
    if rec.acc is None:
        device = torch.device(device)
        acc = _accumulators.get(device)
        if acc is None:
            acc = torch.empty((len(QUERY_KINDS), 2), dtype=torch.int64,
                              device=device)
            _accumulators[device] = acc
        rec.acc, rec.start = acc, acc.clone()
    elif rec.acc.device != torch.device(device):
        return None
    return rec.acc[QUERY_KINDS.index(kind)]


def count_lanes(n: int):
    """Add a bounce's lane width ``n`` to the open frame."""
    if tracing() and _open_frame is not None:
        _open_frame.bounce_lanes += int(n)


def frames() -> list:
    """The frame log, oldest first, each frame's counters as Python ints
    (reads the device's counts back)."""
    return [rec.read() for rec in _frame_log]
