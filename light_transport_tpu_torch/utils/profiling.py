"""Profiling: step timers and throughput counters.

The counterpart of ``light_transport_tpu.utils.profiling``: a per-step
wall timer, ``timed`` (which waits for the result's devices before it
stops the clock), the first-call / best-steady split, and a
``torch.profiler`` trace scope.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch


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
    ``logdir`` is None).  Yields the profiler (None when off)."""
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
