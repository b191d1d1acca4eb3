"""``isect_issued_tests_per_ray``, the ray-triangle tests K4 still
issues a live ray, on a stub frame log: the groups K4 tested by query
kind, times 32 lanes x 32 triangles, over the live rays of the profiled
frames; None where the program counts no groups (an older program, or a
route without K4) or logs too few frames."""

import pytest

import tiny
from light_transport_tpu_torch.utils import profiling
from ltbench.registry import Registry

REG = Registry(tiny.REPO)
FRAMES = 2
FRAME = {"pairs.nearest": 100, "pairs.any": 50, "live_rays.nearest": 1000,
         "live_rays.any": 600, "groups.nearest": 300, "groups.any": 90,
         "bounce_lanes": 2000}
RECORD = {"frames": FRAMES}


def read(name):
    return REG.module("metrics", name).read(RECORD)


def _stub(monkeypatch, log):
    monkeypatch.setattr(profiling, "frames", lambda: list(log))


def test_issued_tests_over_the_profiled_frames(monkeypatch):
    old = dict(FRAME, **{"groups.nearest": 10**6})
    second = dict(FRAME, **{"live_rays.nearest": 1200, "groups.any": 40})
    _stub(monkeypatch, [old, FRAME, second])
    assert read("isect_issued_tests_per_ray") == pytest.approx(
        (300 + 90 + 300 + 40) * 32 * 32 / (1000 + 600 + 1200 + 600))
    # beside the cull's admitted tests, on the same frames
    assert read("isect_tests_per_ray") == pytest.approx(
        (100 + 50) * 2 * 128 * 512 / (1000 + 600 + 1200 + 600))


def test_issued_tests_absent_reads_none(monkeypatch):
    # a route without the cull (K3, K5): frames logged, nothing counted
    _stub(monkeypatch, [dict(dict.fromkeys(FRAME, 0), bounce_lanes=64)]
          * FRAMES)
    assert read("isect_issued_tests_per_ray") is None
    # a program whose K4 counts no groups: the admitted tests still read
    older = {k: v for k, v in FRAME.items() if not k.startswith("groups.")}
    _stub(monkeypatch, [older] * FRAMES)
    assert read("isect_issued_tests_per_ray") is None
    assert read("isect_tests_per_ray") is not None
    # fewer frames logged than traced, and a program without the log
    _stub(monkeypatch, [FRAME])
    assert read("isect_issued_tests_per_ray") is None
    monkeypatch.delattr(profiling, "frames")
    assert read("isect_issued_tests_per_ray") is None
