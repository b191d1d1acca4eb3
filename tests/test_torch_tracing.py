"""The render's own spans and counters (``utils.profiling``), on the CPU.

The scene is the soft-shadow layout with a 9,024-triangle sphere (9,028
triangles, 18 clusters), so every query goes through the cull and K4's
plain version; frames are 8x8x1 at depth 2.  Checked:

- with no profiler recording, no ``record_function`` is entered, the cull
  gets no accumulator and the frame log gains nothing;
- under ``torch.profiler`` the exported trace nests ``lt.frame`` >
  ``lt.bounce`` > ``lt.nee`` > ``lt.query.any`` > ``lt.sort`` >
  ``lt.isect``, and ``trace_paths_compact`` opens ``lt.compact`` when it
  reads a live count;
- ``api.render`` gives bitwise the same image with and without the
  profiler, full width and compacted;
- the plain cull's counts are the sum of ``cnt`` and the rays with
  ``t_max > t_min``, dead and padded lanes included;
- one frame record a traced ``api.render``, at most ``FRAME_LOG_LEN`` kept,
  its counters equal to sums over the cull's calls.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from light_transport_tpu_torch import api
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.scene.cornell import sphere_triangles
from light_transport_tpu_torch.scene.geometry import (
    TriangleMesh,
    concat_meshes,
    quad_triangles,
)
from light_transport_tpu_torch.scene.material import (
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.scene import Scene
from light_transport_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = RenderConfig(width=8, height=8, spp=1, max_depth=2)
CHAIN = ("lt.frame", "lt.bounce", "lt.nee", "lt.query.any", "lt.sort",
         "lt.isect")


@pytest.fixture(scope="module")
def scene():
    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=48,
                           n_phi=96)
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    light = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                           (-1.5, 6, 1.5))
    mesh = concat_meshes([
        TriangleMesh.build(sph, np.zeros(len(sph), np.int32), device="cpu"),
        TriangleMesh.build(floor, np.asarray([1, 1], np.int32),
                           device="cpu"),
        TriangleMesh.build(light, np.asarray([2, 2], np.int32),
                           np.asarray([True, True]), device="cpu"),
    ])
    mats = MaterialTable.build([
        Material(color=presets.TURQUOISE), Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=8.0)], device="cpu")
    s = Scene.build(mesh, mats, camera=[0.0, 1.0, 7.0])
    assert ik.cluster_bounds(s.mesh)[0].shape[0] >= ik.GATHER_MIN_CLUSTERS
    return s


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU); returns its result and the
    profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_no_profiler_no_span(scene, monkeypatch):
    """Tracing off: no range, no accumulator for the cull, no frame
    logged."""
    entered, accs = [], []
    real_rf, real_cull = torch.profiler.record_function, ik.tile_cull

    def counting_rf(*a, **kw):
        entered.append(a)
        return real_rf(*a, **kw)

    def cull(*a, counts=None):
        accs.append(counts)
        return real_cull(*a, counts=counts)

    monkeypatch.setattr(torch.profiler, "record_function", counting_rf)
    monkeypatch.setattr(ik, "tile_cull", cull)
    before = len(profiling.frames())
    assert not profiling.tracing()
    api.render(scene, CFG, seed=3)
    api.render(scene, dataclasses.replace(CFG, compact_tail=True), seed=3)
    assert entered == []
    assert accs and all(a is None for a in accs)
    assert len(profiling.frames()) == before


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("lt.")]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_trace_nests_the_spans(scene, tmp_path):
    """The exported trace holds the chain lt.frame > lt.bounce > lt.nee >
    lt.query.any > lt.sort > lt.isect, and lt.compact in a compacting
    trace."""
    _, prof = profiled(lambda: api.render(scene, CFG, seed=5))
    ann = _annotations(prof, tmp_path)
    by_name = {n: [e for e in ann if e["name"] == n] for n in CHAIN}
    assert all(by_name[n] for n in CHAIN), {n: len(v)
                                             for n, v in by_name.items()}
    assert len(by_name["lt.frame"]) == 1
    assert len(by_name["lt.bounce"]) == CFG.max_depth
    # every innermost span has the whole chain around it
    for leaf in by_name["lt.isect"]:
        chain = [leaf]
        for name in reversed(CHAIN[:-1]):
            around = [e for e in by_name[name] if _inside(chain[-1], e)]
            if not around:
                break
            chain.append(around[0])
        if len(chain) == len(CHAIN):
            break
    else:
        pytest.fail("no lt.isect span lies inside the whole chain")
    assert {e["name"] for e in ann} >= {"lt.camera", "lt.record",
                                        "lt.query.nearest"}

    gen = torch.Generator().manual_seed(1)
    n = 64
    o = torch.tensor([[0.0, 1.0, 7.0]]).expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, -1.0]) + 0.2 * torch.randn(
            (n, 3), generator=gen), dim=-1)
    u = torch.rand((n, 4, pt.rng.NUM_U), generator=gen)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=4, rr_start=0)
    _, prof = profiled(lambda: pt.trace_paths_compact(
        scene, cfg, o, d, u, segment=1, min_width=8))
    assert any(e["name"] == "lt.compact"
               for e in _annotations(prof, tmp_path))


@pytest.mark.parametrize("compact", [False, True])
def test_images_bitwise_with_profiler(scene, compact):
    cfg = dataclasses.replace(CFG, compact_tail=compact)
    plain = api.render(scene, cfg, seed=7)
    traced, _ = profiled(lambda: api.render(scene, cfg, seed=7))
    assert torch.equal(plain, traced)


def test_cull_counts_plain(scene):
    """The plain cull's counts: Σ cnt and the rays with t_max > t_min,
    added to what the accumulator held; dead lanes (t_max = -inf) and the
    zero padding count as not live."""
    gen = torch.Generator().manual_seed(2)
    n, n_pad = 200, 256
    o = torch.rand((n, 3), generator=gen) * 4 - 2
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=-1)
    t_hi = torch.full((n,), float("inf"))
    t_hi[::5] = float("-inf")
    tmm = torch.stack([torch.full((n,), 1e-5), t_hi], -1)
    feats = torch.cat([ik.ray_features(o, d), torch.zeros((n_pad - n, 16))])
    tmm = torch.cat([tmm, torch.zeros((n_pad - n, 2))])
    c_lo, c_hi = ik.cluster_bounds(scene.mesh)
    acc = torch.tensor([5, 7], dtype=torch.int64)
    ids, cnt = ik.tile_cull(feats, tmm, c_lo, c_hi, counts=acc)
    want = ik.tile_cull_reference(feats, tmm, c_lo, c_hi)
    assert torch.equal(ids, want[0]) and torch.equal(cnt, want[1])
    assert int(cnt.sum()) > 0
    assert acc.tolist() == [5 + int(cnt.sum()), 7 + n - len(range(0, n, 5))]


def test_frame_log(scene, monkeypatch):
    """One record a traced api.render; its counters the sums over the
    cull's calls by query kind, and the lane widths of its bounces; the
    log keeps the last FRAME_LOG_LEN."""
    kind, sums = [None], {}
    real_pallas, real_cull = ik.intersect_rays_pallas, ik.tile_cull

    def pallas(*a, any_hit=False, **kw):
        kind[0] = "any" if any_hit else "nearest"
        return real_pallas(*a, any_hit=any_hit, **kw)

    def cull(feats, tminmax, c_lo, c_hi, counts=None):
        out = real_cull(feats, tminmax, c_lo, c_hi, counts=counts)
        p, r = sums.get(kind[0], (0, 0))
        sums[kind[0]] = (p + int(out[1].sum()),
                         r + int((tminmax[:, 1] > tminmax[:, 0]).sum()))
        return out

    monkeypatch.setattr(ik, "intersect_rays_pallas", pallas)
    monkeypatch.setattr(ik, "tile_cull", cull)
    before = len(profiling.frames())
    for compact in (False, True):
        sums.clear()
        cfg = dataclasses.replace(CFG, compact_tail=compact)
        profiled(lambda: api.render(scene, cfg, seed=11))
        log = profiling.frames()
        assert len(log) == min(before + 1 + compact, profiling.FRAME_LOG_LEN)
        rec = log[-1]
        assert set(sums) == {"nearest", "any"}
        for k, (pairs, live) in sums.items():
            assert (rec[f"pairs.{k}"], rec[f"live_rays.{k}"]) == (pairs, live)
        assert rec["pairs.nearest"] > 0 and rec["live_rays.any"] > 0
        assert rec["bounce_lanes"] == CFG.max_depth * 64

    def frames_only():
        for _ in range(profiling.FRAME_LOG_LEN + 6):
            with profiling.frame():
                pass

    profiled(frames_only)
    log = profiling.frames()
    assert len(log) == profiling.FRAME_LOG_LEN
    assert log[-1] == {"bounce_lanes": 0, "pairs.nearest": 0, "pairs.any": 0,
                       "live_rays.nearest": 0, "live_rays.any": 0}
