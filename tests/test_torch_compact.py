"""The port's tail compaction (``RenderConfig.compact_tail``,
``path_tracer.trace_paths_compact`` and ``render_image_compact``) against
the port's full-width tracer and against the JAX package on the CPU.

- The Cornell box at 40x40x4, depth 8, ``rr_start=5``,
  ``emission_mode="always"`` (JAX's ``test_compact_tail_matches_full_width``
  configuration, 28 triangles on the brute force): the compacted lanes
  bitwise the full-width ones at ``segment=2, min_width=256`` (one shrink,
  6400 -> 3200) and at ``segment=1`` (two, down to a width of 200); the
  same lanes against JAX's ``trace_paths`` at the tests' ``CHEAP_COMPILE``
  level and against JAX's own ``trace_paths_compact``; the port's width
  a bounce against JAX's halving rule on JAX's per-bounce live counts.
- The ``glass`` preset (414 triangles) at a cut size through the plain
  version of the dense kernel K3: compact bitwise full width.
- Every entry point that JAX lets ignore the flag gives bitwise the same
  result with ``compact_tail=True`` as without.

Tolerances against JAX: >= 99 % of lanes within rtol 1e-4, atol 1e-6
(``tests/test_torch_render.py``'s ``lanes_close``: XLA's fused
multiply-adds and its sqrt round an ulp away from torch, and an ulp can
flip a Russian-roulette or Fresnel branch); against JAX's compacted
tracer >= 99 % of lanes within JAX's own atol of 1e-5 (the share that
agrees is asserted, not every lane).
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.scene.cornell import (
    cornell_box_scene as j_cornell_box_scene,
)
from light_transport_tpu_torch import api
from light_transport_tpu_torch.integrators import adaptive as ad
from light_transport_tpu_torch.integrators import control_variates as cv
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.utils import interop

from test_torch_render import (
    CHEAP_COMPILE,
    jax_scene_arrays,
    jax_uniforms,
    lanes_close,
    port_cfg,
)

torch.set_num_threads(1)

MIN_WIDTH = 256
AGREE = 0.99  # share of lanes within the stated tolerance of JAX


def halving_widths(counts, n0, depth, segment, min_width):
    """The width of every bounce under JAX's rule, from the live count
    after each bounce (``counts[b]``, read where a segment ends)."""
    widths, width, b = [], n0, 0
    while b < depth:
        seg = min(segment, depth - b)
        widths += [width] * seg
        b += seg
        if b >= depth or width <= min_width:
            continue
        new_w = width
        while new_w > min_width and counts[b - 1] <= new_w // 2:
            new_w //= 2
        width = new_w
    return widths


def bounce_widths(fn):
    """``fn()`` with ``path_tracer._bounce`` wrapped: returns its result and
    the lane width of every bounce it traced."""
    widths = []
    bounce = pt._bounce

    def spy(scene, cfg, state, *args, **kw):
        widths.append(state.alive.shape[0])
        return bounce(scene, cfg, state, *args, **kw)

    with mock.patch.object(pt, "_bounce", side_effect=spy):
        out = fn()
    return out, widths


@pytest.fixture(scope="module")
def fix1():
    """The Cornell box at 40x40x4, depth 8, on both sides from the same
    uniforms: JAX's full-width trace at ``CHEAP_COMPILE``, its compacted
    trace (each segment's width recorded) and the port's full width."""
    js, jcfg = j_cornell_box_scene(width=40, height=40, spp=4, max_depth=8)
    jcfg = dataclasses.replace(jcfg, rr_start=5, emission_mode="always")
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    cfg = port_cfg(jcfg)
    u_aa, uni = jax_uniforms(jax.random.key(3), jcfg)

    def jax_full(js, u_aa, uni):
        o, d = jpt.camera_rays(js, jcfg, u_aa)
        rad, rec = jpt.trace_paths(js, jcfg, o, d, uni)
        return o, d, rad, rec.alive.sum(axis=0)

    jo, jd, jrad, jalive = jax.jit(
        jax_full, compiler_options=CHEAP_COMPILE)(js, u_aa, uni)
    # JAX's compacted tracer, its segments compiled at the same level
    segment_fn = jax.jit(jpt._trace_segment.__wrapped__,
                         static_argnums=(1, 4, 5),
                         compiler_options=CHEAP_COMPILE)
    jwidths = []

    def jax_segment(scene_, cfg_, state, u_seg, *rest):
        jwidths.extend([u_seg.shape[0]] * u_seg.shape[1])
        return segment_fn(scene_, cfg_, state, u_seg, *rest)

    with mock.patch.object(jpt, "_trace_segment", side_effect=jax_segment):
        jcomp = jpt.trace_paths_compact(js, jcfg, jo, jd, uni,
                                        segment=2, min_width=MIN_WIDTH)
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    o, d = pt.camera_rays(scene, cfg, ua)
    full, record = pt.trace_paths(scene, cfg, o, d, un)
    return dict(scene=scene, cfg=cfg, o=o, d=d, u=un, full=full,
                record=record, jrad=np.asarray(jrad),
                jalive=np.asarray(jalive), jcomp=np.asarray(jcomp),
                jwidths=jwidths)


def test_compact_equals_full_width_bitwise(fix1):
    """(a) JAX's configuration (one shrink) and one bounce a segment (two
    shrinks, 6400 -> 3200 -> 200): every lane bitwise, and the widths as
    the rule gives them on the port's own live counts."""
    scene, cfg, full = fix1["scene"], fix1["cfg"], fix1["full"]
    n0 = full.shape[0]
    for segment in (2, 1):
        stats = {}
        comp, widths = bounce_widths(lambda: pt.trace_paths_compact(
            scene, cfg, fix1["o"], fix1["d"], fix1["u"], segment=segment,
            min_width=MIN_WIDTH, stats=stats))
        assert torch.equal(comp, full), segment
        assert len(set(widths)) == (2 if segment == 2 else 3), widths
        assert stats["widths"] == widths[::segment]
        # the live count after each bounce, from a full-width trace
        counts, state = [], pt.PathState.initial(fix1["o"], fix1["d"])
        for b in range(cfg.max_depth):
            state, _ = pt._bounce(scene, cfg, state, fix1["u"][:, b], b)
            counts.append(int(state.alive.sum()))
        assert widths == halving_widths(counts, n0, cfg.max_depth, segment,
                                        MIN_WIDTH)
        assert stats["alive"] == [counts[b] for b in range(
            segment - 1, cfg.max_depth - 1, segment)][:len(stats["alive"])]
    # api.render with the flag: render_image_compact, render_image's image
    flagged = dataclasses.replace(cfg, compact_tail=True)
    img = api.render(scene, flagged, seed=3)
    assert torch.equal(img, pt.render_image_compact(scene, cfg, 3))
    assert torch.equal(img, pt.render_image(scene, cfg, 3))


def test_compact_against_jax(fix1):
    """(b) The port's compacted lanes against JAX's full-width trace
    (``lanes_close``) and against JAX's compacted trace (atol 1e-5)."""
    comp = pt.trace_paths_compact(fix1["scene"], fix1["cfg"], fix1["o"],
                                  fix1["d"], fix1["u"], segment=2,
                                  min_width=MIN_WIDTH).numpy()
    close = lanes_close(comp, fix1["jrad"])
    assert close.mean() >= AGREE, close.mean()
    within = (np.abs(comp - fix1["jcomp"]) <= 1e-5).all(axis=1)
    assert within.mean() >= AGREE, within.mean()
    # JAX's own two tracers agree to its atol on every lane
    np.testing.assert_allclose(fix1["jcomp"], fix1["jrad"], rtol=0,
                               atol=1e-5)
    assert abs(comp.mean() - fix1["jrad"].mean()) < 1e-3


def test_widths_follow_jax_rule(fix1):
    """(c) The port's width at every bounce is JAX's halving rule applied to
    JAX's per-bounce ``alive`` counts, and JAX's own compacted tracer's.
    Segments of 2 end after bounces 1, 3 and 5, at or before ``rr_start``:
    there a lane that is alive and hits lives on (every BSDF of the box
    samples a direction), so the record's count is the live count."""
    cfg = fix1["cfg"]
    _, widths = bounce_widths(lambda: pt.trace_paths_compact(
        fix1["scene"], cfg, fix1["o"], fix1["d"], fix1["u"], segment=2,
        min_width=MIN_WIDTH))
    want = halving_widths([int(c) for c in fix1["jalive"]],
                          fix1["full"].shape[0], cfg.max_depth, 2,
                          MIN_WIDTH)
    assert widths == want == fix1["jwidths"], (widths, want,
                                               fix1["jwidths"])
    assert min(widths) < widths[0]


def test_glass_compact_through_plain_k3():
    """(d) The glass preset cut to 32x32x4 at depth 8 through the plain
    version of K3 (coherence sort, cull, pieces), one bounce a segment
    and Russian roulette from bounce 2: compact bitwise full width over
    two shrinks (4096 -> 2048 -> 1024; live counts 1908 and 947 where
    they are read)."""
    scene, cfg = presets.glass_scene(32, 32, 4, 8, device="cpu")
    cfg = dataclasses.replace(cfg, rr_start=1)
    o, d, u = pt._camera_lanes(scene, cfg, 0)
    full, _ = pt.trace_paths(scene, cfg, o, d, u)
    comp, widths = bounce_widths(lambda: pt.trace_paths_compact(
        scene, cfg, o, d, u, segment=1, min_width=128))
    assert torch.equal(comp, full)
    assert len(set(widths)) == 3, widths
    assert float(full.sum()) > 0


def _lts(**change):
    scene, cfg = presets.lts_scene(width=6, height=6, spp=4, max_depth=3,
                                   device="cpu")
    return scene, dataclasses.replace(cfg, **change)


def _plain_tracer(cfg):
    scene, _ = _lts()
    o, d, u = pt._camera_lanes(scene, cfg, 1)
    rad, rec = pt.trace_paths(scene, cfg, o, d, u)
    return (rad, *rec, pt.render_image(scene, cfg, 1),
            *pt.render_with_detectors(scene, cfg, 1))


def _split(cfg):
    scene, _ = _lts()
    cfg = dataclasses.replace(cfg, fresnel_mode="split")
    o, d, u = pt._camera_lanes(scene, cfg, 1)
    return (pt.trace_paths_split(scene, cfg, o, d, u),
            pt.render_image_split(scene, cfg, 1))


def _progressive(cfg):
    scene, _ = _lts()
    return tuple(pt.render_progressive(
        scene, dataclasses.replace(cfg, fresnel_mode=mode), 1, n_passes=2)
        for mode in ("stochastic", "split"))


def _adaptive_and_sharded(cfg):
    scene, _ = _lts()
    return (ad.render_adaptive(scene, cfg, 1, rounds=2),
            pm.render_sharded(scene, cfg, 1,
                              mesh=pm.make_mesh(2, device_type="cpu")))


def _cv(cfg):
    scene, _ = _lts()
    out = cv.render_cv(scene, cfg, 1)
    return (out.image_plain, out.image_cv)


@pytest.mark.parametrize("entry", [
    _plain_tracer, _split, _progressive, _adaptive_and_sharded, _cv],
    ids=["trace_paths,render_image,render_with_detectors",
         "trace_paths_split,render_image_split", "render_progressive",
         "render_adaptive,render_sharded", "render_cv"])
def test_entry_points_ignore_the_flag(entry):
    """(e) Each entry point renders the same, bitwise, with
    ``compact_tail=True`` as with ``False``: JAX's ignore the flag
    (only ``api.render``'s path tracer reads it)."""
    _, cfg = _lts()
    plain = entry(cfg)
    flagged = entry(dataclasses.replace(cfg, compact_tail=True))
    assert len(plain) == len(flagged)
    for a, b in zip(plain, flagged):
        assert torch.equal(a, b)
