"""Transmittance shadows (``RenderConfig(shadow_mode="transmittance")``) in
the port on the CPU: ``ops.dispatch.scene_transmittance`` against JAX's
on the same rays, JAX's closed-form checks
(``tests/test_media.py:165-320``), ``trace_paths`` against JAX's from the
same uniforms on the slab scene and on the glass preset (the cluster
route: the plain version of K3), the emission rule that keeps the light
behind glass from being scored twice, and the point-light term.

JAX runs in module fixtures, compiled with the tests' ``CHEAP_COMPILE``.
Tolerances: transmittance within rtol 1e-5 of JAX's (XLA fuses the
multiply-adds of the march's hit points); traced radiance on >= 99 % of
lanes within rtol 1e-4, atol 1e-6, as ``tests/test_torch_render.py``
holds the tracer; closed forms at ``tests/test_media.py``'s tolerances.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.core import rng as jrng
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import dispatch as jdispatch
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.utils import interop
from test_media import _shadow_scene
from test_torch_render import (
    CHEAP_COMPILE,
    jax_scene_arrays,
    jax_uniforms,
    lanes_close,
    port_cfg,
)

torch.set_num_threads(1)

SA, SS = (1.0, 2.0, 4.0), 0.5


def port(js):
    d = jax_scene_arrays(js)
    d["point_lights"] = (None if js.point_lights is None else {
        k: np.asarray(getattr(js.point_lights, k))
        for k in interop.POINT_LIGHT_FIELDS})
    return interop.scene_from_numpy(d, device="cpu")


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def slab_rays(n=512, seed=0):
    """Segments from floor points toward points of the light quad (every
    one crosses the slab), and a share ending inside it or short of it."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-1, 1, n), np.full(n, 0.01), r.uniform(-1, 1, n)],
                 1)
    p = np.stack([r.uniform(-0.1, 0.1, n), np.full(n, 3.0),
                  r.uniform(-0.1, 0.1, n)], 1)
    v = p - o
    dist = np.linalg.norm(v, axis=1)
    d = v / dist[:, None]
    md = dist * np.where(r.random(n) < 0.7, 1.0 - 1e-3,
                         r.uniform(0.1, 0.5, n))
    return (o.astype(np.float32), d.astype(np.float32),
            md.astype(np.float32), r.random(n) < 0.9)


@pytest.fixture(scope="module")
def slab():
    js = _shadow_scene(sigma_a=SA, sigma_s=SS)
    o, d, md, active = slab_rays()
    jtr = np.asarray(jax.jit(
        lambda o, d, m, a: jdispatch.scene_transmittance(js, o, d, m,
                                                         active=a),
        compiler_options=CHEAP_COMPILE)(o, d, md, active))
    return dict(js=js, scene=port(js), o=o, d=d, md=md, active=active,
                jtr=jtr)


def test_scene_transmittance_matches_jax(slab):
    scene = slab["scene"]
    tr = dispatch.scene_transmittance(scene, t_(slab["o"]), t_(slab["d"]),
                                      t_(slab["md"]),
                                      active=torch.from_numpy(slab["active"]))
    np.testing.assert_allclose(tr.numpy(), slab["jtr"], rtol=1e-5,
                               atol=1e-7)
    # the crossings attenuate, the short and inactive lanes keep 1
    assert (tr.numpy() < 0.5).any() and (tr.numpy() == 1.0).any()
    assert (tr.numpy()[~slab["active"]] == 1.0).all()


def test_scene_transmittance_closed_forms(slab):
    """``test_scene_transmittance_op``: exp(-sigma_t * L) through the
    slab, 1 for a segment that stops short, 0 through the light and into
    the floor."""
    scene = slab["scene"]
    o = torch.tensor([[0.0, 0.01, 0.0]] * 3)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 3)
    tr = dispatch.scene_transmittance(scene, o, d,
                                      torch.tensor([2.8, 0.5, 3.5])).numpy()
    np.testing.assert_allclose(tr[0], np.exp(-(np.asarray(SA) + SS) * 0.5),
                               rtol=1e-3)
    np.testing.assert_allclose(tr[1], 1.0)
    np.testing.assert_allclose(tr[2], 0.0, atol=1e-7)
    tr2 = dispatch.scene_transmittance(scene, torch.tensor([[0.3, 0.9, 0.0]]),
                                       torch.tensor([[0.0, -1.0, 0.0]]),
                                       torch.tensor([4.0]))
    np.testing.assert_allclose(tr2.numpy(), 0.0, atol=1e-7)


def test_transmittance_segment_ending_inside_medium(slab):
    """A segment whose end lies inside the slab attenuates over its last
    span by the pending extinction; the mirrored case (start inside)
    exit-attributes the same way."""
    scene = slab["scene"]
    o = torch.tensor([[0.0, 0.01, 0.0]] * 2)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    tr = dispatch.scene_transmittance(
        scene, o, d, torch.tensor([1.20, 1.25]) - 0.01).numpy()
    sig_t = np.asarray(SA) + SS
    np.testing.assert_allclose(tr[0], np.exp(-sig_t * 0.20), rtol=2e-3)
    np.testing.assert_allclose(tr[1], np.exp(-sig_t * 0.25), rtol=2e-3)
    tr2 = dispatch.scene_transmittance(
        scene, torch.tensor([[0.0, 1.2, 0.0]]), torch.tensor([[0.0, 1.0, 0.0]]),
        torch.tensor([1.0])).numpy()
    np.testing.assert_allclose(tr2[0], np.exp(-sig_t * 0.3), rtol=2e-3)


def test_transmittance_max_hits_closeout_blocks():
    """Four interfaces of two stacked slabs: past ``max_hits = 3``
    crossings the close-out any-hit query blocks; two crossings pass."""
    from light_transport_tpu_torch.scene.geometry import (
        TriangleMesh,
        quad_triangles,
    )
    from light_transport_tpu_torch.scene.material import (
        Material,
        MaterialTable,
        presets,
    )
    from light_transport_tpu_torch.scene.scene import Scene

    half = 50.0
    quads = []
    for y0, y1 in ((1.0, 1.5), (1.8, 2.3)):
        quads.append(quad_triangles((-half, y0, -half), (half, y0, -half),
                                    (half, y0, half), (-half, y0, half)))
        quads.append(quad_triangles((-half, y1, -half), (-half, y1, half),
                                    (half, y1, half), (half, y1, -half)))
    mesh = TriangleMesh.build(np.concatenate(quads), np.zeros(8, np.int32),
                              np.zeros(8, bool), device="cpu")
    glass = Material(color=presets.WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False)
    scene = Scene.build(mesh, MaterialTable.build([glass], device="cpu"),
                        camera=[0.0, 5.0, 0.0])
    o = torch.tensor([[0.0, 0.5, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        dispatch.scene_transmittance(scene, o, d, 3.0).numpy(), 0.0,
        atol=1e-7)
    np.testing.assert_allclose(
        dispatch.scene_transmittance(scene, o, d, 1.65).numpy(), 1.0,
        atol=1e-6)


def floor_lanes(n):
    o = torch.tensor([[0.0, 0.8, 0.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(n, 1)
    return o, d


def direct_at_floor(scene, shadow_mode, n=256, seed=2):
    """``tests/test_media.py``'s bounce-0 NEE at the floor (depth 1)."""
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=1,
                       shadow_mode=shadow_mode)
    u = rng.path_uniforms(torch.Generator().manual_seed(seed), n, 1)
    rad, _ = pt.trace_paths(scene, cfg, *floor_lanes(n), u)
    return rad.numpy().mean(axis=0)


def test_shadow_transmittance_analytic():
    """Through an absorbing slab the direct light is the clear slab's times
    exp(-sigma_t * 0.5), for the area light and for a point light right
    above; opaque shadows block the glass."""
    sa = (2.0, 0.5, 0.0)
    clear = port(_shadow_scene())
    tinted = port(_shadow_scene(sigma_a=sa))
    want = np.exp(-np.asarray(sa) * 0.5)
    c = direct_at_floor(clear, "transmittance")
    np.testing.assert_allclose(direct_at_floor(tinted, "transmittance") / c,
                               want, rtol=5e-3)
    scat = port(_shadow_scene(sigma_s=1.0))
    np.testing.assert_allclose(direct_at_floor(scat, "transmittance") / c,
                               np.exp(-0.5), rtol=5e-3)
    np.testing.assert_allclose(direct_at_floor(tinted, "opaque"), 0.0,
                               atol=1e-7)
    # a point light on the axis: one vertical shadow ray, whose interior
    # span is the slab's 0.5 less the march's 1e-4 step past the entry
    dark = {"emission": 0.0}
    lit = [port(_shadow_scene(sigma_a=s, **dark)).with_point_lights(
        [[0.0, 2.5, 0.0]], [[5.0, 5.0, 5.0]]) for s in ((0, 0, 0), sa)]
    pc, pa = (direct_at_floor(s, "transmittance") for s in lit)
    assert pc.min() > 0
    np.testing.assert_allclose(pa / pc, np.exp(-np.asarray(sa) * 0.4999),
                               rtol=1e-5)
    np.testing.assert_allclose(direct_at_floor(lit[1], "opaque"), 0.0,
                               atol=1e-7)


@pytest.mark.parametrize("nee_mode", ["one", "all"])
def test_trace_paths_matches_jax_on_the_slab(nee_mode):
    """Whole paths with transmittance shadows on the tinted slab scene from
    JAX's uniforms: lanes start above the slab and below it."""
    js = _shadow_scene(sigma_a=(2.0, 0.5, 0.1), sigma_s=0.3)
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=3,
                       shadow_mode="transmittance", emission_mode="nee",
                       nee_mode=nee_mode)
    n = 1024
    r = np.random.default_rng(1)
    o = np.stack([r.uniform(-1, 1, n), np.where(r.random(n) < 0.5, 0.8, 2.0),
                  r.uniform(-1, 1, n)], 1).astype(np.float32)
    d = np.stack([r.normal(0, 0.3, n), -np.ones(n), r.normal(0, 0.3, n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    uni = np.asarray(jrng.path_uniforms(jax.random.key(5), n, 3))
    jrad = np.asarray(jax.jit(lambda o, d, u: jpt.trace_paths(
        js, cfg, o, d, u)[0], compiler_options=CHEAP_COMPILE)(o, d, uni))
    rad = pt.trace_paths(port(js), cfg, t_(o), t_(d), t_(uni))[0].numpy()
    close = lanes_close(rad, jrad)
    assert close.mean() >= 0.99, close.mean()
    assert rad.mean() > 0.01


def test_transmittance_nee_no_double_count():
    """An ior-1, sigma-0 slab is a no-op: with transmittance shadows and
    ``emission_mode="nee"`` the floor under it is as bright as without it
    (``tests/test_media.py``'s 4 % at 8,192 lanes; scoring the light
    behind glass twice brightened it by more than 5 %)."""
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=4,
                       shadow_mode="transmittance", emission_mode="nee")
    n = 8192

    def run(scene):
        u = rng.path_uniforms(torch.Generator().manual_seed(3), n, 4)
        return float(pt.trace_paths(scene, cfg, *floor_lanes(n), u)[0].mean())

    with_slab = run(port(_shadow_scene()))
    no_slab = run(port(_shadow_scene(slab=False)))
    assert no_slab > 0
    assert abs(with_slab - no_slab) / no_slab < 0.04, (with_slab, no_slab)


def test_emission_rule_follows_shadow_mode():
    """After a transmissive hit ``emit_ok`` is granted under opaque
    shadows and passed on under transmittance (JAX's ``trans_emit``)."""
    scene = port(_shadow_scene())
    o = torch.tensor([[0.0, 2.0, 0.0]] * 2)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 2)
    state = pt.PathState.initial(o, d)
    state = state._replace(emit_ok=torch.tensor([True, False]))
    u = torch.full((2, rng.NUM_U), 0.5)
    for mode, want in (("opaque", [True, True]),
                       ("transmittance", [True, False])):
        cfg = RenderConfig(width=1, height=1, spp=1, max_depth=2,
                           shadow_mode=mode, emission_mode="nee")
        new, _ = pt._bounce(scene, cfg, state, u, 1)
        assert new.emit_ok.tolist() == want, mode


def test_glass_preset_matches_jax():
    """The glass preset (414 triangles: the port's cluster route, plain K3
    on the CPU; JAX's BVH walk) with transmittance shadows, from JAX's
    uniforms.  The glass body and liquid share coincident faces of
    opposite facing, whose float ties the two routes may break apart; the
    lanes that differ are named by their tie hits."""
    js, jcfg = jpresets.glass_scene(16, 16, 2, 3)
    jcfg = dataclasses.replace(jcfg, shadow_mode="transmittance")
    scene, cfg = port(js), port_cfg(jcfg)
    u_aa, uni = jax_uniforms(jax.random.key(8), jcfg)
    jrad = np.asarray(jax.jit(lambda u, v: jpt.trace_paths(
        js, jcfg, *jpt.camera_rays(js, jcfg, u), v)[0],
        compiler_options=CHEAP_COMPILE)(u_aa, uni))
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    o, d = pt.camera_rays(scene, cfg, ua)
    rad = pt.trace_paths(scene, cfg, o, d, un)[0].numpy()
    close = lanes_close(rad, jrad)
    assert close.mean() >= 0.99, (close.mean(), np.nonzero(~close)[0])
    img = pt._to_image(torch.from_numpy(rad), cfg)[0].numpy()
    jimg = np.asarray(jpt._to_image(jrad, jcfg)[0])
    assert abs(img.mean() - jimg.mean()) < 1e-3 and img.mean() > 0.01
    # transmittance lets light through the glass that opaque shadows block
    opaque = pt.trace_paths(scene, dataclasses.replace(
        cfg, shadow_mode="opaque"), o, d, un)[0].numpy()
    assert rad.mean() > opaque.mean()
