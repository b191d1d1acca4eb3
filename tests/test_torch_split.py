"""The port's both-branch Fresnel tracer (``fresnel_mode="split"``) and
its pieces on the CPU: ``ops.lanestack`` against JAX's, the port's
``trace_paths_split`` against JAX's from the same rays and uniforms, the
split estimator's properties (``tests/test_path_tracer.py:234-289``),
``trace_paths`` unchanged by the per-lane bounce, the progressive render
and ``api.render``'s routing.

JAX's split step is compiled with the tests' ``CHEAP_COMPILE`` options.
Tolerance against JAX: >= 99 % of lanes within rtol 1e-4, atol 1e-6, as
``tests/test_torch_render.py`` holds ``trace_paths`` (XLA's CPU sqrt and
its FMAs round an ulp away from torch, which can flip a rare branch).
"""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core.config import RenderConfig as JRenderConfig
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import lanestack as jstack
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu.scene import material as jmat
from light_transport_tpu.scene import scene as jscene
from light_transport_tpu_torch import api
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import lanestack
from light_transport_tpu_torch.ops.sampling import schlick_r0
from light_transport_tpu_torch.scene import geometry, material
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.scene import scene as tscene
from light_transport_tpu_torch.utils import interop
from test_torch_render import CHEAP_COMPILE, jax_scene_arrays, lanes_close

torch.set_num_threads(1)

SLAB_CFG = dict(max_depth=6, rr_start=10, emission_mode="nee")


def slab_scene(geo, mat, scn, **dev):
    """A non-diffuse emitter floor at y=0 under a horizontal glass slab
    (``tests/test_path_tracer.py:205-231``), from either package."""
    floor = geo.quad_triangles((-5, 0, -5), (-5, 0, 5), (5, 0, 5), (5, 0, -5))
    top = geo.quad_triangles((-5, 2, -5), (-5, 2, 5), (5, 2, 5), (5, 2, -5))
    bot = geo.quad_triangles((-5, 1.8, -5), (5, 1.8, -5), (5, 1.8, 5),
                             (-5, 1.8, 5))
    mats = mat.MaterialTable.build([
        mat.Material(color=mat.presets.WHITE, emission=5.0,
                     is_diffuse=False),
        mat.Material(color=mat.presets.WHITE, transmission=1.0, ior=1.5,
                     is_diffuse=False)], **dev)
    mesh = geo.TriangleMesh.build(
        np.concatenate([floor, top, bot]),
        np.asarray([0, 0, 1, 1, 1, 1], np.int32),
        np.asarray([True, True, False, False, False, False]), **dev)
    return scn.Scene.build(mesh, mats, camera=[0.0, 3.0, 0.0])


def port_slab():
    return slab_scene(geometry, material, tscene, device="cpu")


def slab_rays(n, spread=0.0, seed=0):
    """Rays from above the slab, straight down or tilted up to ``spread``."""
    r = np.random.default_rng(seed)
    d = np.stack([r.uniform(-spread, spread, n), -np.ones(n),
                  r.uniform(-spread, spread, n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([[0.1, 3.0, 0.1]], (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def numpy_uniforms(n, depth, seed):
    u = np.random.default_rng(seed).random((n, depth, rng.NUM_U))
    return np.maximum(u, np.finfo(np.float32).tiny).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module", params=["slab", "glass"])
def split_pair(request):
    """``trace_paths_split`` on both sides from the same rays and
    uniforms: the slab (64 tilted rays, depth 6) and the glass preset
    (16x16x2, depth 3, JAX's camera rays)."""
    if request.param == "slab":
        js = slab_scene(jgeo, jmat, jscene)
        jcfg = JRenderConfig(**SLAB_CFG)
        scene = port_slab()
        o, d = slab_rays(64, spread=0.4, seed=1)
    else:
        js, jcfg = jpresets.glass_scene(16, 16, 2, 3)
        scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
        n = jcfg.width * jcfg.height * jcfg.spp
        u_aa = np.random.default_rng(2).random((n, 2)).astype(np.float32)
        o, d = (np.asarray(a) for a in jax.jit(
            lambda u: jpt.camera_rays(js, jcfg, u),
            compiler_options=CHEAP_COMPILE)(u_aa))
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    uni = numpy_uniforms(o.shape[0], cfg.max_depth, seed=3)
    step = jax.jit(jpt._split_step.__wrapped__, static_argnums=(1, 7, 8),
                   compiler_options=CHEAP_COMPILE)
    with mock.patch.object(jpt, "_split_step", step):
        jrad = np.asarray(jpt.trace_paths_split(js, jcfg, jnp.asarray(o),
                                                jnp.asarray(d),
                                                jnp.asarray(uni)))
    stats = {}
    rad = pt.trace_paths_split(scene, cfg, t(o), t(d), t(uni), stats=stats)
    return dict(rad=rad.numpy(), jrad=jrad, stats=stats, cfg=cfg)


def test_lanestack_matches_jax():
    """Random pushes and peeks of a payload with float, int and bool
    fields, empty stacks and a full one included."""
    r = np.random.default_rng(5)
    n, size = 37, 3
    top = np.zeros(n, np.int32)
    jstate = (jstack.zeros((jnp.zeros((n, 3)), jnp.zeros((n,), jnp.int32),
                            jnp.zeros((n,), bool)), size), jnp.asarray(top))
    ours = (lanestack.zeros((torch.zeros((n, 3)),
                             torch.zeros((n,), dtype=torch.int32),
                             torch.zeros((n,), dtype=torch.bool)), size),
            t(top))
    for k in range(8):
        payload = (r.random((n, 3)).astype(np.float32),
                   r.integers(-9, 9, n).astype(np.int32), r.random(n) > 0.5)
        top_now = np.asarray(jstate[1])
        mask = (r.random(n) > 0.3) & (top_now < size)
        if k % 3 == 2:  # a pop round: lanes with something on them pop
            jpeek = jstack.peek(jstate[0], jstate[1], size)
            peek = lanestack.peek(ours[0], ours[1], size)
            for a, b in zip(peek, jpeek):
                assert a.dtype == torch_dtype(b)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            pop = top_now > 0
            jstate = (jstate[0], jstate[1] - pop.astype(np.int32))
            ours = (ours[0], ours[1] - t(pop.astype(np.int32)))
            continue
        jstate = jstack.push(jstate[0], jstate[1], jnp.asarray(mask),
                             tuple(jnp.asarray(p) for p in payload), size)
        ours = lanestack.push(ours[0], ours[1], t(mask),
                              tuple(t(p) for p in payload), size)
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(jstate[1]))
        for a, b in zip(ours[0], jstate[0]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[1].max()) == size and int(ours[1].min()) == 0


def torch_dtype(a):
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.int32): torch.int32,
            np.dtype(bool): torch.bool}[np.asarray(a).dtype]


def test_trace_paths_split_matches_jax(split_pair):
    rad, jrad = split_pair["rad"], split_pair["jrad"]
    close = lanes_close(rad, jrad)
    assert close.mean() >= 0.99, close.mean()
    assert rad.mean() > 0.01 and np.isfinite(rad).all()
    assert abs(rad.mean() - jrad.mean()) < 1e-3
    depth = split_pair["cfg"].max_depth
    S = min(depth, 6)
    assert 1 < split_pair["stats"]["iterations"] <= 2 * sum(
        math.comb(depth, k) for k in range(S + 1)) + 1


def test_split_deterministic_and_exact_on_the_slab():
    """At normal incidence the split estimator does not depend on the
    uniforms and equals E (1-R)^2 (1+R^2), the series cut at depth 6."""
    scene, cfg = port_slab(), RenderConfig(**SLAB_CFG)
    o, d = (t(a) for a in slab_rays(8))
    r1 = pt.trace_paths_split(scene, cfg, o, d, t(numpy_uniforms(8, 6, 1)))
    r2 = pt.trace_paths_split(scene, cfg, o, d, t(numpy_uniforms(8, 6, 2)))
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), atol=1e-6)
    R = float(schlick_r0(torch.tensor(1.0), torch.tensor(1.5)))
    expected = 5.0 * (1.0 - R) ** 2 * (1.0 + R ** 2)
    np.testing.assert_allclose(r1.numpy().mean(axis=0), expected, rtol=2e-3)


def test_split_same_mean_less_spread():
    scene, cfg = port_slab(), RenderConfig(**SLAB_CFG)
    n = 2048
    o, d = (t(a) for a in slab_rays(n))
    u = t(numpy_uniforms(n, 6, 3))
    r_split = pt.trace_paths_split(scene, cfg, o, d, u)[:, 1].numpy()
    r_stoch = pt.trace_paths(scene, cfg, o, d, u)[0][:, 1].numpy()
    se = r_stoch.std() / np.sqrt(n)
    assert abs(r_split.mean() - r_stoch.mean()) < 4 * se + 1e-3
    assert r_split.std() < 0.1 * r_stoch.std()


def test_split_without_glass_is_the_stochastic_tracer():
    """No transmissive surface, no split: bitwise ``trace_paths``."""
    scene, cfg = cornell_box_scene(width=12, height=10, spp=2, max_depth=3,
                                   include_cone=False, device="cpu")
    assert not bool((scene.materials.bsdf[scene.mesh.mat_id]
                     == material.BSDF_TRANSMISSIVE).any())
    o, d, u = pt._camera_lanes(scene, cfg, 4)
    split = pt.trace_paths_split(scene, cfg, o, d, u)
    assert torch.equal(split, pt.trace_paths(scene, cfg, o, d, u)[0])
    assert float(split.sum()) > 0


def test_trace_paths_unchanged_by_per_lane_bounce():
    """``_bounce`` with the bounce as a per-lane tensor (the split
    tracer's) gives ``trace_paths``' int-bounce state bitwise, on the
    glass with first-hit emission and roulette from bounce 1 (both read
    the bounce)."""
    scene, cfg = presets.glass_scene(10, 8, 2, 4, device="cpu")
    cfg = dataclasses.replace(cfg, emission_mode="first_hit", rr_start=0)
    o, d, u = pt._camera_lanes(scene, cfg, 6)
    rad, rec = pt.trace_paths(scene, cfg, o, d, u)
    state = pt.PathState.initial(o, d)
    for b in range(cfg.max_depth):
        bv = torch.full((o.shape[0],), b, dtype=torch.int32)
        state, per = pt._bounce(scene, cfg, state, u[:, b], bv)
        assert torch.equal(per[1], rec.alive[:, b])
    assert torch.equal(state.radiance, rad)
    assert float(rad.sum()) > 0


def test_render_progressive_honours_fresnel_mode():
    scene, cfg = presets.glass_scene(8, 6, 2, 3, device="cpu")
    split_cfg = dataclasses.replace(cfg, fresnel_mode="split")
    for c, one in ((cfg, pt.render_image), (split_cfg, pt.render_image_split)):
        img = pt.render_progressive(scene, c, seed=5, n_passes=2)
        want = (one(scene, c, pt.pass_seed(5, 0))
                + one(scene, c, pt.pass_seed(5, 1))) / 2
        assert torch.equal(img, want)
        assert img.shape == (6, 8, 3) and 0 < float(img.mean()) < 1
    assert not torch.equal(pt.render_progressive(scene, cfg, 5, 2),
                           pt.render_progressive(scene, split_cfg, 5, 2))
    assert pt.pass_seed(5, 0) != pt.pass_seed(5, 1) != pt.pass_seed(6, 1)
    # the Sobol' passes keep the seed and continue one point set
    sobol = dataclasses.replace(cfg, sampler="sobol")
    img = pt.render_progressive(scene, sobol, seed=5, n_passes=2)
    want = (pt.render_image(scene, sobol, 5)
            + pt.render_image(scene, sobol, 5, sample_offset=cfg.spp)) / 2
    assert torch.equal(img, want) and 0 < float(img.mean()) < 1


def test_api_render_routes_split():
    scene, cfg = presets.glass_scene(8, 6, 2, 3, device="cpu")
    split_cfg = dataclasses.replace(cfg, fresnel_mode="split")
    img = api.render(scene, split_cfg, seed=2)
    assert img.device.type == "cpu" and img.shape == (6, 8, 3)
    assert torch.equal(img, pt.render_image_split(scene, split_cfg, 2))
    assert not torch.equal(img, api.render(scene, cfg, seed=2))
    with pytest.raises(ValueError, match="fresnel_mode"):
        api.render(scene, dataclasses.replace(cfg, fresnel_mode="both"))
