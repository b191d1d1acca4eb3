"""The port's camera render slice against the JAX package on the CPU: scene
building, camera rays, one bounce and whole paths traced from the same
uniforms, the LTS Cornell golden image, the interop round trip, and the
port's entry points defaulting to the card.

The JAX side runs its own tracer on the CPU: the brute force for the
28-triangle Cornell scene and the BVH walk for the 414-triangle ``glass``
preset, where the port runs the plain version of its dense kernel (K3).
Tolerances: >= 99 % of lanes within rtol 1e-4, atol 1e-6 (XLA's CPU sqrt
and its fused multiply-adds round an ulp away from torch, and an ulp can
flip a rare Russian-roulette or Fresnel branch), image means within 1e-3,
the same triangle on >= 99 % of the records that are not exact ties.
"""

import dataclasses
import inspect
import pathlib
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.core import rng as jrng
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu_torch import api
from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.scene.geometry import MESH_FIELDS
from light_transport_tpu_torch.scene.lights import LIGHT_FIELDS
from light_transport_tpu_torch.scene.material import MATERIAL_FIELDS
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "lts_cornell_48.npy"
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False}
SCENES = {
    "cornell": lambda: jpresets.lts_scene(width=16, height=16, spp=2,
                                          max_depth=3),
    "glass": lambda: jpresets.glass_scene(16, 16, 2, 3),
}


def jax_scene_arrays(js) -> dict:
    d = {"mesh": {k: np.asarray(getattr(js.mesh, k)) for k in MESH_FIELDS},
         "materials": {k: np.asarray(getattr(js.materials, k))
                       for k in MATERIAL_FIELDS},
         "lights": {k: np.asarray(getattr(js.lights, k))
                    for k in LIGHT_FIELDS},
         "camera": np.asarray(js.camera)}
    if js.bvh is not None:
        d["bvh"] = {k: np.asarray(getattr(js.bvh, k))
                    for k in interop.BVH_FIELDS}
    return d


def port_cfg(jcfg) -> RenderConfig:
    return RenderConfig(**dataclasses.asdict(jcfg))


def jax_uniforms(key, cfg):
    """``_camera_lanes``' draws for the uniform sampler and a pinhole."""
    n = cfg.height * cfg.width * cfg.spp
    k_aa, k_u = jax.random.split(key)
    u_aa = jax.random.uniform(k_aa, (n, 2))
    return np.asarray(u_aa), np.asarray(
        jrng.path_uniforms(k_u, n, cfg.max_depth))


@pytest.fixture(scope="module", params=sorted(SCENES))
def traced(request):
    """One bounce and the whole trace on both sides, same uniforms."""
    js, jcfg = SCENES[request.param]()
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    cfg = port_cfg(jcfg)
    u_aa, uni = jax_uniforms(jax.random.key(7), jcfg)

    def jax_side(js, u_aa, uni):
        o, d = jpt.camera_rays(js, jcfg, u_aa)
        state, rec = jpt._bounce(js, jcfg, jpt.PathState.initial(o, d),
                                 uni[:, 0], 0, None)
        rad, record = jpt.trace_paths(js, jcfg, o, d, uni)
        return o, d, state, rec, rad, record

    jo, jd, jstate, jrec, jrad, jrecord = jax.jit(
        jax_side, compiler_options=CHEAP_COMPILE)(js, u_aa, uni)
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    o, d = pt.camera_rays(scene, cfg, ua)
    # the rays of every bounce, for telling ties apart from mismatches
    states, recs = [pt.PathState.initial(o, d)], []
    for k in range(cfg.max_depth):
        s, r = pt._bounce(scene, cfg, states[-1], un[:, k], k)
        states.append(s)
        recs.append(r)
    rad, record = pt.trace_paths(scene, cfg, o, d, un)
    return dict(name=request.param, js=js, jcfg=jcfg, scene=scene, cfg=cfg,
                u_aa=u_aa, ua=ua, o=o, d=d, jo=np.asarray(jo),
                jd=np.asarray(jd), jstate=jstate, jrec=jrec,
                jrad=np.asarray(jrad), jrecord=jrecord, state=states[1],
                rec=recs[0], states=states[:-1], rad=rad.numpy(),
                record=record)


def lanes_close(a, b, rtol=1e-4, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    close = np.isclose(a, b, rtol=rtol, atol=atol)
    return close.reshape(close.shape[0], -1).all(axis=1)


def test_one_bounce_matches_jax(traced):
    s, js = traced["state"], traced["jstate"]
    ok = np.ones(s.alive.shape[0], bool)
    for f in ("origin", "direction", "throughput", "radiance", "prev_pdf",
              "med_sig_a"):
        ok &= lanes_close(getattr(s, f).numpy(), getattr(js, f))
    for f in ("alive", "emit_ok"):
        ok &= getattr(s, f).numpy() == np.asarray(getattr(js, f))
    ok &= traced["rec"][3].numpy() == np.asarray(traced["jrec"][3])
    assert ok.mean() >= 0.99, ok.mean()
    assert float(s.radiance.sum()) > 0  # NEE reached the light


def test_trace_paths_matches_jax(traced):
    rad, jrad = traced["rad"], traced["jrad"]
    close = lanes_close(rad, jrad)
    assert close.mean() >= 0.99, close.mean()
    cfg = traced["cfg"]
    img = pt._to_image(torch.from_numpy(rad), cfg)[0].numpy()
    jimg = np.asarray(jpt._to_image(jrad, cfg)[0])
    assert abs(img.mean() - jimg.mean()) < 1e-3
    assert img.mean() > 0.01
    rec, jrec = traced["record"], traced["jrecord"]
    for f in ("log_pdf", "incident"):
        assert lanes_close(getattr(rec, f).numpy(),
                           getattr(jrec, f)).mean() >= 0.99, f
    assert (rec.alive.numpy() == np.asarray(jrec.alive)).all(1).mean() >= 0.99
    tri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    tie = tie_records(traced["scene"], traced["states"], tri, jtri)
    same_tri = (tri == jtri)[~tie].mean()
    assert same_tri >= 0.99, (same_tri, tie.mean())
    if traced["name"] == "cornell":
        assert not tie.any()  # no coincident surfaces there


def mt_float64(verts, o, d):
    """Möller–Trumbore in float64: (t, u, v) of rays ``o``, ``d`` (n, 3)
    against triangles ``verts`` (n, 3, 3)."""
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    s = o - verts[:, 0]
    q = np.cross(s, e1)
    return ((e2 * q).sum(1) / det, (s * p).sum(1) / det,
            (d * q).sum(1) / det)


def tie_records(scene, states, tri, jtri):
    """(N, depth) bool: the records where the two sides picked different
    triangles that the port's ray hits at the same distance, and the later
    records of those lanes.  The glass's body and liquid share coplanar
    surfaces, tessellated apart; JAX's BVH walk and the port's lowest-index
    rule break such a tie differently, and the path then goes on in
    another medium."""
    n, depth = tri.shape
    differ = tri != jtri
    first = np.where(differ.any(1), differ.argmax(1), depth)
    lanes = np.nonzero(first < depth)[0]
    k = first[lanes]
    a, b = tri[lanes, k], jtri[lanes, k]
    o = np.stack([s.origin.double().numpy() for s in states], 1)[lanes, k]
    d = np.stack([s.direction.double().numpy() for s in states], 1)[lanes, k]
    verts = scene.mesh.vertices()
    ta, ua, va = mt_float64(verts[a], o, d)
    tb, ub, vb = mt_float64(verts[b], o, d)
    inside = ((np.minimum(ua, ub) >= -1e-6) & (np.minimum(va, vb) >= -1e-6)
              & (np.maximum(ua + va, ub + vb) <= 1 + 1e-6))
    tie = (a >= 0) & (b >= 0) & inside & (
        np.abs(ta - tb) <= 1e-6 * np.maximum(1.0, np.abs(ta)))
    out = np.zeros((n, depth), bool)
    for lane, kk in zip(lanes[tie], k[tie]):
        out[lane, kk:] = True
    return out


def written_camera_offsets(cfg, camera, u_aa):
    """JAX's ``_pixel_camera_rays`` up to its normalize, evaluated in
    float32 exactly as its source writes it (``jnp.linspace``'s formula)."""
    f32 = np.float32
    left, right, top, bottom = cfg.screen_bounds

    def grid(a, b, num):
        s = np.arange(num - 1, dtype=f32) / f32(num - 1)
        return np.append(f32(a) * (f32(1) - s) + f32(b) * s, f32(b))

    ids = np.tile(np.arange(cfg.height * cfg.width), cfg.spp)
    px = grid(left, right, cfg.width)[ids % cfg.width] + u_aa[:, 0] / f32(
        cfg.width)
    py = grid(top, bottom, cfg.height)[ids // cfg.width] + u_aa[:, 1] / f32(
        cfg.height)
    pixel = np.stack([px, py, np.full_like(px, f32(cfg.f_distance))], -1)
    return pixel - camera


def test_camera_rays_match_jax_to_the_ulp(traced):
    """The port's unnormalised directions are JAX's formula bitwise.  XLA
    rewrites that formula when it compiles it (a multiply by the
    reciprocal of W - 1, reassociated), which moves JAX's by at most one
    ulp of the unit screen extent; the normalize adds at most one ulp of
    1.0 on each side (XLA's CPU sqrt and reciprocal)."""
    ulp = 2.0 ** -23  # one ulp of 1.0
    np.testing.assert_array_equal(traced["o"].numpy(), traced["jo"])
    scene, cfg, js, jcfg = (traced[k] for k in ("scene", "cfg", "js",
                                                  "jcfg"))
    n_pix = cfg.height * cfg.width
    pixel_ids = torch.arange(n_pix).repeat(cfg.spp)
    _, v = pt._pixel_camera_offsets(scene, cfg, pixel_ids, traced["ua"])
    v = v.numpy()
    np.testing.assert_array_equal(
        v, written_camera_offsets(cfg, scene.camera.numpy(), traced["u_aa"]))
    with mock.patch.object(jpt.lm, "normalize", lambda x, eps=1e-20: x):
        _, jv = jax.jit(lambda u: jpt.camera_rays(js, jcfg, u),
                        compiler_options=CHEAP_COMPILE)(traced["u_aa"])
    _, jd = jax.jit(lambda u: jpt.camera_rays(js, jcfg, u),
                    compiler_options=CHEAP_COMPILE)(traced["u_aa"])
    jv, jd = np.array(jv), np.asarray(jd)
    assert np.abs(v - jv).max() <= ulp
    # the port's normalize of JAX's own offsets against JAX's directions
    d_of_jv = lm.normalize(torch.from_numpy(jv)).numpy()
    assert np.abs(d_of_jv - jd).max() <= ulp
    # so the two sides' unit vectors are within an ulp of 1.0 each way
    assert np.abs(traced["d"].numpy() - traced["jd"]).max() <= 2 * ulp


@pytest.mark.parametrize("name", ["lts", "glass", "mesh"])
def test_scene_tables_match_jax(name):
    small = dict(width=8, height=8, spp=1, max_depth=2)
    if name == "glass":
        js, jcfg = jpresets.glass_scene(**small)
        scene, cfg = presets.glass_scene(**small, device="cpu")
    elif name == "lts":
        js, jcfg = jpresets.lts_scene(**small)
        scene, cfg = presets.lts_scene(device="cpu", **small)
    else:
        js, jcfg = jpresets.mesh_scene()
        scene, cfg = presets.mesh_scene(device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ours, theirs = interop.scene_to_numpy(scene), jax_scene_arrays(js)
    for table in ("mesh", "materials", "lights"):
        for k, v in theirs[table].items():
            a = ours[table][k]
            assert a.dtype == v.dtype and a.shape == v.shape, (table, k)
            np.testing.assert_array_equal(a, v, err_msg=f"{table}.{k}")
    np.testing.assert_array_equal(ours["camera"], theirs["camera"])
    assert (ours["bvh"] is None) == ("bvh" not in theirs)
    if ours["bvh"] is not None:  # the BVH order decides the clusters
        for k, v in theirs["bvh"].items():
            np.testing.assert_array_equal(ours["bvh"][k], v, err_msg=k)


def test_lts_cornell_golden():
    """The stored JAX render of the LTS Cornell scene (48x48, 4 spp, depth
    3, key 42), rendered by the port from the same uniforms, to the JAX
    golden test's bounds."""
    js, jcfg = jpresets.lts_scene(width=48, height=48, spp=4, max_depth=3)
    scene, cfg = presets.lts_scene(width=48, height=48, spp=4, max_depth=3,
                                   device="cpu")
    u_aa, uni = jax_uniforms(jax.random.key(42), jcfg)
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    o, d = pt.camera_rays(scene, cfg, ua)
    rad, _ = pt.trace_paths(scene, cfg, o, d, un)
    img = pt._to_image(rad, cfg)[0].numpy()
    err = np.abs(img - np.load(GOLDEN))
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.05, err.max()


def test_render_entry_points_on_the_cpu():
    scene, cfg = presets.glass_scene(12, 10, 2, 3, device="cpu")
    img = api.render(scene, cfg, seed=1)
    assert img.shape == (10, 12, 3) and img.device.type == "cpu"
    assert torch.isfinite(img).all() and 0 < float(img.mean()) < 1
    assert torch.equal(img, api.render(scene, cfg, seed=1))
    img2, energy, hits = pt.render_with_detectors(scene, cfg, seed=1)
    assert torch.equal(img2, img)
    assert energy.shape == hits.shape == (scene.mesh.num_triangles,)
    assert int(hits.sum()) > 0 and float(energy.sum()) > 0


@pytest.mark.parametrize("change", [
    dict(fresnel_mode="split"), dict(sampler="sobol"), dict(aperture=0.1),
    dict(shadow_mode="transmittance"), dict(compact_tail=True)])
def test_unported_options_raise(change):
    """Every option, all ported since, renders through ``api.render`` as
    the module's function renders it (``fresnel_mode="split"`` through the
    split tracer, ``compact_tail`` through the tail-compacting one)."""
    scene, cfg = presets.lts_scene(width=4, height=4, spp=1, max_depth=1,
                                   device="cpu")
    cfg = dataclasses.replace(cfg, **change)
    one = {"fresnel_mode": pt.render_image_split,
           "compact_tail": pt.render_image_compact}.get(
               next(iter(change)), pt.render_image)
    img = api.render(scene, cfg, seed=3)
    assert torch.equal(img, one(scene, cfg, 3))
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()


def test_unported_integrators_raise():
    """Whitted, adaptive and BDPT, ported since, render through
    ``api.render``."""
    scene, cfg = presets.lts_scene(width=4, height=4, spp=1, max_depth=1,
                                   device="cpu")
    from light_transport_tpu_torch.integrators.bdpt import render_bdpt

    img = api.render(scene, cfg, seed=2, integrator="bdpt")
    assert torch.equal(img, render_bdpt(scene, cfg, 2))
    from light_transport_tpu_torch.integrators.adaptive import render_adaptive
    from light_transport_tpu_torch.integrators.whitted import render_whitted

    img = api.render(scene, cfg, integrator="whitted")
    assert torch.equal(img, render_whitted(scene, cfg))
    img = api.render(scene, cfg, integrator="adaptive")
    assert torch.equal(img, render_adaptive(scene, cfg, rounds=1))


def test_interop_scene_hit_and_uniform_round_trip():
    scene, _ = presets.glass_scene(4, 4, 1, 1, device="cpu")
    d = interop.scene_to_numpy(scene)
    back = interop.scene_to_numpy(interop.scene_from_numpy(d, device="cpu"))
    for table in ("mesh", "materials", "lights", "bvh"):
        for k, v in d[table].items():
            np.testing.assert_array_equal(back[table][k], v, err_msg=k)
    rng = np.random.default_rng(0)
    hit = dict(t=rng.random(9).astype(np.float32),
               tri=rng.integers(-1, 9, 9).astype(np.int32),
               valid=rng.random(9) > 0.5)
    out = interop.hit_to_numpy(interop.hit_from_numpy(**hit, device="cpu"))
    for k, v in hit.items():
        np.testing.assert_array_equal(out[k], v)
    u_aa, uni = rng.random((6, 2)), rng.random((6, 3, 7))
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    assert ua.dtype == un.dtype == torch.float32 and un.shape == (6, 3, 7)


BIG = dispatch.MXU_MAX_TRIS + 1
# the router's table: case -> (stand-in scene's fields, the rays' device,
# coherent, the route; None where it raises)
ROUTES = {
    "watertight": (dict(tris=BIG, watertight=True, bvh=True, treelet=True),
                   "cuda", True, "watertight"),
    "small": (dict(tris=dispatch.SMALL_MESH_TRIS, bvh=True), "cuda", False,
              "brute"),
    "cluster": (dict(tris=dispatch.SMALL_MESH_TRIS + 1), "cpu", False,
                "cluster"),
    "cluster-cap": (dict(tris=dispatch.MXU_MAX_TRIS, bvh=True, treelet=True),
                    "cuda", False, "cluster"),
    "bvh": (dict(tris=BIG, bvh=True), "cuda", False, "bvh"),
    "bvh-coherent": (dict(tris=BIG, bvh=True), "cuda", True, "cluster"),
    "treelet": (dict(tris=BIG, bvh=True, treelet=True), "cuda", False,
                "treelet"),
    "treelet-coherent": (dict(tris=BIG, bvh=True, treelet=True), "cuda",
                         True, "treelet"),
    "no-bvh-cpu": (dict(tris=BIG), "cpu", False, "brute"),
    "no-bvh-cuda": (dict(tris=BIG), "cuda", False, None),
    "no-bvh-cuda-coherent": (dict(tris=BIG), "cuda", True, "cluster"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_dispatch_router(case):
    """The dispatch's one router on stand-in scenes: the watertight flag
    first, the brute force to 48 triangles, the cluster intersector to
    the crossover whatever the scene carries, past it the BVH (one K5
    launch), the treelet tables (one sorted K5 launch) or, for coherent
    rays without tables, the cluster intersector; without a BVH the brute
    force on the CPU and a refusal on the card."""
    fields, device, coherent, want = ROUTES[case]
    scene = types.SimpleNamespace(
        watertight=fields.get("watertight", False),
        mesh=types.SimpleNamespace(num_triangles=fields["tris"]),
        bvh=object() if fields.get("bvh") else None,
        treelet=object() if fields.get("treelet") else None)
    if want is None:
        with pytest.raises(ValueError, match="needs a BVH"):
            dispatch._route(scene, torch.device(device), coherent)
    else:
        assert dispatch._route(scene, torch.device(device), coherent) == want


def _default_device(fn):
    return inspect.signature(fn).parameters["device"].default


def test_entry_points_default_to_the_card():
    """Every public constructor and entry point builds on CUDA unless the
    caller passes device="cpu"; the photon and render entry points take
    the device of the medium or scene they are given."""
    from light_transport_tpu_torch.ops import photon_kernel
    from light_transport_tpu_torch.scene import cornell, glass
    from light_transport_tpu_torch.scene.analytic import AnalyticPrims
    from light_transport_tpu_torch.scene.lights import PointLightTable
    from light_transport_tpu_torch.scene.geometry import TriangleMesh
    from light_transport_tpu_torch.scene.material import MaterialTable
    from light_transport_tpu_torch.scene.medium import LayeredMedium
    from light_transport_tpu_torch.tally.tallies import PhotonTallies
    from light_transport_tpu_torch.transport.photon import PhotonState

    on_card = [LayeredMedium.build, PhotonTallies.zeros, PhotonState.dead,
               TriangleMesh.build,
               MaterialTable.build, cornell.cornell_box_scene,
               glass.design_glass, *presets.PRESETS.values(),
               interop.medium_from_numpy, interop.tallies_from_numpy,
               interop.kernel_state_from_numpy,
               interop.photon_state_from_numpy, interop.scene_from_numpy,
               interop.uniforms_from_numpy, interop.hit_from_numpy,
               AnalyticPrims.build, PointLightTable.build,
               presets.hard_shadow_scene]
    for fn in on_card:
        assert _default_device(fn) == "cuda", fn.__qualname__
    # the entry points follow their medium or scene
    for fn in (api.simulate, photon_kernel.simulate_kernel):
        assert _default_device(fn) is None, fn.__qualname__
    assert "device" not in inspect.signature(api.render).parameters
    scene, cfg = presets.lts_scene(width=2, height=2, spp=1, max_depth=1,
                                   device="cpu")
    assert api.render(scene, cfg).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            presets.lts_scene(width=2, height=2)  # torch's own error
