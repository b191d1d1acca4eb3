"""The port's watertight triangle test and ``Scene.with_watertight()`` on
the CPU: ``ops.intersect.intersect_rays_watertight`` and
``occluded_watertight`` against JAX's on the same rays, and the cases of
``tests/test_intersect.py:117-286`` through the port (interior hits
against Möller–Trumbore, shared edges that never crack, at unfriendly
coordinates too, the t window, chunking, render and occlusion parity),
then the dispatch's route, ``with_bvh`` and the interop of the flag.

JAX's intersection runs eagerly, op by op, as ``tests/test_intersect.py``
runs it (under ``jax.jit`` XLA fuses multiply-adds, which move ``t`` by
up to 4.5e-5 relative at small t and drop a shared-edge ray of the fan);
its tracer and dispatch run compiled with the tests' ``CHEAP_COMPILE``.
Tolerances against JAX: ``tri`` and ``valid`` equal on >= 99.9 % of
lanes, and every other lane near an edge of a triangle it names (float64
barycentric within 1e-5, where one ulp decides); ``t`` within rtol 1e-6.
Traced radiance: >= 99 % of lanes within rtol 1e-4, atol 1e-6, as
``tests/test_torch_render.py`` holds the tracer; any-hit answers equal on
>= 99.9 % of lanes.
"""

import dataclasses
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import dispatch as jdispatch
from light_transport_tpu.ops import intersect as jintersect
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import dispatch, intersect
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.scene import geometry
from light_transport_tpu_torch.scene import scene as scene_mod
from light_transport_tpu_torch.utils import interop
from test_torch_render import (
    CHEAP_COMPILE,
    jax_scene_arrays,
    jax_uniforms,
    lanes_close,
    port_cfg,
)

torch.set_num_threads(1)


def soup(seed=11, n_tri=300, n_ray=512):
    """``tests/test_intersect.py``'s random triangle soup and rays."""
    r = np.random.default_rng(seed)
    verts = r.normal(scale=2.0, size=(n_tri, 3, 3)).astype(np.float32)
    o = r.normal(scale=4.0, size=(n_ray, 3)).astype(np.float32)
    d = r.normal(size=(n_ray, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return verts, o, d


def fan(n_spokes, scale=1.0, off=(0.0, 0.0, 0.0)):
    """A fan of ``n_spokes`` triangles around a shared centre, float64."""
    ang = np.linspace(0, 2 * np.pi, n_spokes + 1)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    tris = np.stack([np.zeros((n_spokes, 3)), rim[:-1], rim[1:]], axis=1)
    return tris * scale + np.asarray(off)


def fan_rays():
    """Rays at every spoke (a shared edge) at four radii and at the shared
    centre, from an oblique camera (``test_watertight_shared_edges_never_
    crack``)."""
    ang = np.linspace(0, 2 * np.pi, 25)[:-1]
    radii = np.asarray([1e-4, 0.25, 0.5 + 1e-7, 0.999], np.float32)
    pts = np.concatenate(
        [np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros_like(ang)], -1)
         for r in radii] + [np.zeros((1, 3))]).astype(np.float32)
    cam = np.asarray([0.3, -0.2, 3.0], np.float32)
    dd = pts - cam
    d = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
    return np.tile(cam, (len(pts), 1)), d, np.linalg.norm(dd, axis=1)


def both_meshes(verts):
    mat = np.zeros(len(verts), np.int32)
    return (jgeo.TriangleMesh.build(verts, mat),
            geometry.TriangleMesh.build(verts, mat, device="cpu"))


def t_(a):
    return torch.from_numpy(np.asarray(a))


def jax_hits(jmesh, o, d):
    """JAX's watertight test run eagerly, as its own tests run it: XLA's
    jit fuses multiply-adds, which move t by an ulp and can drop an edge
    ray (a crack)."""
    hit = jintersect.intersect_rays_watertight(o, d, jmesh)
    return {k: np.asarray(getattr(hit, k)) for k in ("t", "tri", "valid")}


def near_edge(verts, o, d, tris, tol=1e-5):
    """True where the float64 ray meets the plane of any of ``tris`` (one
    list of triangle ids a ray) within ``tol`` of an edge in barycentric
    terms."""
    out = []
    for i, cands in enumerate(tris):
        near = False
        for k in cands:
            if k < 0:
                continue
            v0, v1, v2 = verts[k].astype(np.float64)
            e1, e2 = v1 - v0, v2 - v0
            p = np.cross(d[i].astype(np.float64), e2)
            det = e1 @ p
            if abs(det) < 1e-30:
                near = True
                continue
            s = o[i].astype(np.float64) - v0
            u = (s @ p) / det
            v = (d[i].astype(np.float64) @ np.cross(s, e1)) / det
            near |= min(u, v, 1.0 - u - v) < tol
        out.append(near)
    return np.asarray(out)


@pytest.fixture(scope="module")
def soup_hits():
    verts, o, d = soup()
    jmesh, mesh = both_meshes(verts)
    return dict(verts=verts, o=o, d=d, mesh=mesh, jax=jax_hits(jmesh, o, d),
                port=intersect.intersect_rays_watertight(t_(o), t_(d), mesh))


def test_watertight_matches_jax_on_the_soup(soup_hits):
    h, jh = soup_hits["port"], soup_hits["jax"]
    same = (h.valid.numpy() == jh["valid"]) & (h.tri.numpy() == jh["tri"])
    assert same.mean() >= 0.999, same.mean()
    bad = np.nonzero(~same)[0]
    named = near_edge(soup_hits["verts"], soup_hits["o"][bad],
                      soup_hits["d"][bad],
                      [(h.tri[i].item(), jh["tri"][i]) for i in bad])
    assert named.all(), bad[~named]
    ok = same & h.valid.numpy()
    np.testing.assert_allclose(h.t.numpy()[ok], jh["t"][ok], rtol=1e-6)
    assert ok.sum() > 50


def test_watertight_matches_mt_on_interior_hits(soup_hits):
    """``tests/test_intersect.py``'s agreement with Möller–Trumbore."""
    o, d, mesh = t_(soup_hits["o"]), t_(soup_hits["d"]), soup_hits["mesh"]
    hm = intersect.intersect_rays(o, d, mesh)
    hw = soup_hits["port"]
    vm, vw = hm.valid.numpy(), hw.valid.numpy()
    assert (vm != vw).mean() < 0.01
    both = vm & vw
    agree = hm.tri.numpy()[both] == hw.tri.numpy()[both]
    assert agree.mean() > 0.99
    np.testing.assert_allclose(hm.t.numpy()[both][agree],
                               hw.t.numpy()[both][agree], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("unfriendly", [False, True])
def test_shared_edges_never_crack(unfriendly):
    """Rays exactly at shared fan edges and the shared vertex hit; at an
    offset where one ulp is ~2^-11 of the geometry (the fan scaled by
    1/3 off the binary grid) too; and JAX's test agrees."""
    if unfriendly:
        off = np.asarray([4096.37, -8192.11, 513.77])
        verts = fan(24, 1.0 / 3.0, off).astype(np.float32)
        targets = [verts[:, 0, :][:1]]
        for r in (0.2, 0.5, 0.93):
            targets.append((verts[:, 0, :] + np.float32(r)
                            * (verts[:, 1, :] - verts[:, 0, :])
                            ).astype(np.float32))
        pts = np.concatenate(targets)
        cam = (off + np.asarray([0.21, -0.13, 2.7])).astype(np.float32)
        dd = pts.astype(np.float64) - cam.astype(np.float64)
        dist = np.linalg.norm(dd, axis=1)
        d = (dd / dist[:, None]).astype(np.float32)
        o = np.tile(cam, (len(pts), 1))
    else:
        verts = fan(24).astype(np.float32)
        o, d, dist = fan_rays()
    jmesh, mesh = both_meshes(verts)
    h = intersect.intersect_rays_watertight(t_(o), t_(d), mesh)
    assert bool(h.valid.all()), np.nonzero(~h.valid.numpy())[0]
    np.testing.assert_allclose(h.t.numpy(), dist, rtol=1e-4)
    jh = jax_hits(jmesh, o, d)
    assert jh["valid"].all()
    np.testing.assert_allclose(h.t.numpy(), jh["t"], rtol=1e-6)
    # Möller–Trumbore may drop such rays; the watertight test may not
    occ = intersect.occluded_watertight(t_(o), t_(d), mesh,
                                        torch.from_numpy(dist * 1.01))
    assert bool(occ.all())


def test_watertight_respects_t_window():
    mesh = both_meshes(fan(6).astype(np.float32))[1]
    o = torch.tensor([[0.1, 0.05, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    assert bool(intersect.intersect_rays_watertight(o, d, mesh).valid[0])
    assert not bool(intersect.intersect_rays_watertight(
        o, d, mesh, t_max=1.5).valid[0])
    assert not bool(intersect.intersect_rays_watertight(
        o, d, mesh, t_min=2.5).valid[0])
    assert not bool(intersect.occluded_watertight(o, d, mesh, 1.5)[0])
    assert bool(intersect.occluded_watertight(o, d, mesh, 2.5)[0])


def test_watertight_ray_chunking():
    mesh = both_meshes(fan(8).astype(np.float32))[1]
    r = np.random.default_rng(5)
    o = np.tile([0.0, 0.0, 3.0], (300, 1)).astype(np.float32)
    pts = r.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts[:, 2] = 0.0
    dd = pts - np.asarray([0, 0, 3.0])
    d = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
    full = intersect.intersect_rays_watertight(t_(o), t_(d), mesh)
    chunked = intersect.intersect_rays_watertight(t_(o), t_(d), mesh,
                                                  ray_chunk=128)
    for f in ("t", "tri", "valid"):
        assert torch.equal(getattr(full, f), getattr(chunked, f))
    md = torch.full((300,), 5.0)
    assert torch.equal(
        intersect.occluded_watertight(t_(o), t_(d), mesh, md),
        intersect.occluded_watertight(t_(o), t_(d), mesh, md, ray_chunk=77))


@pytest.fixture(scope="module")
def cornell():
    js, jcfg = jpresets.lts_scene(width=16, height=16, spp=2, max_depth=3)
    scene = interop.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    return js, jcfg, scene, port_cfg(jcfg)


def test_watertight_render_parity(cornell):
    """The watertight render against the Möller–Trumbore one (same seed,
    ``tests/test_intersect.py``'s bounds), and the watertight trace
    against JAX's from the same uniforms."""
    js, jcfg, scene, cfg = cornell
    wt = scene.with_watertight()
    img_mt = pt.render_image(scene, cfg, seed=9).numpy()
    img_wt = pt.render_image(wt, cfg, seed=9).numpy()
    assert np.isfinite(img_wt).all()
    assert abs(img_wt.mean() - img_mt.mean()) < 2e-3
    assert np.abs(img_wt - img_mt).mean() < 8e-3

    jwt = js.with_watertight()
    u_aa, uni = jax_uniforms(jax.random.key(4), jcfg)
    jrad = np.asarray(jax.jit(lambda u, v: jpt.trace_paths(
        jwt, jcfg, *jpt.camera_rays(jwt, jcfg, u), v)[0],
        compiler_options=CHEAP_COMPILE)(u_aa, uni))
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    rad = pt.trace_paths(wt, cfg, *pt.camera_rays(wt, cfg, ua), un)[0]
    close = lanes_close(rad.numpy(), jrad)
    assert close.mean() >= 0.99, close.mean()
    assert rad.mean() > 0.01


def test_watertight_occlusion_parity(cornell):
    """Any-hit against Möller–Trumbore and against JAX's watertight
    dispatch; inactive lanes report unoccluded."""
    js, _, scene, _ = cornell
    r = np.random.default_rng(3)
    n = 256
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wt = scene.with_watertight()
    occ_mt = dispatch.scene_occluded(scene, t_(o), t_(d), 5.0).numpy()
    occ_wt = dispatch.scene_occluded(wt, t_(o), t_(d), 5.0).numpy()
    assert (occ_mt == occ_wt).mean() > 0.99
    active = r.random(n) < 0.5
    jocc = np.asarray(jax.jit(lambda o, d, a: jdispatch.scene_occluded(
        js.with_watertight(), o, d, 5.0, active=a),
        compiler_options=CHEAP_COMPILE)(o, d, active))
    got = dispatch.scene_occluded(wt, t_(o), t_(d), 5.0,
                                  active=t_(active)).numpy()
    assert (got == jocc).mean() >= 0.999
    assert not got[~active].any() and got.any()
    assert not dispatch.scene_occluded(wt, t_(o), t_(d), 5.0,
                                       active=torch.zeros(n, dtype=bool)
                                       ).any()


def test_watertight_scene_reaches_no_kernel():
    """The glass preset (414 triangles, the cluster route) with the flag:
    every query is the watertight brute force, and the cluster
    intersector is never called."""
    scene, cfg = presets.glass_scene(8, 8, 1, 2, device="cpu")
    wt = scene.with_watertight()
    o, d, u = pt._camera_lanes(wt, cfg, 2)

    def refuse(*a, **k):
        raise AssertionError("the cluster intersector was called")

    with mock.patch.object(ik, "intersect_rays_pallas", refuse):
        hit = dispatch.scene_intersect(wt, o, d)
        occ = dispatch.scene_occluded(wt, o, d, 3.0)
        img = pt.render_image(wt, cfg, seed=2)
    want = intersect.intersect_rays_watertight(o, d, wt.mesh)
    assert torch.equal(hit.t, want.t) and torch.equal(hit.tri, want.tri)
    assert torch.equal(occ, intersect.occluded_watertight(o, d, wt.mesh,
                                                          3.0))
    assert torch.isfinite(img).all() and float(img.mean()) > 0


def test_with_bvh_and_interop_keep_the_flag():
    """``with_bvh`` keeps the flag and attaches no treelet tables to a
    watertight scene (``_auto_treelet`` refuses it, as JAX's does);
    ``with_point_lights`` and the interop round trip keep it."""
    scene, _ = presets.lts_scene(width=4, height=4, spp=1, max_depth=1,
                                 device="cpu")
    wt = scene.with_watertight()
    assert not scene.watertight and wt.watertight
    assert not wt.with_watertight(False).watertight
    b = wt.with_bvh()
    assert b.watertight and b.bvh is not None and b.treelet is None
    assert b.with_point_lights([[0, 1, 0]], [[1, 1, 1]]).watertight
    fake = types.SimpleNamespace(
        device=torch.device("cuda"), watertight=True,
        mesh=types.SimpleNamespace(
            num_triangles=dispatch.MXU_MAX_TRIS + 1))
    assert not scene_mod._auto_treelet(fake)
    fake.watertight = False
    assert scene_mod._auto_treelet(fake)
    d = interop.scene_to_numpy(b)
    assert d["watertight"] is True
    back = interop.scene_from_numpy(d, device="cpu")
    assert back.watertight and back.bvh is not None
    assert not interop.scene_from_numpy(interop.scene_to_numpy(scene),
                                        device="cpu").watertight
    o, dd = torch.tensor([[0.0, 0.0, 5.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    hb, hw = (dispatch.scene_intersect(s, o, dd) for s in (b, wt))
    assert torch.equal(hb.t, hw.t)
    assert dataclasses.replace(b, bvh=None).watertight
