"""The port's analytic spheres and planes and its point lights against the
JAX package on the CPU: the sphere, plane and box tests, the dispatch's
queries with analytic primitives on the brute-force and cluster routes,
the path tracer's point-light term from JAX's uniforms, the point-light
and hard-shadow presets' tables, and the port alone on a closed form and
on the interop round trip.

JAX's tracer is compiled with the tests' ``CHEAP_COMPILE`` options.
Tolerances: ``kind``, ``prim`` and ``valid`` exact and ``t`` within rtol
1e-6 (the port's cluster route computes ``t`` from packed weights);
traced paths on >= 99 % of lanes within rtol 1e-4, atol 1e-6, as
``tests/test_torch_render.py`` holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import dispatch as jdispatch
from light_transport_tpu.ops import intersect as jintersect
from light_transport_tpu.scene import analytic as janalytic
from light_transport_tpu.scene import cornell as jcornell
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu.scene import material as jmat
from light_transport_tpu.scene import scene as jscene
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import dispatch, intersect
from light_transport_tpu_torch.scene import analytic, cornell, geometry
from light_transport_tpu_torch.scene import material
from light_transport_tpu_torch.scene import scene as tscene
from light_transport_tpu_torch.scene.analytic import ANALYTIC_FIELDS
from light_transport_tpu_torch.scene.lights import POINT_LIGHT_FIELDS
from light_transport_tpu_torch.utils import interop
from test_torch_render import (
    CHEAP_COMPILE,
    jax_scene_arrays,
    jax_uniforms,
    lanes_close,
    port_cfg,
)

torch.set_num_threads(1)

SPHERE = ((0.0, 0.0, -1.0), 1.0)  # tests/test_analytic.py's sphere


def jax_scene_tables(js) -> dict:
    """``jax_scene_arrays`` with the analytic and point-light tables."""
    d = jax_scene_arrays(js)
    for key, fields in (("analytic", ANALYTIC_FIELDS),
                        ("point_lights", POINT_LIGHT_FIELDS)):
        table = getattr(js, key)
        if table is not None:
            d[key] = {k: np.asarray(getattr(table, k)) for k in fields}
    return d


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def analytic_scene(geo, mat, scn, prims, sphere_mat=None, n_theta=0, **dev):
    """``tests/test_analytic.py``'s scene from either package: a floor, a
    ceiling light and the analytic primitives ``prims``; ``n_theta`` > 0
    adds a tessellated sphere beside them (the port's cluster route)."""
    floor = geo.quad_triangles((-20, -1, -20), (-20, -1, 20), (20, -1, 20),
                               (20, -1, -20))
    lq = geo.quad_triangles((-2, 8, -3), (2, 8, -3), (2, 8, 1), (-2, 8, 1))
    tris, ids, lit = [floor, lq], [0, 0, 1, 1], [False] * 2 + [True] * 2
    if n_theta:
        st = jcornell.sphere_triangles(center=(2.5, 0.0, -1.5), radius=0.8,
                                       n_theta=n_theta, n_phi=2 * n_theta)
        tris.append(st)
        ids += [2] * len(st)
        lit += [False] * len(st)
    mats = mat.MaterialTable.build([
        mat.Material(color=mat.presets.GREY),
        mat.Material(color=mat.presets.WHITE, emission=6.0),
        sphere_mat or mat.Material(color=mat.presets.TURQUOISE)], **dev)
    mesh = geo.TriangleMesh.build(np.concatenate(tris),
                                  np.asarray(ids, np.int32),
                                  np.asarray(lit, bool), **dev)
    return scn.Scene.build(mesh, mats, camera=[0.0, 1.0, 6.0],
                           analytic=prims)


def prim_tables(pkg, **dev):
    """One sphere and two planes (a wall behind and a tilted one)."""
    return pkg.AnalyticPrims.build(
        spheres=[(*SPHERE, 2)],
        planes=[((0, 0, -6), (0, 0, 1), 0), ((4, 0, 0), (-1, 0.2, 0), 2)],
        **dev)


def random_rays(n, seed):
    """Rays from in front of the scene toward points around its objects."""
    r = np.random.default_rng(seed)
    o = r.uniform(-3, 3, (n, 3)) + np.asarray([0.0, 1.0, 4.0])
    aim = r.uniform((-3.0, -2.0, -4.0), (4.0, 2.5, 1.0), (n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_primitive_tests_match_jax():
    o, d = random_rays(512, seed=1)
    o[:4] = [[0, 0, 4]] * 4  # through the center, and parallel to a plane
    d[:4] = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [0, 1, 0]]
    plane = ((0.0, -1.0, 0.0), (0.0, 0.6, 0.8))
    box = ((-1.0, -1.0, -2.0), (1.0, 0.5, 0.0))
    jsph, jpl, *jbox = jax.jit(lambda o, d: (
        jintersect.sphere_intersect(o, d, *SPHERE),
        jintersect.plane_intersect(o, d, *plane),
        *(jintersect.aabb_intersect(o, d, *box, t_max=t_max)
          for t_max in (np.inf, 3.0))),
        compiler_options=CHEAP_COMPILE)(o, d)
    got = intersect.sphere_intersect(t(o), t(d), *SPHERE).numpy()
    np.testing.assert_allclose(got, np.asarray(jsph), rtol=1e-6)
    assert np.isfinite(got).mean() > 0.1
    got = intersect.plane_intersect(t(o), t(d), *plane).numpy()
    np.testing.assert_allclose(got, np.asarray(jpl), rtol=1e-6)
    for t_max, want in zip((np.inf, 3.0), jbox):
        got = intersect.aabb_intersect(t(o), t(d), *box, t_max=t_max)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        assert got[0].numpy().any() and not got[0].numpy().all()


@pytest.mark.parametrize("route", ["brute force", "cluster"])
def test_scene_queries_match_jax(route):
    """``scene_intersect`` / ``scene_occluded`` with analytic primitives,
    every 5th lane inactive: the port's brute force (4 triangles) or the
    plain cluster intersector (a tessellated sphere beside them) against
    JAX's brute force."""
    n_theta = 10 if route == "cluster" else 0
    js = analytic_scene(jgeo, jmat, jscene, prim_tables(janalytic),
                        n_theta=n_theta)
    scene = analytic_scene(geometry, material, tscene,
                           prim_tables(analytic, device="cpu"),
                           n_theta=n_theta, device="cpu")
    assert dispatch._route(scene, torch.device("cpu")) == (
        "cluster" if route == "cluster" else "brute")
    o, d = random_rays(600, seed=2)
    active = np.ones(600, bool)
    active[::5] = False
    md = np.random.default_rng(3).uniform(0.5, 12.0, 600).astype(np.float32)
    # JAX's triangle query jitted, its analytic merge unjitted: XLA's fused
    # sphere test rounds t an ulp or two apart on grazing lanes
    jtri = jax.jit(lambda o, d: jintersect.intersect_rays(o, d, js.mesh),
                   compiler_options=CHEAP_COMPILE)(o, d)
    jhit = jdispatch._merge_analytic(js, jtri, jnp.asarray(o),
                                     jnp.asarray(d))
    jocc = jax.jit(lambda o, d, md, a: jdispatch.scene_occluded(
        js, o, d, md, active=a), compiler_options=CHEAP_COMPILE)(
            o, d, md, active)
    hit = dispatch.scene_intersect(scene, t(o), t(d), active=t(active))
    occ = dispatch.scene_occluded(scene, t(o), t(d), t(md),
                                  active=t(active)).numpy()
    # the brute force ignores ``active`` for triangles on both sides (JAX's
    # reference runs it): compare the active lanes; an inactive lane gets
    # no triangle hit on the cluster route, and no analytic occluder
    a = active
    for k in ("valid", "kind", "prim"):
        np.testing.assert_array_equal(getattr(hit, k).numpy()[a],
                                      np.asarray(getattr(jhit, k))[a], k)
    np.testing.assert_allclose(hit.t.numpy()[a], np.asarray(jhit.t)[a],
                               rtol=1e-6)
    kinds = hit.kind.numpy()[a & hit.valid.numpy()]
    assert {0, 1, 2} <= set(kinds.tolist()), set(kinds.tolist())
    jocc = np.asarray(jocc)
    assert 0 < occ[a].mean() < 1
    if route == "cluster":
        np.testing.assert_array_equal(occ[a], jocc[a])
        assert (hit.tri.numpy()[~a] == -1).all()
        assert not occ[~a].any()
    else:
        np.testing.assert_array_equal(occ, jocc)
    # an analytic hit on an inactive lane does not occlude it
    o1 = torch.tensor([[0.0, 0.0, 4.0]] * 2)
    d1 = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    occ1 = dispatch.scene_occluded(scene, o1, d1, torch.tensor([10.0, 10.0]),
                                   active=torch.tensor([True, False]))
    assert occ1.tolist() == [True, False]


def test_trace_paths_point_light_matches_jax():
    """``point_light_scene`` at 12x12x2, depth 2: the path tracer on both
    sides from JAX's uniforms, the point light's shadow rays through the
    port's cluster route."""
    js, jcfg = jpresets.point_light_scene(width=12, height=12, spp=2,
                                          max_depth=2)
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    assert scene.point_lights is not None
    cfg = port_cfg(jcfg)
    u_aa, uni = jax_uniforms(jax.random.key(11), jcfg)
    jrad = np.asarray(jax.jit(
        lambda u_aa, uni: jpt.trace_paths(
            js, jcfg, *jpt.camera_rays(js, jcfg, u_aa), uni)[0],
        compiler_options=CHEAP_COMPILE)(u_aa, uni))
    o, d = pt.camera_rays(scene, cfg, t(u_aa))
    rad, _ = pt.trace_paths(scene, cfg, o, d, t(uni))
    close = lanes_close(rad.numpy(), jrad)
    assert close.mean() >= 0.99, close.mean()
    # the panel is dark: every bit of light came from the point
    assert float(rad.sum()) > 0 and float(scene.lights.radiance.sum()) == 0


def test_point_light_free_scene_unchanged():
    """The point-light term draws no uniforms: a black point light leaves
    the traced radiance bitwise that of the scene without one, and a scene
    without analytic primitives keeps the triangle hit record."""
    scene, cfg = cornell.cornell_box_scene(width=8, height=8, spp=1,
                                           max_depth=3, device="cpu")
    o, d, u = pt._camera_lanes(scene, cfg, 5)
    r0, rec0 = pt.trace_paths(scene, cfg, o, d, u)
    black = scene.with_point_lights([[0.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]])
    r1, rec1 = pt.trace_paths(black, cfg, o, d, u)
    assert torch.equal(r0, r1) and torch.equal(rec0.tri, rec1.tri)
    hit = dispatch.scene_intersect(scene, o, d)
    assert hit.kind is None and hit.prim is None
    assert torch.equal(hit.tri, intersect.intersect_rays(o, d, scene.mesh).tri)


def test_point_light_closed_form_diffuse():
    """``tests/test_pointlights.py``'s closed form on the port alone: a
    floor of albedo (0.6, 0.4, 0.2) under a point light, depth 1, gives
    ``albedo / pi * I * cos / r^2`` at each hit."""
    albedo, l_pos, l_int = (0.6, 0.4, 0.2), (0.5, 3.0, -0.25), (11.0, 7.0,
                                                                 5.0)
    mat = material.Material(color=material.Color.of((0, 0, 0), albedo,
                                                    (0, 0, 0)))
    quad = geometry.quad_triangles([-8, 0, -8], [8, 0, -8], [8, 0, 8],
                                   [-8, 0, 8])
    mesh = geometry.TriangleMesh.build(quad, np.zeros(2, np.int32),
                                       device="cpu")
    scene = tscene.Scene.build(
        mesh, material.MaterialTable.build([mat], device="cpu"),
        camera=[0.0, 5.0, 0.0]).with_point_lights([l_pos], [l_int])
    pts = np.asarray([(0.0, 0.0), (1.5, -2.0), (-3.0, 1.0), (4.0, 4.0)])
    o = np.stack([pts[:, 0], np.full(4, 4.0), pts[:, 1]], -1)
    d = np.tile([0.0, -1.0, 0.0], (4, 1))
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=1)
    rad, _ = pt.trace_paths(scene, cfg, t(o.astype(np.float32)),
                            t(d.astype(np.float32)),
                            torch.zeros((4, 1, rng.NUM_U)))
    hit = np.stack([pts[:, 0], np.zeros(4), pts[:, 1]], -1)
    to_l = np.asarray(l_pos) - hit
    r2 = (to_l ** 2).sum(-1)
    want = (np.asarray(albedo) / np.pi * np.asarray(l_int)
            * (to_l[:, 1] / np.sqrt(r2) / r2)[:, None])
    # the shading point sits eps above the floor: a ~1e-4 shift in r
    np.testing.assert_allclose(rad.numpy(), want, rtol=5e-4)


@pytest.mark.parametrize("name", ["hard_shadow_scene", "point_light_scene"])
def test_preset_tables_match_jax(name):
    js, jcfg = getattr(jpresets, name)(width=8, height=8)
    scene, cfg = getattr(presets, name)(width=8, height=8, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want, got = jax_scene_tables(js), interop.scene_to_numpy(scene)
    assert (got["point_lights"] is None) == (js.point_lights is None)
    for table in ("mesh", "materials", "lights", "point_lights"):
        for k, v in (want.get(table) or {}).items():
            np.testing.assert_array_equal(got[table][k], v,
                                          err_msg=f"{table}.{k}")
    np.testing.assert_array_equal(got["camera"], want["camera"])


def test_interop_round_trip_analytic_point_lights_bvh():
    """``scene_from_numpy(scene_to_numpy(s))`` is ``s`` for a scene with
    analytic primitives, point lights and a BVH, and ``with_bvh`` keeps
    both tables; a hit's ``kind`` and ``prim`` make the round trip."""
    base = analytic_scene(geometry, material, tscene,
                          prim_tables(analytic, device="cpu"), n_theta=6,
                          device="cpu")
    s = base.with_point_lights([[0.0, 3.0, 0.0], [1.0, 2.0, 0.5]],
                               [[5.0, 5.0, 5.0]], diffuse=(0.5, 0.4, 0.3))
    s = s.with_bvh(treelet=True)
    assert s.analytic is base.analytic and s.point_lights is not None
    d = interop.scene_to_numpy(s)
    back = interop.scene_from_numpy(d, device="cpu")
    d2 = interop.scene_to_numpy(back)
    for table in ("mesh", "materials", "lights", "bvh", "analytic",
                  "point_lights"):
        assert d2[table].keys() == d[table].keys(), table
        for k, v in d[table].items():
            np.testing.assert_array_equal(d2[table][k], v,
                                          err_msg=f"{table}.{k}")
    assert back.treelet.T == s.treelet.T
    np.testing.assert_array_equal(d["point_lights"]["diffuse"][1],
                                  np.float32([0.5, 0.4, 0.3]))
    o, dd = random_rays(64, seed=4)
    hit = dispatch.scene_intersect(s, t(o), t(dd))
    h = interop.hit_to_numpy(hit)
    assert set(h) == {"t", "tri", "valid", "kind", "prim"}
    again = interop.hit_to_numpy(interop.hit_from_numpy(**h, device="cpu"))
    for k, v in h.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
