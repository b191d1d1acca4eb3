"""The big-mesh render path's drivers and wiring against the JAX package
on the CPU: every plain treelet driver against the roped walk and JAX's
interpret-mode K5, the dispatch past ``MXU_MAX_TRIS``, the ``glass``
preset traced through the treelet path, and the ``with_bvh`` policy.

The cases, meshes and rays are ``tests/test_torch_treelet.py``'s; the JAX
side is compiled with the same ``CHEAP_COMPILE`` options, so the plain
walk agrees with JAX's bitwise.  The glass trace is held to the render
tests' tolerance (rtol 1e-4 on >= 99 % of lanes): XLA's CPU sqrt rounds
apart from torch in the shading.
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.core import rng as jrng
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import dispatch as jdispatch
from light_transport_tpu.ops.pallas import treelet_kernel as jtk
from light_transport_tpu_torch.accel import bvh
from light_transport_tpu_torch.core.config import RenderConfig
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.scene import geometry
from light_transport_tpu_torch.scene import scene as scene_mod
from light_transport_tpu_torch.utils import interop
from test_torch_treelet import (
    CHEAP_COMPILE,
    MAX_DIST,
    assert_hits_equal,
    case,
    random_rays,
    small_scene,
)

torch.set_num_threads(1)


DRIVERS = {
    "single": tk.intersect_bvh_treelet,
    "wavefront0": functools.partial(tk.intersect_bvh_treelet_wavefront,
                                    max_passes=0),
    "wavefront2": functools.partial(tk.intersect_bvh_treelet_wavefront,
                                    max_passes=2),
    "wavefront12": functools.partial(tk.intersect_bvh_treelet_wavefront,
                                     max_passes=12),
    "queued": functools.partial(tk.intersect_bvh_treelet_queued,
                                loads_per_pass=2, passes_per_sync=2),
}


@functools.lru_cache(maxsize=None)
def jax_visits():
    """Per-ray node visits of JAX's interpret-mode K5 on the 500-triangle
    case."""
    c = case(500)
    tables = jtk.build_treelet_tables(c.jb, T=c.T)
    _, stats = jax.jit(lambda o, d, tm: jtk.intersect_bvh_treelet(
        o, d, tables, t_max=tm, ray_tile=128, interpret=True,
        with_stats=True), compiler_options=CHEAP_COMPILE)(
        c.o.numpy(), c.d.numpy(), c.tmax.numpy())
    return np.asarray(stats["visits"])


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_treelet_drivers_match_walk(driver):
    """Every plain treelet driver equals the roped walk bitwise, nearest
    and any hit, and its per-ray visits equal JAX's K5's: a schedule
    changes no lane's walk."""
    c = case(500)
    tab = tk.build_treelet_tables(c.pb, T=c.T)
    fn = DRIVERS[driver]
    hit, stats = fn(c.o, c.d, tab, t_max=c.tmax, with_stats=True)
    assert_hits_equal(hit, c.jhit)
    np.testing.assert_array_equal(stats["visits"].numpy(), jax_visits())
    assert (stats["visits"][c.tmax == -np.inf] == 1).all()
    occ = fn(c.o, c.d, tab, t_max=MAX_DIST, any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), c.jocc)


@pytest.mark.parametrize("wavefront", [False, True])
def test_dispatch_routes_treelet(monkeypatch, wavefront):
    """Past the cap (patched below a 400-triangle mesh), a scene with a
    BVH answers through the treelet wrappers bitwise as the roped walk
    does: without tables one K5 per query; with tables coherent camera
    rays take K5, the rest K5r (or K5 with the wavefront off)."""
    monkeypatch.setattr(dispatch, "MXU_MAX_TRIS", 100)
    monkeypatch.setattr(dispatch, "TREELET_WAVEFRONT", wavefront)
    walk = small_scene().with_bvh(treelet=False)
    assert walk.treelet is None
    tabled = walk.with_treelet(T=64)
    o, d = (torch.from_numpy(a) for a in random_rays(300, seed=22))
    active = torch.arange(300) % 5 != 0
    ref_hit = bvh.intersect_bvh(o, d, walk.mesh, walk.bvh,
                                t_max=dispatch._t_max(o, active))
    ref_occ = bvh.occluded_bvh(o, d, walk.mesh, walk.bvh,
                               dispatch._t_max(o, active, 3.0))
    calls = {"treelet_walk": 0, "treelet_resume": 0}
    for name in calls:
        def spy(*a, _name=name, _fn=getattr(tk, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tk, name, spy)
    assert_hits_equal(dispatch.scene_intersect(walk, o, d, active=active),
                      ref_hit)
    np.testing.assert_array_equal(
        dispatch.scene_occluded(walk, o, d, 3.0, active=active).numpy(),
        ref_occ.numpy())
    assert calls == {"treelet_walk": 2, "treelet_resume": 0}
    calls["treelet_walk"] = 0
    assert_hits_equal(dispatch.scene_intersect(tabled, o, d, active=active),
                      ref_hit)
    np.testing.assert_array_equal(
        dispatch.scene_occluded(tabled, o, d, 3.0, active=active).numpy(),
        ref_occ.numpy())
    assert (calls["treelet_resume"] > 0) == wavefront
    assert calls["treelet_walk"] == (0 if wavefront else 2)
    calls["treelet_walk"] = 0
    assert_hits_equal(dispatch.scene_intersect(tabled, o, d, active=active,
                                               coherent=True), ref_hit)
    assert calls["treelet_walk"] == 1
    assert not ref_hit.valid[~active].any() and ref_hit.valid.any()
    assert not ref_occ[~active].any() and ref_occ.any()


def test_glass_slice_through_treelets(monkeypatch):
    """The ``glass`` preset (414 triangles, 16x16x2, depth 3) with the cap
    patched below its mesh on both sides: the port's trace goes through
    the treelet drivers (tables of 64 nodes: one K5 launch for the camera
    rays, the K5r wavefront for the rest), JAX's through its XLA roped
    walk, from the same uniforms and the same camera rays.  Both walk the
    BVH in the same order, so an exact tie on the glass's coplanar walls
    goes the same way on both sides unless the shading before it rounded
    apart: the triangle records are held on all records, ties included.
    (The port's own camera rays differ from JAX's by up to 2 ulps,
    ``tests/test_torch_render.py``; enough to flip such ties on 3.8 % of
    the records.)"""
    monkeypatch.setattr(jdispatch, "MXU_MAX_TRIS", 400)
    monkeypatch.setattr(dispatch, "MXU_MAX_TRIS", 400)
    js, jcfg = jpresets.glass_scene(16, 16, 2, 3)
    d = {"mesh": {k: np.asarray(getattr(js.mesh, k))
                  for k in geometry.MESH_FIELDS},
         "materials": {k: np.asarray(getattr(js.materials, k))
                       for k in interop.MATERIAL_FIELDS},
         "lights": {k: np.asarray(getattr(js.lights, k))
                    for k in interop.LIGHT_FIELDS},
         "camera": np.asarray(js.camera),
         "bvh": {k: np.asarray(getattr(js.bvh, k))
                 for k in interop.BVH_FIELDS}}
    scene = interop.scene_from_numpy(d, device="cpu").with_treelet(T=64)
    assert scene.mesh.num_triangles == 414 and scene.treelet is not None
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    n = jcfg.height * jcfg.width * jcfg.spp
    k_aa, k_u = jax.random.split(jax.random.key(7))
    u_aa = np.asarray(jax.random.uniform(k_aa, (n, 2)))
    uni = np.asarray(jrng.path_uniforms(k_u, n, jcfg.max_depth))

    def jax_side(js, u_aa, uni):
        o, dd = jpt.camera_rays(js, jcfg, u_aa)
        return (o, dd) + tuple(jpt.trace_paths(js, jcfg, o, dd, uni))

    jo, jd, jrad, jrec = jax.jit(jax_side, compiler_options=CHEAP_COMPILE)(
        js, u_aa, uni)
    un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")[1]
    calls = {"treelet_walk": 0, "treelet_resume": 0}
    for name in calls:
        def spy(*a, _name=name, _fn=getattr(tk, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tk, name, spy)
    rad, rec = pt.trace_paths(scene, cfg, torch.tensor(np.asarray(jo)),
                              torch.tensor(np.asarray(jd)), un)
    # one K5 launch for the camera rays; every other query on K5r
    assert calls["treelet_walk"] == 1 and calls["treelet_resume"] >= 5
    close = np.isclose(rad.numpy(), np.asarray(jrad), rtol=1e-4,
                       atol=1e-6).all(1)
    same_tri = (rec.tri.numpy() == np.asarray(jrec.tri)).mean()
    print(f"glass through treelets: radiance lanes within rtol 1e-4 "
          f"{close.mean():.4f}, same triangle on {same_tri:.4f} of all "
          "records")
    assert close.mean() >= 0.99, close.mean()
    assert same_tri >= 0.99, same_tri
    assert rad.numpy().mean() > 0.01


def test_with_bvh_auto_treelet_policy():
    """``with_bvh(treelet="auto")`` attaches tables exactly when the
    dispatch would use them: on the card, past the crossover, within the
    format; ``True`` forces them, ``False`` opts out."""
    assert scene_mod.TREELET_AUTO_MIN_TRIS == dispatch.MXU_MAX_TRIS
    base = small_scene()
    assert base.with_bvh().treelet is None  # the CPU: auto never attaches
    forced = base.with_bvh(treelet=True)
    assert forced.treelet is not None
    assert forced.treelet.T == tk.DEFAULT_T
    assert base.with_bvh(treelet=False).treelet is None

    def fake(device, tris):
        return types.SimpleNamespace(
            device=torch.device(device),
            mesh=types.SimpleNamespace(num_triangles=tris))

    big = scene_mod.TREELET_AUTO_MIN_TRIS + 1
    assert scene_mod._auto_treelet(fake("cuda", big))
    assert not scene_mod._auto_treelet(fake("cpu", big))
    assert not scene_mod._auto_treelet(
        fake("cuda", scene_mod.TREELET_AUTO_MIN_TRIS))
    assert not scene_mod._auto_treelet(fake("cuda", 1 << 24))
    # the tables and records survive the interop round trip
    d = interop.scene_to_numpy(forced)
    back = interop.scene_from_numpy(d, device="cpu")
    assert back.bvh.max_leaf == forced.bvh.max_leaf
    assert (back.treelet.T, back.treelet.num_nodes, back.treelet.max_leaf) \
        == (forced.treelet.T, forced.treelet.num_nodes,
            forced.treelet.max_leaf)
    assert back.treelet.node is back.bvh.node_rec
    again = interop.scene_to_numpy(back)
    for table in ("bvh", "treelet"):
        for k, v in d[table].items():
            np.testing.assert_array_equal(again[table][k], v, err_msg=k)


