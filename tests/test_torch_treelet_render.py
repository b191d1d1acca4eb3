"""The big-mesh render path's drivers and wiring against the JAX package
on the CPU: every plain treelet driver against the roped walk and JAX's
interpret-mode K5, the dispatch past ``MXU_MAX_TRIS``, the ``glass``
preset traced through the treelet path, and the ``with_bvh`` policy.

The cases, meshes and rays are ``tests/test_torch_treelet.py``'s; the JAX
side is compiled with the same ``CHEAP_COMPILE`` options, so the plain
walk agrees with JAX's bitwise.  The glass trace is held to the render
tests' tolerance (rtol 1e-4 on >= 99 % of lanes): XLA's CPU sqrt rounds
apart from torch in the shading; its triangle records are held exactly
up to ties between coplanar triangles.
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
from light_transport_tpu_torch.ops import dispatch, intersect
from light_transport_tpu_torch.ops.intersect import T_EPS
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

# the most the two hits of a coplanar tie may differ in t, in float32 ulps
TIE_ULPS = 8


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
    the treelet drivers (tables of 64 nodes: the dispatch's default route,
    one K5 launch a query), JAX's through its XLA roped walk, from the
    same uniforms and the same camera rays.  Radiance is held to the
    render tests' tolerance.  The triangle records are held exactly up to
    ties: the glass scene has coplanar triangles of opposite facing that
    overlap, and a ray through such a pair hits both at one point, so
    once the shading before it rounded the two sides' rays apart (by an
    ulp) they may pick different ones.  At each lane's first record
    whose triangle differs, the two triangles must lie in one plane, the
    port's ray of that bounce must hit both within ``TIE_ULPS`` of each
    other, the port's pick must be the nearer (the lower index on equal
    t), and the record's other fields must equal JAX's bitwise; the
    lane's later records follow from its pick."""
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
    o, dd = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    rad, rec = pt.trace_paths(scene, cfg, o, dd, un)
    # one K5 launch for each of the three bounces' nearest-hit and
    # shadow queries; no K5r
    assert calls == {"treelet_walk": 6, "treelet_resume": 0}
    close = np.isclose(rad.numpy(), np.asarray(jrad), rtol=1e-4,
                       atol=1e-6).all(1)
    assert close.mean() >= 0.99, close.mean()
    assert rad.numpy().mean() > 0.01

    # the port's ray of every bounce, from trace_paths's own bounce loop
    state, rays = pt.PathState.initial(o, dd), []
    for b in range(cfg.max_depth):
        rays.append((state.origin, state.direction))
        state = pt._bounce(scene, cfg, state, un[:, b], b, coherent=b == 0)[0]
    assert torch.equal(state.radiance, rad)
    ptri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    differ = ptri != jtri
    lanes = np.nonzero(differ.any(1))[0]
    m, verts = scene.mesh, scene.mesh.vertices()
    ties = 0
    for lane in lanes:
        b = int(np.argmax(differ[lane]))
        pair = (int(ptri[lane, b]), int(jtri[lane, b]))
        assert min(pair) >= 0, (lane, b, pair)
        ro, rd = (x[lane:lane + 1] for x in rays[b])
        t, hit = zip(*(
            (float(t_[0, 0]), bool(v_[0, 0])) for t_, v_ in (
                intersect._mt_tile(ro, rd, m.v0[k:k + 1], m.e1[k:k + 1],
                                   m.e2[k:k + 1], torch.tensor([T_EPS]),
                                   torch.tensor([np.inf]))
                for k in pair)))
        nrm = np.cross(verts[pair[0], 1] - verts[pair[0], 0],
                       verts[pair[0], 2] - verts[pair[0], 0])
        nrm /= np.linalg.norm(nrm)
        off = np.abs((verts[pair[1]] - verts[pair[0], 0]) @ nrm).max()
        assert off < 1e-9, (lane, b, pair, off)  # one plane
        assert all(hit), (lane, b, pair, t)
        ulps = abs(t[0] - t[1]) / np.spacing(np.float32(max(t)))
        assert ulps <= TIE_ULPS, (lane, b, pair, t)
        assert (t[0], pair[0]) < (t[1], pair[1]), (lane, b, pair, t)
        for f in ("log_pdf", "alive", "direct", "incident"):
            np.testing.assert_array_equal(
                getattr(rec, f).numpy()[lane, b],
                np.asarray(getattr(jrec, f))[lane, b], err_msg=f)
        ties += 1
    print(f"glass through treelets: radiance lanes within rtol 1e-4 "
          f"{close.mean():.4f}; of {differ.size} records {differ.sum()} "
          f"differ in triangle, in {len(lanes)} lanes, whose first "
          f"differing records are {ties} coplanar ties")


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
            device=torch.device(device), watertight=False,
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


