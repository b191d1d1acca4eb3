"""The port's BVH walk and treelet tables against the JAX package on the
CPU: the BVH's fused records, the roped walk, the treelet tables and the
resumable walk (the plain version of the kernels K5 and K5r), the tables'
limits and the vectorised UV sphere.  ``test_torch_treelet_render.py``
holds the drivers, the dispatch and a traced scene, on these cases.

Meshes and rays are ``tests/test_treelet.py``'s random meshes and rays,
made from seeds with numpy.  The JAX side runs its XLA walk compiled with
``CHEAP_COMPILE`` (XLA's lowest backend level, at which it contracts no
multiply-add into an FMA), so the port's walk, written op for op after
JAX's ``_slab`` and ``_mt_single``, agrees with it bitwise in ``valid``,
``tri`` and ``t``.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.accel import bvh as jbvh
from light_transport_tpu.ops.pallas import treelet_kernel as jtk
from light_transport_tpu.scene import geometry as jgeometry
from light_transport_tpu.scene.geometry import TriangleMesh as JMesh
from light_transport_tpu_torch.accel import bvh
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.scene import geometry
from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.material import (
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.scene import Scene

torch.set_num_threads(1)

CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False}
CASES = {40: (96, 32), 500: (300, 64), 2000: (700, 128)}  # tris: rays, T
MAX_DIST = 4.0


def random_tris(t, seed=0, spread=4.0):
    """``tests/test_treelet.random_mesh``'s triangles."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(t, 1, 3))
    return base + rng.normal(scale=0.4, size=(t, 3, 3))


def random_rays(n, seed=1, spread=6.0):
    """``tests/test_treelet.random_rays``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def dead_every_third(n):
    return np.where(np.arange(n) % 3 == 0, -np.inf, np.inf).astype(np.float32)


def assert_hits_equal(got, want):
    for k in ("valid", "tri", "t"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@functools.lru_cache(maxsize=None)
def case(t):
    """Both packages' BVH over one random mesh and JAX's walk of its rays:
    nearest hit with every third lane dead, and any hit before
    ``MAX_DIST``."""
    n, T = CASES[t]
    tris = random_tris(t, seed=t)
    jb, jm = jbvh.build(JMesh.build(tris, np.zeros(t, np.int32)))
    pb, pm = bvh.build(TriangleMesh.build(tris, np.zeros(t, np.int32),
                                          device="cpu"))
    o, d = random_rays(n, seed=t + 1)
    tmax = dead_every_third(n)
    walk = jax.jit(lambda o, d, tm: (
        jbvh.intersect_bvh(o, d, jm, jb, t_max=tm),
        jbvh.occluded_bvh(o, d, jm, jb, jnp.full((o.shape[0],), MAX_DIST))),
        compiler_options=CHEAP_COMPILE)
    hit, occ = walk(o, d, tmax)
    return types.SimpleNamespace(
        t=t, T=T, jb=jb, pb=pb, pm=pm, o=torch.from_numpy(o),
        d=torch.from_numpy(d), tmax=torch.from_numpy(tmax),
        jhit=jax.tree.map(np.asarray, hit), jocc=np.asarray(occ))


@pytest.mark.parametrize("t", sorted(CASES))
def test_bvh_records_match_jax(t):
    c = case(t)
    np.testing.assert_array_equal(c.pb.node_rec.numpy(),
                                  np.asarray(c.jb.node_rec))
    np.testing.assert_array_equal(c.pb.leaf_rec.numpy(),
                                  np.asarray(c.jb.leaf_rec))
    assert c.pb.max_leaf == c.jb.max_leaf
    assert c.pb.num_nodes == c.jb.num_nodes


def test_treelet_tables_match_jax_chunk_sums():
    """The port's tables are the BVH's own float32 records, equal to the
    sums of JAX's three bf16 chunks (as ``test_tables_reconstruct_exactly``
    reads them) on every node; JAX's padding past the last node is
    unreachable (zero boxes, rope M), and the port's walk ends a lane at
    cursor >= M, so it keeps none."""
    c = case(500)
    jtab = jax.jit(jtk.build_treelet_tables, static_argnums=1,
                   compiler_options=CHEAP_COMPILE)(c.jb, c.T)
    tab = tk.build_treelet_tables(c.pb, T=c.T)
    assert tab.node is c.pb.node_rec and tab.leaf is c.pb.leaf_rec
    flat = np.asarray(jtab.tab, np.float32)  # (n_t, 160, T)
    flat = np.moveaxis(flat, 0, 1).reshape(flat.shape[1], -1)
    m, mp = c.pb.num_nodes, flat.shape[1]
    assert tab.node.shape == (m, 16) and tab.num_nodes == m
    assert mp % c.T == 0 and mp > m and tab.n_treelets == jtab.n_treelets

    def s3(r):
        return flat[r] + flat[r + 1] + flat[r + 2]

    node = tab.node.numpy()
    for col in range(6):
        np.testing.assert_array_equal(node[:, col], s3(3 * col)[:m])
        assert not s3(3 * col)[m:].any()
    ints = tab.node[:, 6:9].view(torch.int32).numpy()
    np.testing.assert_array_equal(ints[:, 0], s3(18)[:m].astype(np.int64))
    np.testing.assert_array_equal(ints[:, 1], flat[21, :m].astype(np.int64))
    np.testing.assert_array_equal(ints[:, 2], s3(22)[:m].astype(np.int64))
    assert (s3(22)[m:] == m).all()
    leaf = tab.leaf.numpy()
    for k in range(tab.max_leaf):
        for comp in range(9):
            np.testing.assert_array_equal(
                leaf[:, 9 * k + comp],
                s3(jtk.NODE_ROWS + 27 * k + 3 * comp)[:m])


@pytest.mark.parametrize("t", sorted(CASES))
def test_roped_walk_matches_jax(t):
    """Nearest hit with dead lanes and any hit, bitwise."""
    c = case(t)
    hit = bvh.intersect_bvh(c.o, c.d, c.pm, c.pb, t_max=c.tmax)
    assert_hits_equal(hit, c.jhit)
    assert not hit.valid[c.tmax == -np.inf].any()
    occ = bvh.occluded_bvh(c.o, c.d, c.pm, c.pb, MAX_DIST)
    np.testing.assert_array_equal(occ.numpy(), c.jocc)
    assert 0 < hit.valid.float().mean() and 0 < occ.float().mean() < 1


def test_resume_stops_at_the_treelet_bound():
    """K5r's plain version with ``max_loads = 1`` leaves every unfinished
    lane on the node where it enters its second treelet, and resuming from
    there finishes the walk of one K5 launch: the same hits, the visits
    split between the two launches."""
    c = case(2000)
    tab = tk.build_treelet_tables(c.pb, T=c.T)
    feats, n_pad = tk._make_feats(c.o, c.d, tk.T_EPS, c.tmax, 128)
    perm = torch.arange(n_pad)
    lanes = tk.treelet_resume(feats, tab, perm, tk.Lanes.start(feats), 1)
    cur = lanes.cursor.clone()
    v1 = lanes.visits.clone()
    open_ = cur < tab.num_nodes
    assert open_.any() and (cur[open_] // tab.T > 0).all()
    lanes = tk.treelet_resume(feats, tab, perm, lanes, 0)
    want = tk.treelet_walk(feats, tab)
    assert torch.equal(lanes.best_t, want[0])
    assert torch.equal(lanes.best_tri, want[1])
    assert torch.equal(lanes.visits, want[2])
    assert (lanes.visits >= v1).all() and (lanes.visits > v1)[open_].all()


def small_scene(t=400, seed=21):
    mats = MaterialTable.build([Material(color=presets.WHITE_2)],
                               device="cpu")
    mesh = TriangleMesh.build(random_tris(t, seed=seed),
                              np.zeros(t, np.int32), device="cpu")
    return Scene.build(mesh, mats, camera=np.zeros(3))


def test_treelet_tables_reject_what_jax_rejects():
    walk = small_scene(t=40).with_bvh(treelet=False)
    with pytest.raises(ValueError, match="max_leaf"):
        tk.build_treelet_tables(dataclasses.replace(walk.bvh, max_leaf=5))
    with pytest.raises(ValueError, match="requires with_bvh"):
        small_scene(t=40).with_treelet()


def test_uv_sphere_matches_jax():
    for kw in (dict(), dict(center=(0, -4.5, 0), radius=2.9, n_theta=31,
                            n_phi=29)):
        np.testing.assert_array_equal(geometry.uv_sphere_triangles(**kw),
                                      jgeometry.uv_sphere_triangles(**kw))
