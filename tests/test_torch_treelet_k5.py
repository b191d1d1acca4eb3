"""K5's 32-byte node records and the big-mesh route on the CPU, in plain
torch: the records decode to the fused 64-byte records bit for bit, the
plain walk read through them equals the roped walk over the fused records
bitwise (t, triangle, per-ray visits; nearest and any hit; dead and
padding lanes), the BVH carries them into every table that reads it, and
the sort's scene bounds are computed once per mesh.  The dispatch's two
routes (``TREELET_WAVEFRONT``) are held against the roped walk in
``tests/test_torch_treelet_render.py``.

The mesh and rays are ``tests/test_torch_treelet_perm.py``'s: 2,000 random
triangles from a numpy seed, cut into treelets of 64 nodes, 700 rays
(every third one dead, padded to tiles of 256 lanes).
"""

import functools

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.accel import bvh
from light_transport_tpu_torch.ops import raysort
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.scene.geometry import TriangleMesh
from light_transport_tpu_torch.scene.material import (
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.scene import Scene
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

N_TRIS, N_RAYS, T, R = 2000, 700, 64, 256
MAX_DIST = 4.0
MODES = {"nearest": False, "any hit": True}


def tris_and_rays():
    rng = np.random.default_rng(N_TRIS)
    base = rng.uniform(-4.0, 4.0, size=(N_TRIS, 1, 3))
    tris = base + rng.normal(scale=0.4, size=(N_TRIS, 3, 3))
    rng = np.random.default_rng(N_TRIS + 1)
    o = rng.uniform(-6.0, 6.0, size=(N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dead = np.arange(N_RAYS) % 3 == 0
    return tris, torch.from_numpy(o), torch.from_numpy(d), \
        torch.from_numpy(dead)


@functools.lru_cache(maxsize=None)
def scene():
    tris, o, d, dead = tris_and_rays()
    mesh = TriangleMesh.build(tris, np.zeros(N_TRIS, np.int32), device="cpu")
    b, mesh = bvh.build(mesh)
    return mesh, b, tk.build_treelet_tables(b, T=T), o, d, dead


@functools.lru_cache(maxsize=None)
def render_scene():
    """The same triangles as a Scene with a BVH and treelet tables."""
    tris, *_ = tris_and_rays()
    mats = MaterialTable.build([Material(color=presets.WHITE_2)],
                               device="cpu")
    mesh = TriangleMesh.build(tris, np.zeros(N_TRIS, np.int32), device="cpu")
    timings = {}
    walk = Scene.build(mesh, mats, camera=np.zeros(3)).with_bvh(
        treelet=False, timings=timings)
    return walk, walk.with_treelet(T=T), timings


def t_max(any_hit):
    *_, dead = scene()
    return torch.where(dead, float("-inf"), MAX_DIST if any_hit
                       else float("inf"))


def feats_of(any_hit):
    _, _, tab, o, d, _ = scene()
    feats, n_pad = tk._make_feats(o, d, tk.T_EPS, t_max(any_hit), R)
    assert n_pad == 768 and n_pad > N_RAYS  # padding lanes included
    return feats


def walk(node_rec, feats, any_hit):
    _, b, *_ = scene()
    lanes = tk.Lanes.start(feats)
    return bvh.roped_walk(node_rec, b.leaf_rec, b.num_nodes, b.max_leaf,
                          feats[0:3].T, feats[3:6].T, feats[6:9].T, feats[9],
                          lanes.cursor, lanes.best_t, lanes.best_tri,
                          any_hit=any_hit)


def test_node_records32_decode_bit_for_bit():
    """Each 32-byte record holds the fused record's box floats, skip,
    first and count bit for bit, read back by ``node_fields`` from either
    layout."""
    _, b, tab, *_ = scene()
    m = b.num_nodes
    rec = tab.node32
    assert rec.shape == (m, 8) and rec.dtype == torch.float32
    assert torch.equal(rec, bvh.node_records32(b.node_rec))
    got = bvh.node_fields(rec)
    want = bvh.node_fields(b.node_rec)
    for name, g, w in zip(("lo", "hi", "first", "count", "skip"), got,
                          want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    ints = b.node_rec[:, 6:9].view(torch.int32)
    assert torch.equal(got[2], ints[:, 0]) and torch.equal(got[3], b.count)
    assert torch.equal(got[4], b.skip)
    assert torch.equal(rec[:, 0:6].view(torch.int32),
                       b.node_rec[:, 0:6].view(torch.int32))
    leaf = b.count > 0
    assert leaf.any() and (~leaf).any() and int(b.count.max()) <= 4


def test_node_records32_pack_edge_values():
    """The packed word keeps every ``first`` below 2^24 and ``count`` up to
    7, negative ``first`` included (arithmetic shift)."""
    first = torch.tensor([0, 1, (1 << 24) - 1, -1, 12345], dtype=torch.int32)
    count = torch.tensor([0, 4, 7, 0, 3], dtype=torch.int32)
    skip = torch.tensor([5, 2, 9, 1 << 23, 3], dtype=torch.int32)
    node_rec = torch.zeros((5, 16))
    node_rec[:, 0:6] = torch.randn((5, 6), generator=torch.Generator()
                                   .manual_seed(3))
    node_rec[:, 6:9] = torch.stack([first, count, skip], 1).view(
        torch.float32)
    _, _, f, c, s = bvh.node_fields(bvh.node_records32(node_rec))
    assert torch.equal(f, first) and torch.equal(c, count)
    assert torch.equal(s, skip)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_walk_through_node32_matches_roped_walk(mode):
    """The plain walk over the 32-byte records (K5's plain version,
    ``treelet_walk`` on CPU tensors) equals the roped walk over the fused
    records bitwise in cursor, best_t, best_tri and visits, the dead and
    padding lanes dying at the root after one visit."""
    any_hit = MODES[mode]
    _, b, tab, _, _, dead = scene()
    feats = feats_of(any_hit)
    want = walk(b.node_rec, feats, any_hit)
    got = walk(tab.node32, feats, any_hit)
    for name, g, w in zip(("cursor", "best_t", "best_tri", "visits"), got,
                          want):
        assert torch.equal(g, w), (name, int((g != w).sum()))
    best_t, best_tri, visits = tk.treelet_walk(feats, tab, any_hit)
    assert torch.equal(best_t, want[1]) and torch.equal(best_tri, want[2])
    assert torch.equal(visits, want[3])
    idle = torch.cat([dead, torch.ones(feats.shape[1] - N_RAYS,
                                       dtype=torch.bool)])
    assert (visits[idle] == 1).all() and (best_tri[idle] == -1).all()
    assert (best_tri[~idle] >= 0).any() and (visits[~idle] > 1).any()


def test_bvh_carries_node32():
    """``accel.bvh.build`` makes the 32-byte records with the fused ones
    and times them with them; ``TreeletTables.of`` (the dispatch's tables
    for a BVH without treelet tables) and ``with_treelet`` hand on the
    BVH's own tensors, and the JAX tables' import builds the same
    records."""
    walk_scene, tabled, timings = render_scene()
    b = walk_scene.bvh
    assert torch.equal(b.node32, bvh.node_records32(b.node_rec))
    assert tk.TreeletTables.of(b).node32 is b.node32
    assert tabled.treelet.node32 is b.node32
    assert tabled.treelet.node is b.node_rec
    assert set(timings) == {"build_s", "skip_s", "records_s"}
    got = interop.scene_from_numpy(interop.scene_to_numpy(walk_scene),
                                   device="cpu")
    assert torch.equal(got.bvh.node32, b.node32)


def test_scene_bounds_computed_once_per_mesh():
    """``sorted_apply`` reads the mesh's bounds from ``mesh.derived`` after
    the first call; they equal the direct computation, so the sort keys and
    the permutation are those of before."""
    tris, o, d, _ = tris_and_rays()
    mesh = TriangleMesh.build(tris, np.zeros(N_TRIS, np.int32), device="cpu")
    lo, hi = raysort.scene_bounds(mesh)
    v = torch.stack([mesh.v0, mesh.v0 + mesh.e1, mesh.v0 + mesh.e2])
    assert torch.equal(lo, v.amin(dim=(0, 1)) - 0.1)
    assert torch.equal(hi, v.amax(dim=(0, 1)) + 0.1)
    assert raysort.scene_bounds(mesh)[0] is lo
    n = raysort.MIN_SORT_LANES + 7
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    ids = torch.arange(n)
    seen = raysort.sorted_apply(lambda o_, d_, i_: i_, mesh, o, d, ids)
    assert torch.equal(seen, ids)  # un-permuted
    # each lane's place in the sorted order, as the cached bounds sort it
    order = raysort.sorted_apply(lambda o_, d_, i_: torch.arange(n), mesh,
                                 o, d, ids)
    key = raysort.ray_sort_key(o, d, lo, hi)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n)
    assert torch.equal(order, inv)
