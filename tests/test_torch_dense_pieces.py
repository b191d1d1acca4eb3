"""K3's launch in plain form (``intersect_dense_keys_reference``: the cull
inside the launch, 128-triangle pieces, each piece's nearest hit and the
64-bit key merge) against the sequential scan on JAX's operands
(``intersect_dense_reference`` behind ``tile_cluster_mask``), which
``tests/test_torch_intersect_kernel.py`` holds against JAX's K3.

Plain torch, no JAX.  Meshes: spheres of 1 and 2 clusters and the
15-cluster soft-shadow layout (a 7,568-triangle sphere, a floor and a
2-triangle light: 7,572 triangles, the top of K3's range).  Rays: 1,000
(not a multiple of 128): incoherent rays, and for the 15-cluster layout
camera rays (coherent tiles, so the cull rejects pairs); every 7th lane
inactive (t_max = -inf), some with zero direction components (the slab
test's 1e-20 guard).  Everything is held bitwise: t and triangle of every ray,
the any-hit mask, and the keys with and without the cull.
"""

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.scene.cornell import sphere_triangles
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

torch.set_num_threads(1)

N_RAYS = 1000
MAX_DIST = 2.0


def sphere(n_theta, n_phi, center=(0, 0, 0)):
    return sphere_triangles(center=center, radius=1.5, n_theta=n_theta,
                            n_phi=n_phi)


def soft_shadow_15():
    """The soft-shadow layout with its sphere at n_theta=44, n_phi=88."""
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    light = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                           (-1.5, 6, 1.5))
    return np.concatenate([sphere(44, 88, (0, 1, 0)), floor, light])


MESHES = {"1_cluster": lambda: sphere(8, 16),
          "2_clusters": lambda: sphere(30, 16),
          "15_clusters": soft_shadow_15}


def rays(seed, n=N_RAYS, lo=(-2, -2, -2), hi=(2, 2, 2), camera=False):
    """Incoherent rays from the box lo-hi, or with ``camera`` a 40-wide
    pinhole grid from (0, 1, 7) in row order, jittered."""
    rng = np.random.default_rng(seed)
    if camera:
        o = np.tile(np.float32([0.0, 1.0, 7.0]), (n, 1))
        i = np.arange(n)
        px = (i % 40 + rng.uniform(size=n)) / 40 - 0.5
        py = 0.5 - (i // 40 + rng.uniform(size=n)) / 40
        d = np.stack([0.9 * px, 0.9 * py, -np.ones(n)], -1).astype(np.float32)
    else:
        o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::13, 0] = 0.0
    d[5::17, 1] = -0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.ones(n, bool)
    active[::7] = False
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active)


def operands(tris, o, d, t_hi):
    """K3's operands as intersect_rays_pallas pads them: features and
    intervals of whole 128-ray tiles, the weights, records and boxes."""
    m = TriangleMesh.build(tris, np.zeros(len(tris), np.int32), device="cpu")
    n = o.shape[0]
    n_pad = -(-n // ik.RAY_TILE) * ik.RAY_TILE
    feats = torch.cat([ik.ray_features(o, d), torch.zeros((n_pad - n, 16))])
    tmm = torch.cat([torch.stack([torch.full((n,), 1e-5), t_hi], -1),
                     torch.zeros((n_pad - n, 2))])
    w = ik.pack_tri_weights(m)
    return m, feats, tmm, w, ik.cluster_records(w), ik.cluster_bounds(m)


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    tris = MESHES[request.param]()
    o, d, active = rays(sum(map(ord, request.param)),
                        camera=request.param == "15_clusters")
    t_hi = torch.where(active, float("inf"), float("-inf"))
    m, feats, tmm, w, recs, (c_lo, c_hi) = operands(tris, o, d, t_hi)
    mask = ik.tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tmm, c_lo,
                                c_hi)
    return dict(name=request.param, m=m, o=o, d=d, active=active,
                feats=feats, tmm=tmm, w=w, recs=recs, c_lo=c_lo, c_hi=c_hi,
                mask=mask,
                scan=ik.intersect_dense_reference(
                    feats, tmm, ik.cluster_weights(w), mask))


def test_cull_only_skips_work(case):
    """The launch's cull rejects pairs (on the 15-cluster layout's
    coherent tiles) and only pairs without a hit: its keys equal those
    of a launch whose unbounded boxes admit every pair, and the pairs it
    admits are tile_cluster_mask's, which the sequential scan reads."""
    c = case["w"].shape[2] // ik.TRI_TILE
    assert c == {"1_cluster": 1, "2_clusters": 2, "15_clusters": 15}[
        case["name"]] and c < ik.GATHER_MIN_CLUSTERS
    if case["name"] == "15_clusters":
        assert case["mask"].any() and not case["mask"].all()
    keys = ik.intersect_dense_keys(case["feats"], case["tmm"], case["recs"],
                                   case["c_lo"], case["c_hi"])
    inf = torch.full_like(case["c_lo"], float("inf"))
    assert ik.tile_cluster_mask(case["feats"][:, 6:9], case["feats"][:, 0:3],
                                case["tmm"], -inf, inf).all()
    assert torch.equal(keys, ik.intersect_dense_keys(
        case["feats"], case["tmm"], case["recs"], -inf, inf))


def test_pieces_equal_the_scan(case):
    """Nearest hit: the pieces' keys, unpacked, are the sequential scan's
    t and triangle bitwise, inactive and padding lanes without a hit; and
    intersect_rays_pallas over the unpadded rays gives the same hits."""
    want_t, want_tri = case["scan"]
    keys = ik.intersect_dense_keys(case["feats"], case["tmm"], case["recs"],
                                   case["c_lo"], case["c_hi"])
    t, tri = ik.unpack_hit_keys(keys)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(tri, want_tri)
    hit = want_tri >= 0
    assert 0.05 < hit.float().mean() < 0.95
    assert not hit[:N_RAYS][~case["active"]].any() and not hit[N_RAYS:].any()
    t_hi = torch.where(case["active"], float("inf"), float("-inf"))
    h = ik.intersect_rays_pallas(case["o"], case["d"], case["m"], t_max=t_hi)
    assert torch.equal(h.valid, hit[:N_RAYS])
    assert torch.equal(h.tri[h.valid], want_tri[:N_RAYS][h.valid])
    assert torch.equal(h.t[h.valid], want_t[:N_RAYS][h.valid])


def test_any_hit_mask_equals_the_scan():
    """Any hit against per-ray distances on the 15-cluster layout: the
    mask is the scan's hit mask over the same intervals."""
    tris = soft_shadow_15()
    o, d, active = rays(7, lo=(-2, -0.5, -2), hi=(2, 3, 2))
    md = torch.from_numpy(np.random.default_rng(8).uniform(
        0.1, MAX_DIST, N_RAYS).astype(np.float32))
    t_hi = torch.where(active, md, float("-inf"))
    m, feats, tmm, w, recs, (c_lo, c_hi) = operands(tris, o, d, t_hi)
    mask = ik.tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tmm, c_lo,
                                c_hi)
    _, want_tri = ik.intersect_dense_reference(feats, tmm,
                                               ik.cluster_weights(w), mask)
    occ = ik.intersect_rays_pallas(o, d, m, any_hit=True, max_dist=t_hi)
    assert torch.equal(occ, want_tri[:N_RAYS] >= 0)
    assert 0.05 < occ.float().mean() < 0.95 and not occ[~active].any()


def test_exact_ties_across_pieces_and_clusters():
    """Eight copies of one 128-triangle piece (two clusters of four
    pieces): every hit ties exactly across pieces and clusters, and the
    merge keeps the first copy's triangle, as the scan does."""
    tris = sphere(9, 8)
    assert len(tris) == ik.PIECE_TRIS
    o, d, active = rays(3, n=640)
    t_hi = torch.where(active, float("inf"), float("-inf"))
    _, feats, tmm, w, recs, (c_lo, c_hi) = operands(np.tile(tris, (8, 1, 1)),
                                                    o, d, t_hi)
    mask = ik.tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tmm, c_lo,
                                c_hi)
    assert mask.all()
    want_t, want_tri = ik.intersect_dense_reference(
        feats, tmm, ik.cluster_weights(w), mask)
    t, tri = ik.unpack_hit_keys(ik.intersect_dense_keys(feats, tmm, recs,
                                                        c_lo, c_hi))
    hit = want_tri >= 0
    assert hit.sum() > 100 and (want_tri[hit] < ik.PIECE_TRIS).all()
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(tri, want_tri)


def test_every_cluster_mesh_gets_records():
    """The mesh's cluster tables hold the triangle-major records for a
    mesh below 16 clusters too (K3 reads them), and K4's group boxes,
    built once per mesh."""
    tris = sphere(8, 16)
    m = TriangleMesh.build(tris, np.zeros(len(tris), np.int32), device="cpu")
    scene = Scene.build(m, MaterialTable.build(
        [Material(color=presets.GREY)], device="cpu"), camera=[0, 0, 5])
    tab = ik.cluster_tables(scene.mesh)
    recs = tab.records
    assert torch.equal(recs, ik.cluster_records(tab.tri_weights))
    assert all(torch.equal(a, b) for a, b in zip(
        tab.groups, ik.cluster_group_bounds(m)))
    assert recs.shape == (1, ik.TRI_TILE, ik.REC_FLOATS)
    assert ik.cluster_tables(scene.mesh).records is recs
