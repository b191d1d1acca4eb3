"""The port's cluster-culled intersector (the plain versions of K3 and K4)
against the JAX package's ``intersect_rays_pallas``, its Pallas kernels
run in TPU interpret mode on the CPU, and the port's coherence sort
against JAX's.

Meshes: a 224-triangle sphere (one cluster: the dense kernel K3) and a
9,024-triangle sphere (18 clusters: the gather kernel K4).  Rays: 512
incoherent interior rays, every 7th lane inactive (``t_max = -inf``).

Tolerances are the JAX package's own TPU test's
(tests/test_pallas_engine.py): ``valid`` and any-hit equal; t within
rtol 1e-5, atol 1e-6 where both hit; the triangle equal on >= 99 % of
those rays.  The weights, cluster bounds, cull mask and sort keys are
held bitwise.

K4's schedule in plain form is held bitwise to the sequential scan: the
triangle-major records to the weights, the 64-bit hit keys to the
(t, index) order, and the chunked split and key merge to
``intersect_gather_reference``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from light_transport_tpu.ops import raysort as jraysort
from light_transport_tpu.ops.pallas import intersect_kernel as jik
from light_transport_tpu.scene.cornell import sphere_triangles
from light_transport_tpu.scene.geometry import TriangleMesh as JMesh
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.ops import raysort
from light_transport_tpu_torch.ops.dispatch import (
    scene_intersect,
    scene_occluded,
)
from light_transport_tpu_torch.scene.geometry import TriangleMesh

torch.set_num_threads(1)

# XLA's lowest backend level and its classic CPU emitters: the
# interpret-mode kernels compile in a quarter of the eager time
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False}
N_RAYS = 512
MESHES = {"dense_1_cluster": (8, 16), "gather_18_clusters": (48, 96)}
MAX_DIST = 2.0


def rays(seed=11, n=N_RAYS):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.ones(n, bool)
    active[::7] = False
    return o, d, active


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    n_theta, n_phi = MESHES[request.param]
    tris = sphere_triangles(center=(0, 0, 0), radius=1.5, n_theta=n_theta,
                            n_phi=n_phi)
    jm = JMesh.build(tris, np.zeros(len(tris), np.int32))
    m = TriangleMesh.build(tris, np.zeros(len(tris), np.int32), device="cpu")
    o, d, active = rays()
    tmax = np.where(active, np.inf, -np.inf).astype(np.float32)
    md = np.where(active, MAX_DIST, -np.inf).astype(np.float32)
    # the tables once, eagerly (the bitwise tests read them), then both
    # queries in one compile each
    jw, jcl = jik.pack_tri_weights(jm), jik.cluster_bounds(jm)

    def queries(o, d, tmax, md, w, cl):
        hit = jik.intersect_rays_pallas(o, d, jm, tri_weights=w, clusters=cl,
                                        t_max=tmax)
        occ = jik.intersect_rays_pallas(o, d, jm, tri_weights=w, clusters=cl,
                                        any_hit=True, max_dist=md)
        return hit[:3], occ

    with pltpu.force_tpu_interpret_mode():
        hit, occ = jax.jit(queries, compiler_options=CHEAP_COMPILE)(
            *(jnp.asarray(a) for a in (o, d, tmax, md)), jw, jcl)
    return dict(
        name=request.param, jm=jm, jw=np.asarray(jw),
        jcl=[np.asarray(x) for x in jcl], m=m, o=o, d=d, active=active,
        tmax=tmax, md=md, jhit=[np.asarray(x) for x in hit[:3]], jocc=np.asarray(occ),
        hit=ik.intersect_rays_pallas(torch.from_numpy(o), torch.from_numpy(d),
                                     m, t_max=torch.from_numpy(tmax)),
        occ=ik.intersect_rays_pallas(torch.from_numpy(o), torch.from_numpy(d),
                                     m, any_hit=True,
                                     max_dist=torch.from_numpy(md)).numpy())


def test_mesh_takes_the_expected_kernel(case):
    c = ik.pack_tri_weights(case["m"]).shape[2] // ik.TRI_TILE
    assert (c >= ik.GATHER_MIN_CLUSTERS) == (
        case["name"] == "gather_18_clusters")
    assert (c >= jik._GATHER_MIN_CLUSTERS) == (c >= ik.GATHER_MIN_CLUSTERS)


def test_weights_and_cluster_bounds_bitwise(case):
    w = ik.pack_tri_weights(case["m"])
    np.testing.assert_array_equal(w.numpy(), case["jw"])
    for a, b in zip(ik.cluster_bounds(case["m"]), case["jcl"]):
        np.testing.assert_array_equal(a.numpy(), b)
    # K4's triangle-major records hold each triangle's 19 non-zero weight
    # rows of the cluster blocks, in the kernels' order, and a zero pad
    w_c = ik.cluster_weights(w).reshape(-1, 16, 4, ik.TRI_TILE)
    recs = ik.cluster_records(w)
    assert recs.shape == (w_c.shape[0], ik.TRI_TILE, ik.REC_FLOATS)
    for i, (r, b) in enumerate(ik.STAGED_ROWS):
        assert torch.equal(recs[:, :, i], w_c[:, r, b])
    assert not recs[:, :, len(ik.STAGED_ROWS):].any()
    # the 45 weights outside the staged rows are all zero
    staged = torch.zeros((16, 4), dtype=torch.bool)
    staged[tuple(zip(*ik.STAGED_ROWS))] = True
    assert not w_c[:, ~staged].any()


def test_cull_mask_bitwise(case):
    n = N_RAYS
    tmm = np.stack([np.full(n, 1e-5, np.float32), case["tmax"]], -1)
    jmask = jik._tile_cluster_mask(
        jnp.asarray(case["o"]), jnp.asarray(case["d"]), jnp.asarray(tmm),
        *(jnp.asarray(x) for x in case["jcl"]))
    mask = ik.tile_cluster_mask(torch.from_numpy(case["o"]),
                                torch.from_numpy(case["d"]),
                                torch.from_numpy(tmm),
                                *ik.cluster_bounds(case["m"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if case["name"] == "gather_18_clusters":
        assert mask.float().mean() < 1.0  # the cull rejects some pairs
        ids, cnt = ik.cluster_ids(mask)
        jids = np.argsort(~np.asarray(jmask), axis=1, kind="stable")
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jmask).sum(1))


def test_nearest_hit_matches_jax(case):
    jt, jtri, jvalid = case["jhit"]
    hit = case["hit"]
    valid = hit.valid.numpy()
    np.testing.assert_array_equal(valid, jvalid)
    assert not valid[~case["active"]].any()
    assert 0.1 < valid.mean() < 0.9
    both = valid & jvalid
    np.testing.assert_allclose(hit.t.numpy()[both], jt[both], rtol=1e-5,
                               atol=1e-6)
    assert (hit.tri.numpy()[both] != jtri[both]).mean() < 0.01
    assert (hit.tri.numpy()[~valid] == -1).all()
    assert np.isinf(hit.t.numpy()[~valid]).all()


def test_any_hit_matches_jax(case):
    np.testing.assert_array_equal(case["occ"], case["jocc"])
    assert not case["occ"][~case["active"]].any()
    assert 0.05 < case["occ"].mean() < case["hit"].valid.numpy().mean()


def test_dense_and_gather_plain_versions_agree(case):
    """The two plain versions compute one function: a mask and its id
    lists admit the same pairs."""
    m = case["m"]
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    feats = ik.ray_features(o, d)
    tmm = torch.stack([torch.full((N_RAYS,), 1e-5),
                       torch.from_numpy(case["tmax"])], -1)
    c_lo, c_hi = ik.cluster_bounds(m)
    mask = ik.tile_cluster_mask(o, d, tmm, c_lo, c_hi)
    w = ik.pack_tri_weights(m)
    w_c = ik.cluster_weights(w)
    dt, dtri = ik.intersect_dense(feats, tmm, w_c, mask)
    ids, cnt = ik.tile_cull(feats, tmm, c_lo, c_hi)
    assert torch.equal(ids, ik.cluster_ids(mask)[0])
    gt, gtri = ik.intersect_gather(feats, tmm, ik.cluster_records(w), ids,
                                   cnt)
    assert torch.equal(dt, gt) and torch.equal(dtri, gtri)
    # culling only skips work: an all-admitting mask gives the same hits
    ot, otri = ik.intersect_dense(feats, tmm, w_c, torch.ones_like(mask))
    assert torch.equal(dt, ot) and torch.equal(dtri, otri)


def _gather_operands(m, o, d, tmax):
    """K4's operands for rays (o, d) against mesh m: features, intervals,
    records and the plain cull's id lists."""
    feats = ik.ray_features(torch.from_numpy(o), torch.from_numpy(d))
    tmm = torch.stack([torch.full((o.shape[0],), 1e-5),
                       torch.from_numpy(tmax)], -1)
    ids, cnt = ik.tile_cull(feats, tmm, *ik.cluster_bounds(m))
    return feats, tmm, ik.cluster_records(ik.pack_tri_weights(m)), ids, cnt


def test_split_merge_matches_the_scan(case):
    """K4's blocks in plain form: each tile's list cut into chunks, each
    chunk's nearest hit merged by the minimum key, equals the sequential
    scan bitwise (t, triangle and no-hit lanes) for every chunk size."""
    ops = _gather_operands(case["m"], case["o"], case["d"], case["tmax"])
    want_t, want_tri = ik.intersect_gather_reference(*ops)
    assert (want_tri >= 0).any()
    for chunk in sorted({1, 3, ik.GATHER_CHUNK}):
        t, tri = ik.intersect_gather_split_reference(*ops, chunk=chunk)
        assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
        assert torch.equal(tri, want_tri)


def test_split_merge_breaks_exact_ties_like_the_scan():
    """Two clusters of the same 512 triangles: every hit ties exactly in t
    across them, and the merge, one cluster a chunk, keeps the first
    cluster's triangle as the scan does."""
    tris = sphere_triangles(radius=1.5, n_theta=17, n_phi=16)
    assert len(tris) == ik.TRI_TILE
    m = TriangleMesh.build(np.concatenate([tris, tris]),
                           np.zeros(2 * len(tris), np.int32), device="cpu")
    o, d, active = rays(seed=13)
    tmax = np.where(active, np.inf, -np.inf).astype(np.float32)
    ops = _gather_operands(m, o, d, tmax)
    assert (ops[4] == 2).all()  # every tile admits both clusters
    want_t, want_tri = ik.intersect_gather_reference(*ops)
    t, tri = ik.intersect_gather_split_reference(*ops, chunk=1)
    hit = want_tri >= 0
    assert hit.sum() > 100 and (want_tri[hit] < ik.TRI_TILE).all()
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(tri, want_tri)
    # the second cluster alone finds the same t on its copies
    t2, tri2 = ik.intersect_gather_reference(*ops[:3], ops[3][:, 1:],
                                             ops[4] - 1)
    assert torch.equal(t2[hit], want_t[hit])
    assert torch.equal(tri2[hit], want_tri[hit] + ik.TRI_TILE)


@pytest.mark.parametrize("kind", ["ties", "negative_t", "no_hit"])
def test_hit_keys_order_like_the_scan(kind):
    """The int64 keys order as (t, index): the minimum key of a list of
    hits is the hit a sequential strict-< scan over ascending indices
    keeps, and unpacking gives its t and index back bitwise."""
    rng = np.random.default_rng(["ties", "negative_t", "no_hit"].index(kind))
    n = 4096
    if kind == "ties":  # few distinct t, so most keys tie on t
        t = rng.choice(np.float32([1e-5, 0.5, 1.0, 2.0, 3.0e37]), n)
    elif kind == "negative_t":  # negative, zero and positive t
        t = np.concatenate([rng.normal(0, 10, n - 4).astype(np.float32),
                            np.float32([-0.0, 0.0, -1e-30, 1e-30])])
    else:  # some lanes without a hit
        t = rng.uniform(0, 5, n).astype(np.float32)
    tri = rng.permutation(n).astype(np.int32)
    tt, ttri = torch.from_numpy(t), torch.from_numpy(tri)
    keys = ik.hit_keys(tt, ttri)
    back_t, back_tri = ik.unpack_hit_keys(keys)
    assert torch.equal(back_tri, ttri)
    assert torch.equal(back_t.view(torch.int32),
                       torch.where(tt == 0.0, 0.0, tt).view(torch.int32))
    if kind == "no_hit":
        keys = torch.where(torch.arange(n) % 3 == 0, ik.NO_HIT_KEY, keys)
        none_t, none_tri = ik.unpack_hit_keys(keys)
        assert (none_t[::3] == ik.BIG).all() and (none_tri[::3] == -1).all()
        assert (keys[1::3] < ik.NO_HIT_KEY).all()
    # the keys sort as (t, index) does (lexsort's last key is primary)
    live = keys != ik.NO_HIT_KEY
    order = np.lexsort((tri[live.numpy()], t[live.numpy()]))
    assert torch.equal(torch.sort(keys[live]).values, keys[live][order])
    # in groups of 64 lanes: the scan in ascending index, strict <
    for g in range(0, n, 64):
        k, ts, ids = keys[g:g + 64], t[g:g + 64], tri[g:g + 64]
        best_t, best = ik.BIG, -1
        for j in np.argsort(ids):
            if k[j] != ik.NO_HIT_KEY and ts[j] < best_t:
                best_t, best = ts[j], ids[j]
        assert ik.unpack_hit_keys(k.min()[None])[1].item() == best


def test_ray_sort_key_and_sorted_apply_match_jax():
    n = 4096 + 640
    o, d, active = rays(seed=5, n=n)
    tris = sphere_triangles(radius=1.5, n_theta=8, n_phi=16)
    jm = JMesh.build(tris, np.zeros(len(tris), np.int32))
    m = TriangleMesh.build(tris, np.zeros(len(tris), np.int32), device="cpu")
    jlo, jhi = jraysort.scene_bounds(jm)
    lo, hi = raysort.scene_bounds(m)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    jkey = jraysort.ray_sort_key(jnp.asarray(o), jnp.asarray(d), jlo, jhi,
                                 inactive=jnp.asarray(~active))
    key = raysort.ray_sort_key(torch.from_numpy(o), torch.from_numpy(d), lo,
                               hi, inactive=torch.from_numpy(~active))
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))

    def where_sorted(o_s, d_s, x):  # each lane's sorted position, and x
        pos = torch.arange(o_s.shape[0]) if isinstance(o_s, torch.Tensor) \
            else jnp.arange(o_s.shape[0])
        return pos, x

    x = np.arange(n, dtype=np.float32)
    jpos, jx = jraysort.sorted_apply(where_sorted, jm, jnp.asarray(o),
                                     jnp.asarray(d), jnp.asarray(x),
                                     inactive=jnp.asarray(~active))
    pos, px = raysort.sorted_apply(where_sorted, m, torch.from_numpy(o),
                                   torch.from_numpy(d), torch.from_numpy(x),
                                   inactive=torch.from_numpy(~active))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(px.numpy(), x)  # un-permuted
    # dead lanes sort into the trailing tiles
    assert (pos.numpy()[~active] >= active.sum()).all()


def test_dispatch_gates_inactive_lanes():
    """scene_intersect / scene_occluded with an active mask: live lanes get
    the ungated results, inactive lanes no hit and unoccluded."""
    from light_transport_tpu_torch.scene.material import Material, presets
    from light_transport_tpu_torch.scene.material import MaterialTable
    from light_transport_tpu_torch.scene.scene import Scene

    tris = sphere_triangles(radius=1.5, n_theta=8, n_phi=16)
    m = TriangleMesh.build(tris, np.zeros(len(tris), np.int32), device="cpu")
    scene = Scene.build(m, MaterialTable.build(
        [Material(color=presets.GREY)], device="cpu"), camera=[0, 0, 5])
    o, d, active = (torch.from_numpy(a) for a in rays(seed=3))
    full = scene_intersect(scene, o, d)
    gated = scene_intersect(scene, o, d, active=active)
    assert torch.equal(gated.valid, full.valid & active)
    assert torch.equal(gated.t[active], full.t[active])
    assert torch.equal(gated.tri[active], full.tri[active])
    occ_full = scene_occluded(scene, o, d, MAX_DIST)
    occ = scene_occluded(scene, o, d, MAX_DIST, active=active)
    assert torch.equal(occ, occ_full & active)
    assert occ.any()
