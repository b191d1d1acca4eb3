"""K4's group boxes and its count of tested groups, in plain form.

Plain torch, no JAX.  ``cluster_group_bounds`` is held bitwise to a loop
over the triangles, each triangle to its group's box and the groups to
their cluster's box; ``gather_group_count`` (the (warp, group) pairs K4
tests in nearest-hit mode) to hand-built rays on a toy mesh whose groups
are disjoint unit cubes.
"""

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.scene.cornell import sphere_triangles
from light_transport_tpu_torch.scene.geometry import TriangleMesh

torch.set_num_threads(1)


def mesh(tris):
    return TriangleMesh.build(tris, np.zeros(len(tris), np.int32),
                              device="cpu")


def cubes(n_clusters=2, seed=0):
    """Group k of cluster c: 32 triangles inside the unit cube at
    (2k, 2c, 0)."""
    rng = np.random.default_rng(seed)
    g = np.arange(n_clusters * ik.GROUPS)
    corner = np.stack([2.0 * (g % ik.GROUPS), 2.0 * (g // ik.GROUPS),
                       np.zeros_like(g, dtype=float)], -1)
    tris = corner[:, None, None, :] + rng.uniform(
        0.1, 0.9, (len(g), ik.GROUP_TRIS, 3, 3))
    return tris.reshape(-1, 3, 3).astype(np.float32)


# a sphere whose last cluster is padded, and the cubes
MESHES = {"sphere_pad": lambda: sphere_triangles(radius=1.5, n_theta=30,
                                                 n_phi=16),
          "cubes": cubes}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_group_bounds_bitwise_a_plain_loop(name):
    m = mesh(MESHES[name]())
    g_lo, g_hi = ik.cluster_group_bounds(m)
    c_lo, c_hi = ik.cluster_bounds(m)
    verts = torch.stack([m.v0, m.v0 + m.e1, m.v0 + m.e2], 1)  # (T, 3, 3)
    t = verts.shape[0]
    eps = 1e-5 * max(1.0, float(verts.abs().max()))
    assert g_lo.shape == (c_lo.shape[0], ik.GROUPS, 3)
    for c in range(g_lo.shape[0]):
        for k in range(ik.GROUPS):
            first = c * ik.TRI_TILE + k * ik.GROUP_TRIS
            # the padding replicates the last triangle
            idx = [min(i, t - 1) for i in range(first, first + ik.GROUP_TRIS)]
            v = verts[idx].reshape(-1, 3)
            assert torch.equal(g_lo[c, k], v.amin(0) - np.float32(eps))
            assert torch.equal(g_hi[c, k], v.amax(0) + np.float32(eps))
    # every triangle inside its group's box; a cluster's groups span its box
    tri_lo, tri_hi = verts.amin(1), verts.amax(1)
    grp = torch.arange(t) // ik.GROUP_TRIS
    assert (g_lo.reshape(-1, 3)[grp] <= tri_lo).all()
    assert (tri_hi <= g_hi.reshape(-1, 3)[grp]).all()
    assert torch.equal(g_lo.amin(1), c_lo) and torch.equal(g_hi.amax(1), c_hi)


def test_group_count_hand_built_rays():
    """Two tiles of 128 rays on the cubes (two clusters): warp 0 along +z
    through group 3 of cluster 0, warp 1 one lane along +x through groups
    5 and 6, warp 2 dead lanes and warp 3 an empty interval aimed at
    groups, warp 4 (tile 1) through group 0 of cluster 1; every other
    lane dead.  Counted over the cull's admitted clusters, then with tile
    1's list emptied."""
    m = mesh(cubes())
    n = 2 * ik.RAY_TILE
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 2] = 1.0
    tmm = torch.tensor([[1e-5, float("-inf")]]).repeat(n, 1)
    live = torch.tensor([1e-5, 50.0])
    lanes = torch.arange(32)
    # warp 0: under group (0, 3)'s cube, looking up
    o[lanes] = torch.tensor([6.5, 0.5, -1.0])
    tmm[lanes] = live
    # warp 1: lane 32 along +x at y, z = 0.5 from x = 9.5 to 12.5
    o[32] = torch.tensor([9.5, 0.5, 0.5])
    d[32] = torch.tensor([1.0, 0.0, 0.0])
    tmm[32] = torch.tensor([1e-5, 3.0])
    # warp 2 dead (t_max = -inf), warp 3 an empty interval, both aimed
    o[64:128] = torch.tensor([2.5, 0.5, -1.0])
    tmm[96:128] = torch.tensor([1.0, 1.0])
    # warp 4: under group (1, 0)'s cube
    o[128:160] = torch.tensor([0.5, 2.5, -1.0])
    tmm[128:160] = live
    feats = ik.ray_features(o, d)
    g_lo, g_hi = ik.cluster_group_bounds(m)
    ids, cnt = ik.tile_cull(feats, tmm, *ik.cluster_bounds(m))
    assert cnt.tolist() == [1, 1]
    assert int(ik.gather_group_count(feats, tmm, ids, cnt, g_lo,
                                     g_hi)) == 1 + 2 + 1
    assert int(ik.gather_group_count(feats, tmm, ids,
                                     torch.tensor([1, 0], dtype=torch.int32),
                                     g_lo, g_hi)) == 1 + 2
    # the CPU K4 adds the plain count to its accumulator
    acc = torch.tensor([7], dtype=torch.int64)
    ik.intersect_gather(feats, tmm, ik.cluster_records(ik.pack_tri_weights(
        m)), ids, cnt, groups=(g_lo, g_hi), counts=acc)
    assert acc.tolist() == [7 + 4]
