"""Bounding volume hierarchy: the host build, its flat node arrays and the
roped walk.

The counterpart of ``light_transport_tpu.accel.bvh``.  The build reorders
the mesh (its triangle order also decides which triangles share a
512-triangle cluster of ``ops.intersect_kernel``) and emits the fused
records the walk gathers: one 16-float node row (bounds, then ``first``,
``count`` and the ``skip`` rope bitcast into floats 6:9) and one leaf row
holding all of a leaf's triangles.

:func:`roped_walk` is the stackless roped traversal, lanes in lockstep,
op for op after JAX's ``_slab`` and ``_mt_single``.  It is both the
counterpart of JAX's XLA walk (:func:`intersect_bvh`,
:func:`occluded_bvh`) and the plain version of the treelet kernels K5 and
K5r (``ops.treelet_kernel``), which repeat its arithmetic in the same
order.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from light_transport_tpu_torch.core import math as lm
from light_transport_tpu_torch.ops.intersect import DET_EPS, T_EPS, Hit
from light_transport_tpu_torch.scene.geometry import TriangleMesh

N_BUCKETS = 12
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0
# lockstep steps of the plain walk between looks at how many lanes live
_CHECK_STEPS = 16

# runs of the plain walk, on any device (read and reset by callers: a
# render whose BVH queries go through the treelet kernels runs none)
PLAIN_WALKS = 0


@dataclasses.dataclass
class BVH:
    """Flat BVH over a reordered TriangleMesh: root 0, left child
    ``node + 1``, right child ``right[node]``; ``count[node] > 0`` marks a
    leaf over prims ``[first, first + count)``; ``skip`` is the rope to
    the next depth-first node outside the subtree."""

    bounds_min: torch.Tensor  # (M, 3), inflated a hair
    bounds_max: torch.Tensor  # (M, 3)
    right: torch.Tensor  # (M,) int32
    first: torch.Tensor  # (M,) int32
    count: torch.Tensor  # (M,) int32
    axis: torch.Tensor  # (M,) int32
    skip: torch.Tensor  # (M,) int32
    # the walk's fused records: (M, 16) [min3, max3, first, count, skip
    # (int32 bitcast into floats), zeros] and (M, 8 * ceil(9 * max_leaf
    # / 8)) [v0, e1, e2] of each leaf triangle (zeros for interior nodes)
    node_rec: torch.Tensor
    leaf_rec: torch.Tensor
    max_leaf: int = 4

    @property
    def num_nodes(self) -> int:
        return self.count.shape[0]


def _build_host(verts: np.ndarray, centroid: np.ndarray, max_leaf: int):
    """Recursive binned-SAH build; returns (flat node arrays, prim order)."""
    t = verts.shape[0]
    lo = verts.min(axis=1)
    hi = verts.max(axis=1)

    order = np.arange(t)
    nmin, nmax, nright, nfirst, ncount, naxis = [], [], [], [], [], []

    def emit():
        nmin.append(None)
        nmax.append(None)
        nright.append(0)
        nfirst.append(0)
        ncount.append(0)
        naxis.append(0)
        return len(ncount) - 1

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    def build(start, end):
        node = emit()
        idx = order[start:end]
        b_lo = lo[idx].min(axis=0)
        b_hi = hi[idx].max(axis=0)
        nmin[node], nmax[node] = b_lo, b_hi
        n = end - start
        c = centroid[idx]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        extent = c_hi - c_lo
        ax = int(np.argmax(extent))
        if n <= max_leaf:
            nfirst[node], ncount[node] = start, n
            return node
        if extent[ax] <= 1e-12:
            # degenerate centroid cluster: median split by position
            order[start:end] = idx[np.argsort(c[:, ax], kind="stable")]
            mid = start + n // 2
            naxis[node] = ax
            build(start, mid)
            nright[node] = build(mid, end)
            ncount[node] = 0
            return node

        rel = (c[:, ax] - c_lo[ax]) / extent[ax]
        bucket = np.minimum((rel * N_BUCKETS).astype(np.int64), N_BUCKETS - 1)
        counts = np.bincount(bucket, minlength=N_BUCKETS)
        bmin = np.full((N_BUCKETS, 3), np.inf)
        bmax = np.full((N_BUCKETS, 3), -np.inf)
        for b in np.nonzero(counts)[0]:
            sel = bucket == b
            bmin[b] = lo[idx][sel].min(axis=0)
            bmax[b] = hi[idx][sel].max(axis=0)
        lminb = np.minimum.accumulate(bmin, axis=0)
        lmaxb = np.maximum.accumulate(bmax, axis=0)
        rminb = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmaxb = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = np.cumsum(counts[::-1])[::-1]
        sa_total = max(area(b_lo, b_hi), 1e-30)
        costs = np.full(N_BUCKETS - 1, np.inf)
        valid = (lcount[:-1] > 0) & (rcount[1:] > 0)
        la = area(lminb[:-1], lmaxb[:-1])
        ra = area(rminb[1:], rmaxb[1:])
        costs[valid] = TRAVERSAL_COST + INTERSECT_COST * (
            lcount[:-1][valid] * la[valid] + rcount[1:][valid] * ra[valid]
        ) / sa_total
        best = int(np.argmin(costs))
        if not np.isfinite(costs[best]):
            key = np.argsort(c[:, ax], kind="stable")
            order[start:end] = idx[key]
            mid = start + n // 2
        else:
            go_left = bucket <= best
            perm = np.argsort(~go_left, kind="stable")
            order[start:end] = idx[perm]
            mid = start + int(go_left.sum())
            if mid == start or mid == end:
                key = np.argsort(c[:, ax], kind="stable")
                order[start:end] = idx[key]
                mid = start + n // 2

        naxis[node] = ax
        build(start, mid)  # left child lands at node + 1
        nright[node] = build(mid, end)
        ncount[node] = 0
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(0, t)
    finally:
        sys.setrecursionlimit(old_limit)
    return (np.asarray(nmin), np.asarray(nmax),
            np.asarray(nright, np.int32), np.asarray(nfirst, np.int32),
            np.asarray(ncount, np.int32), np.asarray(naxis, np.int32),
            order)


def _compute_skip(nright: np.ndarray, ncount: np.ndarray) -> np.ndarray:
    """Rope pointers: skip[n] = next DFS node outside n's subtree (M = done).

    That node is one past the subtree's last node, the leaf at the end of
    n's chain of right children (n itself for a leaf), found by pointer
    doubling: log2(depth) numpy passes over the nodes."""
    m = len(ncount)
    ptr = np.where(np.asarray(ncount) > 0, np.arange(m),
                   np.asarray(nright)).astype(np.int64)
    while True:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            return (ptr + 1).astype(np.int32)
        ptr = nxt


def leaf_width(max_leaf: int) -> int:
    """Floats per leaf record: 9 per triangle, padded to a multiple of 8."""
    return 8 * -(-9 * max_leaf // 8)


def build(mesh: TriangleMesh, max_leaf: int = 4, use_native: bool = True,
          timings: Optional[dict] = None) -> Tuple[BVH, TriangleMesh]:
    """Build a BVH for ``mesh``; returns (bvh, reordered mesh), both on the
    mesh's device.  ``timings``, if given, receives the seconds of the
    tree build (``build_s``, native or numpy), the ropes (``skip_s``) and
    the fused records (``records_s``)."""
    t0 = time.perf_counter()
    h_v0, h_e1, h_e2 = mesh.host_arrays()[:3]
    centroid = mesh.centroid.cpu().numpy().astype(np.float64)
    verts = mesh.vertices()
    built = None
    if use_native:
        from light_transport_tpu_torch.accel.native import build_native

        try:
            built = build_native(verts, centroid, max_leaf)
        except (OSError, RuntimeError, subprocess.SubprocessError):
            built = None
    if built is None:
        built = _build_host(verts, centroid, max_leaf)
    del verts, centroid
    nmin, nmax, nright, nfirst, ncount, naxis, order = built
    t1 = time.perf_counter()
    skip = _compute_skip(nright, ncount)
    t2 = time.perf_counter()
    eps = 1e-5 * np.maximum(1.0, np.abs(nmax - nmin).max())
    m = len(ncount)
    t_count = len(order)
    tri_flat = np.concatenate([h_v0[order], h_e1[order], h_e2[order]],
                              axis=1).astype(np.float32)  # (T, 9)
    node_rec = np.zeros((m, 16), np.float32)
    node_rec[:, 0:3] = nmin - eps
    node_rec[:, 3:6] = nmax + eps
    node_rec[:, 6:9] = np.stack([nfirst, ncount, skip], axis=1).astype(
        np.int32).view(np.float32)
    leaf_rec = np.zeros((m, leaf_width(max_leaf)), np.float32)
    is_leaf_node = ncount > 0
    for k in range(max_leaf):
        pi = np.clip(nfirst + k, 0, t_count - 1)
        valid = is_leaf_node & (k < ncount)
        leaf_rec[:, 9 * k: 9 * k + 9] = np.where(valid[:, None],
                                                 tri_flat[pi], 0.0)
    del tri_flat

    def t(a, dt):
        return torch.as_tensor(np.asarray(a, dt), device=mesh.device)

    bvh = BVH(bounds_min=t(node_rec[:, 0:3], np.float32),
              bounds_max=t(node_rec[:, 3:6], np.float32),
              right=t(nright, np.int32), first=t(nfirst, np.int32),
              count=t(ncount, np.int32), axis=t(naxis, np.int32),
              skip=t(skip, np.int32), node_rec=t(node_rec, np.float32),
              leaf_rec=t(leaf_rec, np.float32), max_leaf=max_leaf)
    if timings is not None:
        timings.update(build_s=t1 - t0, skip_s=t2 - t1,
                       records_s=time.perf_counter() - t2)
    return bvh, mesh.select(order)


# --------------------------------------------------------------------------
# the roped walk (plain PyTorch)
# --------------------------------------------------------------------------

def inverse_directions(directions: torch.Tensor) -> torch.Tensor:
    """``1 / d`` with each component clamped away from zero to 1e-20 in
    magnitude (keeping its sign), as JAX's walk and treelet kernel do."""
    tiny = torch.full_like(directions, 1e-20)
    return 1.0 / torch.where(directions.abs() < 1e-20,
                             torch.where(directions < 0, -tiny, tiny),
                             directions)


def _mt_single(o, d, v0, e1, e2, t_min):
    """Möller–Trumbore, one gathered triangle per lane, in JAX's order; the
    upper bound on t is the caller's running minimum."""
    pvec = lm.cross(d, e2)
    det = lm.dot(e1, pvec)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - v0
    u = lm.dot(tvec, pvec) * inv
    qvec = lm.cross(tvec, e1)
    v = lm.dot(d, qvec) * inv
    t = lm.dot(e2, qvec) * inv
    valid = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min))
    return t, valid


def _walk_steps(lanes, node_rec, leaf_rec, m, max_leaf, any_hit, T,
                max_loads, steps):
    """``steps`` lockstep iterations over the lane state ``lanes`` (a dict
    of per-lane tensors), in place."""
    o, d, inv, tmin = lanes["o"], lanes["d"], lanes["inv"], lanes["tmin"]
    for _ in range(steps):
        cursor, best_t, best_tri = (lanes["cursor"], lanes["best_t"],
                                    lanes["best_tri"])
        active = cursor < m
        if max_loads:
            active = active & (lanes["loads"] <= max_loads)
        node = torch.where(active, cursor, 0).long()
        rec = node_rec[node]
        ints = rec[:, 6:9].view(torch.int32)
        first, count, skip = ints[:, 0], ints[:, 1], ints[:, 2]
        # slab test, op for op JAX's _slab (boxes behind the origin count
        # from 0)
        t1 = (rec[:, 0:3] - o) * inv
        t2 = (rec[:, 3:6] - o) * inv
        tn = torch.minimum(t1, t2).amax(dim=-1)
        tf = torch.maximum(t1, t2).amin(dim=-1)
        tn = torch.clamp(tn, min=0.0)
        hit_box = (tn <= tf) & (tn <= best_t) & (tf >= 0.0) & active
        # the leaf pass, on the lanes at a leaf whose box they enter only:
        # every triangle's t at once (JAX's t < best_t test moves to the
        # running minimum, which takes the triangles in order)
        li = torch.nonzero((count > 0) & hit_box).flatten()
        if li.numel():
            leaf = leaf_rec[node[li], :9 * max_leaf].reshape(-1, max_leaf, 9)
            l_first, l_count = first[li], count[li]
            l_t, l_tri = best_t[li], best_tri[li]
            t, valid = _mt_single(o[li, None], d[li, None], leaf[..., 0:3],
                                  leaf[..., 3:6], leaf[..., 6:9],
                                  tmin[li, None])
            for k in range(max_leaf):
                t_k = t[:, k]
                take = (k < l_count) & valid[:, k] & (t_k < l_t)
                l_t = torch.where(take, t_k, l_t)
                l_tri = torch.where(take, l_first + k, l_tri)
            best_t = best_t.index_put((li,), l_t)
            best_tri = best_tri.index_put((li,), l_tri)
        nxt = torch.where(hit_box & (count == 0), cursor + 1, skip)
        if any_hit:
            nxt = torch.where(best_tri >= 0, m, nxt)
        if max_loads:
            lanes["loads"] = lanes["loads"] + (
                active & (nxt // T != cursor // T)).to(torch.int32)
        lanes["cursor"] = torch.where(active, nxt, cursor)
        lanes["best_t"], lanes["best_tri"] = best_t, best_tri
        lanes["visits"] = lanes["visits"] + active.to(torch.int32)


def roped_walk(node_rec, leaf_rec, num_nodes: int, max_leaf: int,
               origins, directions, inv_d, t_min, cursor, best_t, best_tri,
               any_hit: bool = False, T: int = 1, max_loads: int = 0):
    """The roped walk of every lane from its ``cursor``, ``best_t`` and
    ``best_tri``; returns the new ``(cursor, best_t, best_tri, visits)``,
    ``visits`` counting this call's node visits per lane.

    A hit interior node advances the cursor to ``node + 1``, anything else
    follows the rope; a leaf whose box the ray enters tests its triangles
    in order and keeps a strictly nearer hit, so a tie goes to the first
    triangle in traversal order.  ``any_hit`` ends a lane after the leaf
    of its first hit.  ``max_loads > 0`` bounds the treelets of ``T``
    nodes a lane enters in this call: the one it starts in counts as the
    first, and the lane stops with its cursor on the first node of
    treelet number ``max_loads + 1``.  Lanes whose ``best_t`` is -inf
    (dead) leave the root after one visit.

    Lanes advance in lockstep; every ``_CHECK_STEPS`` steps the finished
    or stopped lanes are dropped from the working set once they are half
    of it (which changes no result)."""
    global PLAIN_WALKS
    PLAIN_WALKS += 1
    n = origins.shape[0]
    out = {"cursor": cursor.clone(), "best_t": best_t.clone(),
           "best_tri": best_tri.clone(),
           "visits": torch.zeros_like(cursor)}
    lanes = {"o": origins, "d": directions, "inv": inv_d, "tmin": t_min,
             "cursor": cursor, "best_t": best_t, "best_tri": best_tri,
             "visits": torch.zeros_like(cursor),
             "loads": torch.ones_like(cursor)}
    idx = torch.arange(n, device=cursor.device)
    while idx.numel():
        active = lanes["cursor"] < num_nodes
        if max_loads:
            active &= lanes["loads"] <= max_loads
        live = torch.nonzero(active).flatten()
        if live.numel() * 2 <= idx.numel():
            for k in out:
                out[k][idx] = lanes[k]
            idx = idx[live]
            lanes = {k: v[live] for k, v in lanes.items()}
        if idx.numel():
            _walk_steps(lanes, node_rec, leaf_rec, num_nodes, max_leaf,
                        any_hit, T, max_loads, _CHECK_STEPS)
    return out["cursor"], out["best_t"], out["best_tri"], out["visits"]


def intersect_bvh(origins: torch.Tensor, directions: torch.Tensor,
                  mesh: TriangleMesh, bvh: BVH, t_min=T_EPS,
                  t_max=float("inf"), max_leaf: Optional[int] = None,
                  any_hit: bool = False) -> Hit:
    """Nearest hit (or any hit) by the roped walk from the root: the
    counterpart of JAX's ``accel.bvh.intersect_bvh``.  ``t_max`` may be
    per ray; lanes with ``t_max = -inf`` are dead and report no hit."""
    n = origins.shape[0]
    kw = dict(dtype=origins.dtype, device=origins.device)
    tmin = torch.as_tensor(t_min, **kw).expand(n).contiguous()
    tmax = torch.as_tensor(t_max, **kw).expand(n).contiguous()
    cursor = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=origins.device)
    _, best_t, best_tri, _ = roped_walk(
        bvh.node_rec, bvh.leaf_rec, bvh.num_nodes,
        bvh.max_leaf if max_leaf is None else max_leaf, origins, directions,
        inverse_directions(directions), tmin, cursor, tmax, best_tri,
        any_hit=any_hit)
    valid = best_tri >= 0
    return Hit(t=torch.where(valid, best_t, float("inf")), tri=best_tri,
               valid=valid)


def occluded_bvh(origins, directions, mesh, bvh, max_dist, t_min=T_EPS,
                 max_leaf: Optional[int] = None) -> torch.Tensor:
    """Any-hit visibility before ``max_dist`` by the roped walk."""
    return intersect_bvh(origins, directions, mesh, bvh, t_min=t_min,
                         t_max=max_dist, max_leaf=max_leaf,
                         any_hit=True).valid
