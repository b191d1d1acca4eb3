"""The order of a scene's light triangles in the program's light table,
worked out from the configuration's triangles alone.

The program's scene build reorders the mesh by its BVH and lists the
light triangles in the new order; its light pick walks the area CDF in
that order, so the reference samples its lights in the same order to draw
the same point from the same uniform.  The rule is a frozen copy of the
build's partition (``native/bvh_builder.cpp``): binned SAH over 12
buckets along the centroids' widest axis, at most 4 triangles a leaf, the
split made by ``std::partition``'s two-pointer swaps.  Only the nodes
that hold a light are followed: no other node moves a light."""

from __future__ import annotations

import numpy as np

N_BUCKETS = 12
MAX_LEAF = 4


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _partition(idx: np.ndarray, left: np.ndarray) -> np.ndarray:
    """``std::partition`` of ``idx`` by ``left`` (libstdc++): the k-th
    element that belongs right, counted from the front, swaps with the
    k-th that belongs left, counted from the back, while it lies before
    it."""
    out = idx.copy()
    bad = np.nonzero(~left)[0]
    good = np.nonzero(left)[0][::-1]
    k = min(len(bad), len(good))
    k = int((bad[:k] < good[:k]).sum())
    out[bad[:k]] = idx[good[:k]]
    out[good[:k]] = idx[bad[:k]]
    return out


def _split(idx, lo, hi, centroid):
    """A node's binned-SAH split: each triangle's bucket, and the last
    bucket that goes left."""
    c = centroid[idx]
    c_lo = c.min(axis=0)
    extent = c.max(axis=0) - c_lo
    ax = 0
    if extent[1] > extent[ax]:
        ax = 1
    if extent[2] > extent[ax]:
        ax = 2
    if extent[ax] <= 1e-12:
        raise NotImplementedError("a light lies in a node of coincident "
                                  "centroids, which the rule leaves open")
    rel = (c[:, ax] - c_lo[ax]) * (1.0 / extent[ax])
    bucket = np.clip((rel * N_BUCKETS).astype(np.int64), 0, N_BUCKETS - 1)
    counts = np.bincount(bucket, minlength=N_BUCKETS)
    bmin = np.full((N_BUCKETS, 3), np.inf)
    bmax = np.full((N_BUCKETS, 3), -np.inf)
    for b in np.nonzero(counts)[0]:
        sel = idx[bucket == b]
        bmin[b] = lo[sel].min(axis=0)
        bmax[b] = hi[sel].max(axis=0)
    lcount = np.cumsum(counts)
    rcount = np.cumsum(counts[::-1])[::-1]
    larea = np.where(lcount > 0, _area(np.minimum.accumulate(bmin),
                                       np.maximum.accumulate(bmax)), 0.0)
    rarea = np.where(rcount > 0, _area(
        np.minimum.accumulate(bmin[::-1])[::-1],
        np.maximum.accumulate(bmax[::-1])[::-1]), 0.0)
    sa_total = max(float(_area(lo[idx].min(axis=0), hi[idx].max(axis=0))),
                   1e-30)
    valid = (lcount[:-1] > 0) & (rcount[1:] > 0)
    costs = np.where(valid, 1.0 + 1.0 * (lcount[:-1] * larea[:-1]
                                         + rcount[1:] * rarea[1:])
                     / sa_total, np.inf)
    best = int(np.argmin(costs))
    if not np.isfinite(costs[best]):
        raise NotImplementedError("a light lies in a node with no SAH "
                                  "split, which the rule leaves open")
    return bucket, best


def light_order(vertices: np.ndarray, is_light: np.ndarray) -> np.ndarray:
    """Indices into the configuration's light triangles (in their own
    order), in the order of the program's light table.  ``vertices`` is
    the ``(T, 3, 3)`` array of the configuration's triangles."""
    v = np.asarray(vertices, np.float64)
    light = np.asarray(is_light, bool)
    # the mesh as the program holds it: float32 v0, edges and centroids
    v0 = v[:, 0].astype(np.float32).astype(np.float64)
    e1 = (v[:, 1] - v[:, 0]).astype(np.float32).astype(np.float64)
    e2 = (v[:, 2] - v[:, 0]).astype(np.float32).astype(np.float64)
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    centroid = v.mean(axis=1).astype(np.float32).astype(np.float64)

    order = np.arange(len(v))
    todo = [(0, len(v))]
    while todo:
        start, end = todo.pop()
        idx = order[start:end]
        if end - start <= MAX_LEAF or not light[idx].any():
            continue
        bucket, best = _split(idx, lo, hi, centroid)
        go_left = bucket <= best
        mid = start + int(go_left.sum())
        if mid in (start, end):
            raise NotImplementedError("a light lies in a node split "
                                      "to one side, which the rule leaves "
                                      "open")
        order[start:end] = _partition(idx, go_left)
        todo += [(start, mid), (mid, end)]
    ids = np.nonzero(light)[0]
    return np.searchsorted(ids, order[light[order]])
