"""Bounding volume hierarchy: the host build and its flat node arrays.

The counterpart of ``light_transport_tpu.accel.bvh`` up to the reordered
mesh and the flat node arrays.  Its triangle order decides which
triangles share a 512-triangle cluster of the intersector
(``ops.intersect_kernel``), and so what the cluster cull can skip.  The
traversal (``intersect_bvh``, ``occluded_bvh``) belongs to the BVH slice.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Tuple

import numpy as np
import torch

from light_transport_tpu_torch.scene.geometry import TriangleMesh

N_BUCKETS = 12
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


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
    """Rope pointers: skip[n] = next DFS node outside n's subtree (M = done)."""
    m = len(ncount)
    skip = np.empty(m, np.int32)
    stack = [(0, m)]
    while stack:
        node, s = stack.pop()
        skip[node] = s
        if ncount[node] == 0:  # interior
            right = int(nright[node])
            stack.append((node + 1, right))
            stack.append((right, s))
    return skip


def build(mesh: TriangleMesh, max_leaf: int = 4,
          use_native: bool = True) -> Tuple[BVH, TriangleMesh]:
    """Build a BVH for ``mesh``; returns (bvh, reordered mesh), both on the
    mesh's device."""
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
    nmin, nmax, nright, nfirst, ncount, naxis, order = built
    eps = 1e-5 * np.maximum(1.0, np.abs(nmax - nmin).max())

    def t(a, dt):
        return torch.as_tensor(np.asarray(a, dt), device=mesh.device)

    bvh = BVH(bounds_min=t(nmin - eps, np.float32),
              bounds_max=t(nmax + eps, np.float32),
              right=t(nright, np.int32), first=t(nfirst, np.int32),
              count=t(ncount, np.int32), axis=t(naxis, np.int32),
              skip=t(_compute_skip(nright, ncount), np.int32))
    return bvh, mesh.select(order)
