"""Brute-force ray-triangle intersection (masked Möller–Trumbore) and the
analytic sphere, plane and box tests.

The counterpart of ``light_transport_tpu.ops.intersect``'s ``intersect_rays``
and ``occluded``: every ray against every triangle in one ``(N, T)``
tile, the path scenes of 48 triangles or fewer take on either device.
Larger meshes go through the cluster-culled intersector
(``ops.intersect_kernel``).  ``sphere_intersect``, ``plane_intersect`` and
``aabb_intersect`` test a ray batch against one primitive each
(``scene.analytic`` folds the first two into every scene query).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from light_transport_tpu_torch.core import math as lm

# |det| below this is treated as ray-parallel-to-triangle
DET_EPS = 1e-12
# minimum hit distance
T_EPS = 1e-5


class Hit(NamedTuple):
    """SoA hit record for a ray batch.

    ``kind`` and ``prim`` are set only when the scene carries analytic
    primitives (``scene.analytic``): kind 0 is a triangle (``tri`` indexes
    the mesh), 1 a sphere, 2 a plane (``prim`` indexes the analytic table,
    ``tri`` is -1).  None for an all-triangle scene."""

    t: torch.Tensor  # (N,) hit distance; +inf on miss
    tri: torch.Tensor  # (N,) int32 triangle index; -1 on miss
    valid: torch.Tensor  # (N,) bool
    kind: Optional[torch.Tensor] = None  # (N,) int32 primitive kind
    prim: Optional[torch.Tensor] = None  # (N,) int32 analytic-table index


def _mt_tile(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore on an (N, T) tile; returns (t, valid)."""
    d_b = d[:, None, :]
    pvec = lm.cross(d_b, e2[None, :, :])
    det = lm.dot(e1[None, :, :], pvec)
    inv_det = torch.where(torch.abs(det) > DET_EPS,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = lm.dot(tvec, pvec) * inv_det
    qvec = lm.cross(tvec, e1[None, :, :])
    v = lm.dot(d_b, qvec) * inv_det
    t = lm.dot(e2[None, :, :], qvec) * inv_det
    valid = ((torch.abs(det) > DET_EPS) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min[:, None]) & (t < t_max[:, None]))
    return t, valid


def _broadcast_t(x, n, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(n)


def _chunks(n, ray_chunk):
    step = n if ray_chunk is None else max(1, ray_chunk)
    return [slice(s, min(s + step, n)) for s in range(0, max(n, 1), step)]


def intersect_rays(origins: torch.Tensor, directions: torch.Tensor, mesh,
                   t_min=T_EPS, t_max=float("inf"),
                   ray_chunk: Optional[int] = None) -> Hit:
    """Nearest hit of each ray against the whole mesh; the lowest triangle
    index wins a tie in t."""
    n = origins.shape[0]
    t_min = _broadcast_t(t_min, n, origins)
    t_max = _broadcast_t(t_max, n, origins)
    ts, tris = [], []
    for s in _chunks(n, ray_chunk):
        t, valid = _mt_tile(origins[s], directions[s], mesh.v0, mesh.e1,
                            mesh.e2, t_min[s], t_max[s])
        t_masked = torch.where(valid, t, float("inf"))
        tri = torch.argmin(t_masked, dim=-1)
        ts.append(torch.gather(t_masked, 1, tri[:, None])[:, 0])
        tris.append(tri)
    t_best = torch.cat(ts)
    ok = torch.isfinite(t_best)
    tri = torch.where(ok, torch.cat(tris), -1).to(torch.int32)
    return Hit(t=t_best, tri=tri, valid=ok)


def occluded(origins: torch.Tensor, directions: torch.Tensor, mesh,
             max_dist, t_min=T_EPS,
             ray_chunk: Optional[int] = None) -> torch.Tensor:
    """Any-hit test: True where a triangle blocks the segment before
    ``max_dist``."""
    n = origins.shape[0]
    t_min = _broadcast_t(t_min, n, origins)
    max_dist = _broadcast_t(max_dist, n, origins)
    out = []
    for s in _chunks(n, ray_chunk):
        _, valid = _mt_tile(origins[s], directions[s], mesh.v0, mesh.e1,
                            mesh.e2, t_min[s], max_dist[s])
        out.append(valid.any(dim=-1))
    return torch.cat(out)


def sphere_intersect(origins, directions, center, radius):
    """Nearest positive t of each ray against one sphere, +inf on a
    miss."""
    oc = origins - torch.as_tensor(center, dtype=origins.dtype,
                                   device=origins.device)
    b = 2.0 * lm.dot(directions, oc)
    c = lm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    t_near = torch.minimum(t1, t2)
    t_far = torch.maximum(t1, t2)
    t = torch.where(t_near > T_EPS, t_near, t_far)
    return torch.where((disc > 0.0) & (t > T_EPS), t, float("inf"))


def plane_intersect(origins, directions, point, normal):
    """t of each ray against one plane, +inf on a miss (parallel rays and
    planes behind the origin)."""
    kw = dict(dtype=origins.dtype, device=origins.device)
    point = torch.as_tensor(point, **kw)
    normal = torch.as_tensor(normal, **kw)
    denom = lm.dot(directions, normal)
    ok = torch.abs(denom) > 1e-6
    t = lm.dot(point - origins, normal) / torch.where(ok, denom, 1.0)
    return torch.where(ok & (t > T_EPS), t, float("inf"))


def aabb_intersect(origins, directions, box_min, box_max,
                   t_max=float("inf")):
    """Slab test of each ray against one box: ``(hit, t_near, t_far)``.
    Zero direction components are nudged to +-1e-20, so an origin on a slab
    plane gives no 0 * inf."""
    kw = dict(dtype=origins.dtype, device=origins.device)
    tiny = torch.where(directions < 0, -1e-20, 1e-20)
    inv_d = 1.0 / torch.where(torch.abs(directions) < 1e-20, tiny,
                              directions)
    t1 = (torch.as_tensor(box_min, **kw) - origins) * inv_d
    t2 = (torch.as_tensor(box_max, **kw) - origins) * inv_d
    t_near = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=0.0)
    t_far = torch.minimum(torch.maximum(t1, t2).amin(dim=-1),
                          torch.as_tensor(t_max, **kw))
    return t_near <= t_far, t_near, t_far
