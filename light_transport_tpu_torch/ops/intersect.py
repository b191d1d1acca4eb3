"""Brute-force ray-triangle intersection (masked Möller–Trumbore and the
watertight test) and the analytic sphere, plane and box tests.

The counterpart of ``light_transport_tpu.ops.intersect``'s ``intersect_rays``
and ``occluded``: every ray against every triangle in one ``(N, T)``
tile, the path scenes of 48 triangles or fewer take on either device.
Larger meshes go through the cluster-culled intersector
(``ops.intersect_kernel``).  ``intersect_rays_watertight`` and
``occluded_watertight`` are the same brute force through PBRT's
watertight test, which every query of a ``Scene.with_watertight()`` scene
takes.  ``sphere_intersect``, ``plane_intersect`` and ``aabb_intersect``
test a ray batch against one primitive each (``scene.analytic`` folds the
first two into every scene query).
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


# ---------------------------------------------------------------------------
# The watertight test (PBRT's "Watertight Ray-Triangle Intersection"), as
# JAX's ``_wt_tile``: translate to the ray origin, permute the axes so the
# ray's largest direction component is z, shear the ray onto +z, then three
# 2-D edge functions.  The per-ray permutation is a ``torch.gather``.  As
# in JAX, an exactly-zero edge function counts as an on-edge hit, with no
# float64 re-evaluation: adjacent triangles evaluate a shared edge from the
# same rounded products, negated, so a ray on the edge hits at least one.
# ---------------------------------------------------------------------------

_F32_EPS_HALF = float(torch.finfo(torch.float32).eps) / 2.0


def _gamma(n: int) -> float:
    """PBRT's conservative bound on the error of ``n`` float operations."""
    return n * _F32_EPS_HALF / (1.0 - n * _F32_EPS_HALF)


def _wt_tile(o, d, v0, v1, v2, t_min, t_max):
    """The watertight test on an (N, T) tile: ``(t, b0, b1, b2, valid)``."""
    kz = torch.argmax(torch.abs(d), dim=-1)  # (N,)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(vec, k):
        # the component of (N, 3) or (N, T, 3) ``vec`` along each ray's axis
        if vec.dim() == 2:
            return torch.gather(vec, 1, k[:, None])[:, 0]
        idx = k[:, None, None].expand(vec.shape[0], vec.shape[1], 1)
        return torch.gather(vec, 2, idx)[..., 0]

    dx, dy, dz = pick(d, kx), pick(d, ky), pick(d, kz)
    sx = -dx / dz
    sy = -dy / dz
    sz = 1.0 / dz

    def xyz(p):
        q = p[None, :, :] - o[:, None, :]  # (N, T, 3)
        px, py, pz = pick(q, kx), pick(q, ky), pick(q, kz)
        return px + sx[:, None] * pz, py + sy[:, None] * pz, pz

    x0, y0, z0 = xyz(v0)
    x1, y1, z1 = xyz(v1)
    x2, y2, z2 = xyz(v2)

    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1

    same_sign = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
                  & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ok = same_sign & (det != 0.0)

    z0s, z1s, z2s = sz[:, None] * z0, sz[:, None] * z1, sz[:, None] * z2
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    # the distance window on the scaled t, by the sign of det
    lo = t_min[:, None] * det
    hi = t_max[:, None] * det
    ok = ok & torch.where(det < 0, (t_scaled <= lo) & (t_scaled > hi),
                          (t_scaled >= lo) & (t_scaled < hi))

    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    t = t_scaled * inv_det
    b0, b1, b2 = e0 * inv_det, e1 * inv_det, e2 * inv_det

    # reject hits closer than the bound on t's rounding error
    max_zt = torch.maximum(torch.maximum(torch.abs(z0s), torch.abs(z1s)),
                           torch.abs(z2s))
    max_xt = torch.maximum(torch.maximum(torch.abs(x0), torch.abs(x1)),
                           torch.abs(x2))
    max_yt = torch.maximum(torch.maximum(torch.abs(y0), torch.abs(y1)),
                           torch.abs(y2))
    delta_z = _gamma(3) * max_zt
    delta_x = _gamma(5) * (max_xt + max_zt)
    delta_y = _gamma(5) * (max_yt + max_zt)
    delta_e = 2.0 * (_gamma(2) * max_xt * max_yt
                     + delta_y * max_xt + delta_x * max_yt)
    max_e = torch.maximum(torch.maximum(torch.abs(e0), torch.abs(e1)),
                          torch.abs(e2))
    delta_t = 3.0 * (_gamma(3) * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * torch.abs(inv_det)
    ok = ok & (t > delta_t)
    return t, b0, b1, b2, ok


def _vertices(mesh):
    return mesh.v0, mesh.v0 + mesh.e1, mesh.v0 + mesh.e2


def intersect_rays_watertight(origins: torch.Tensor, directions: torch.Tensor,
                              mesh, t_min=T_EPS, t_max=float("inf"),
                              ray_chunk: Optional[int] = None) -> Hit:
    """Nearest hit through the watertight test: a ray through a shared
    edge or vertex of adjacent triangles hits at least one of them, where
    Möller–Trumbore can round it into a crack.  The lowest triangle index
    wins a tie in t."""
    n = origins.shape[0]
    t_min = _broadcast_t(t_min, n, origins)
    t_max = _broadcast_t(t_max, n, origins)
    v0, v1, v2 = _vertices(mesh)
    ts, tris = [], []
    for s in _chunks(n, ray_chunk):
        t, _, _, _, valid = _wt_tile(origins[s], directions[s], v0, v1, v2,
                                     t_min[s], t_max[s])
        t_masked = torch.where(valid, t, float("inf"))
        tri = torch.argmin(t_masked, dim=-1)
        ts.append(torch.gather(t_masked, 1, tri[:, None])[:, 0])
        tris.append(tri)
    t_best = torch.cat(ts)
    ok = torch.isfinite(t_best)
    tri = torch.where(ok, torch.cat(tris), -1).to(torch.int32)
    return Hit(t=t_best, tri=tri, valid=ok)


def occluded_watertight(origins: torch.Tensor, directions: torch.Tensor,
                        mesh, max_dist, t_min=T_EPS,
                        ray_chunk: Optional[int] = None) -> torch.Tensor:
    """Any-hit test through the watertight test: a shadow ray grazing a
    shared edge cannot slip through a crack."""
    n = origins.shape[0]
    t_min = _broadcast_t(t_min, n, origins)
    max_dist = _broadcast_t(max_dist, n, origins)
    v0, v1, v2 = _vertices(mesh)
    out = []
    for s in _chunks(n, ray_chunk):
        valid = _wt_tile(origins[s], directions[s], v0, v1, v2, t_min[s],
                         max_dist[s])[4]
        out.append(valid.any(dim=-1))
    return torch.cat(out)
