"""Brute-force Möller–Trumbore: every ray against every triangle, in
blocks of rays and triangles, with no tree, no cull and no sort.  The
nearest hit keeps the lowest triangle index on a tie."""

from __future__ import annotations

import torch

DET_EPS = 1e-12  # |det| below this: the ray runs parallel to the triangle
T_MIN = 1e-5  # the nearest distance a hit may have
PAIRS_PER_BLOCK = 1 << 24  # rays x triangles tested in one block
TRIS_PER_BLOCK = 1 << 18


class Triangles:
    """The triangles' first vertex and two edges, each component a (T,)
    tensor."""

    def __init__(self, v0, e1, e2):
        self.comp = [x[:, k].contiguous() for x in (v0, e1, e2)
                     for k in range(3)]
        self.num = v0.shape[0]

    def block(self, s: slice):
        return [c[s][None, :] for c in self.comp]


def _test(o, d, tri, t_max):
    """``(t, valid)`` of rays ``o``, ``d`` (R, 3) against a block of
    triangles, each (R, Tb)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > T_MIN) & (t < t_max[:, None]))
    return t, valid


def _blocks(n_rays: int, n_tris: int):
    tri_step = max(1, min(n_tris, TRIS_PER_BLOCK))
    ray_step = max(1, PAIRS_PER_BLOCK // tri_step)
    return ray_step, tri_step


def nearest(o, d, tris: Triangles):
    """``(t, tri)`` of each ray's nearest hit: ``t`` +inf and ``tri`` -1
    where it has none."""
    n = o.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=o.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    ray_step, tri_step = _blocks(n, tris.num)
    t_max = torch.full((n,), float("inf"), dtype=o.dtype, device=o.device)
    for r in range(0, n, ray_step):
        rs = slice(r, min(r + ray_step, n))
        bt, bi = best_t[rs], best_i[rs]
        for s in range(0, tris.num, tri_step):
            ts = slice(s, min(s + tri_step, tris.num))
            t, valid = _test(o[rs], d[rs], tris.block(ts), t_max[rs])
            m, arg = torch.where(valid, t, float("inf")).min(dim=1)
            better = m < bt
            bt = torch.where(better, m, bt)
            bi = torch.where(better, arg + s, bi)
        best_t[rs], best_i[rs] = bt, bi
    return best_t, best_i


def occluded(o, d, max_dist, tris: Triangles):
    """True where a triangle lies on the ray between ``T_MIN`` and
    ``max_dist``."""
    n = o.shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=o.device)
    ray_step, tri_step = _blocks(n, tris.num)
    for r in range(0, n, ray_step):
        rs = slice(r, min(r + ray_step, n))
        for s in range(0, tris.num, tri_step):
            ts = slice(s, min(s + tri_step, tris.num))
            _, valid = _test(o[rs], d[rs], tris.block(ts), max_dist[rs])
            out[rs] |= valid.any(dim=1)
    return out
